"""Host stripes through the port's codec.

The blob plane keeps its stripes in host memory as numpy arrays, as the
reference does: shards arrive from disks and sockets and go back to
them. ``engine()`` and ``encoder()`` give the blob modules the
reference's codec surfaces (an admitted engine's ``matrix_apply`` and
``encode_parity``; an encoder's ``encode_async``, ``reconstruct`` and
``reconstruct_data``) over such arrays, for every engine name:

- ``auto`` and the host engines (``numpy``, ``cpp``, ``numpy-xor``,
  ``cpp-xor``): the port's admitted engine and encoders take numpy as it
  is. ``auto`` sends each coalesced step to a leg by its size, and its
  ``cuda`` leg copies in and out on its own (``codec/batcher.py``).
- ``cuda``: the port's encoders and admitted engine take tensors on the
  card only (their in-place contract), so each call stages its whole
  (B, rows, S) stack through ``codec/hostio.py``: one copy to the card,
  kernel A there, one copy back of the rows the kernel wrote. This is
  ``hostio.staged``, the same path ``auto``'s ``cuda`` leg takes. Nothing
  falls back to a host leg: an error on the card raises to the caller.

Both resolve ``device`` first: None is the current CUDA device (and
raises without one), ``"cpu"`` the plain PyTorch versions.
"""

from __future__ import annotations

import numpy as np

from .. import device as devlib
from ..codec import codemode as cm
from ..codec import engine as engines
from ..codec import hostio
from ..codec.batcher import AdmittedEngine, admit
from ..codec.encoder import CodecConfig, Encoder, PendingEncode, new_encoder


def engine(device=None, name: str | None = "auto"):
    """An admitted engine over host (..., C, S) stacks: numpy in, numpy out.
    ``name`` None is ``engines.default_name()``, as for ``encoder``."""
    eng = admit(devlib.resolve(device), engine=name or engines.default_name())
    return eng if eng.host else StagedEngine(eng)


def encoder(mode: cm.CodeMode | int, device=None, name: str | None = "auto"):
    """The codemode's encoder over host stripes, writing rows in place."""
    enc = new_encoder(CodecConfig(mode=cm.CodeMode(int(mode)), engine=name,
                                  device=devlib.resolve(device)))
    return enc if enc.host else StagedEncoder(enc)


def _host_stack(x) -> np.ndarray:
    if not (isinstance(x, np.ndarray) and x.dtype == np.uint8):
        raise ValueError(f"a host stack must be a uint8 array, got "
                         f"{type(x).__name__} {getattr(x, 'dtype', '')}")
    return x


class StagedEngine:
    """The admitted ``cuda`` engine over host stacks: each call is one
    copy of its stack to the card, one step of kernel A (coalesced with
    other callers of the geometry) and one copy of the result back."""

    def __init__(self, eng: AdmittedEngine):
        self._eng = eng
        self.device = eng.device

    def _staged(self, method: str, x, fn) -> np.ndarray:
        out = hostio.staged(_host_stack(x), self.device, fn)
        engines.last_dispatch.update(method=method, requested="cuda", served="cuda")
        return out

    def matrix_apply(self, coeff: np.ndarray, shards: np.ndarray) -> np.ndarray:
        return self._staged("matrix_apply", shards, lambda d: self._eng.matrix_apply(coeff, d))

    def encode_parity(self, data: np.ndarray, n_parity: int) -> np.ndarray:
        return self._staged("encode_parity", data, lambda d: self._eng.encode_parity(d, n_parity))


class _StagedPending:
    """A staged encode in flight: ``wait()`` lands the parity rows on the
    card, copies them into the caller's host stripe and returns it."""

    def __init__(self, pending: PendingEncode, stripes: np.ndarray, copy_back):
        self._pending = pending
        self.stripes = stripes
        self._copy_back = copy_back  # runs once

    @property
    def resolved(self) -> bool:
        return self._pending.resolved

    def wait(self, timeout: float = 120.0) -> np.ndarray:
        self._pending.wait(timeout)
        if self._copy_back is not None:
            copy_back, self._copy_back = self._copy_back, None
            copy_back()
        return self.stripes


class StagedEncoder:
    """A ``cuda`` encoder over host stripes (the reference's Encoder
    interface on numpy): the (…, total, S) stripe goes to the card in
    one copy, the rows the kernel writes come back in one copy."""

    def __init__(self, enc: Encoder):
        self._enc = enc
        self.t = enc.t
        self.device = enc.device

    def shard_size(self, data_len: int) -> int:
        return self._enc.shard_size(data_len)

    def encode_async(self, stripes: np.ndarray) -> _StagedPending:
        dev, n = hostio.to_device(_host_stack(stripes), stripes.shape, self.device), self.t.n
        return _StagedPending(self._enc.encode_async(dev), stripes, lambda: hostio.to_host(
            dev[..., n:, :], out=stripes[..., n:, :]))

    def encode(self, stripes: np.ndarray) -> np.ndarray:
        return self.encode_async(stripes).wait()

    def reconstruct(self, stripe: np.ndarray, bad_idx: list[int]) -> np.ndarray:
        return self._rebuild(self._enc.reconstruct, stripe, bad_idx)

    def reconstruct_data(self, stripe: np.ndarray, bad_idx: list[int]) -> np.ndarray:
        return self._rebuild(self._enc.reconstruct_data, stripe, bad_idx)

    def _rebuild(self, fn, stripe: np.ndarray, bad_idx: list[int]) -> np.ndarray:
        rows = sorted(set(bad_idx))  # every row the solve may write

        def solve(dev):
            fn(dev, bad_idx)
            return dev[..., rows, :]

        stripe[..., rows, :] = hostio.staged(_host_stack(stripe), self.device, solve)
        return stripe
