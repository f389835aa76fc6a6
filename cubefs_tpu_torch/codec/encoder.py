"""Encoder: the reference codec interface over stripe tensors.

Semantics mirror blobstore/common/ec/encoder.go (Encode/Verify/
Reconstruct/ReconstructData/Split/Join/GetDataShards/GetParityShards/
GetLocalShards/GetShardsInIdc) and lrcencoder.go, as the JAX package's
``cubefs_tpu/codec/encoder.py`` does, for plain N+M Reed-Solomon, the
two-level LRC modes and the product-matrix MSR modes. A stripe is ONE
(total, S) uint8 array (or a (B, total, S) batch); encode and
reconstruct fill rows in place. Where it lives follows the engine
(``CodecConfig.engine``, the reference's names):

- ``cuda`` (the default): a tensor on the encoder's device; the math is
  kernel A there (its plain version with ``device="cpu"``).
- any other engine (``numpy``, ``cpp``, ``numpy-xor``, ``cpp-xor``,
  ``auto``): host memory, a numpy array or a CPU tensor, as the blob
  plane passes them. Methods return the caller's own object; ``split``
  makes a numpy stripe. ``device`` is the card of ``auto``'s ``cuda``
  leg.

Every encoder reaches shard math through the admission layer
(``codec/batcher.py``), so concurrent callers of one geometry and engine
coalesce into one step.
"""

from __future__ import annotations

import functools
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import rs_kernel
from . import codemode as cm
from . import engine as engines
from .batcher import AdmittedEngine, CodecFuture, admit


class PendingEncode:
    """An encode admitted to the codec batcher while its caller still
    has other work in hand. ``wait()`` lands the parity rows in the
    caller's stripe tensor (the tensor ``encode`` would return) and
    raises the submission's error, if any. ``resolved`` says whether
    the device step was already queued, without blocking."""

    __slots__ = ("shards", "_fill", "_fut")

    def __init__(self, shards: torch.Tensor, fill=None, fut: CodecFuture | None = None):
        self.shards = shards
        self._fill = fill  # runs at most once; None = already complete
        self._fut = fut

    @property
    def resolved(self) -> bool:
        return self._fill is None or (self._fut is not None and self._fut.done)

    def wait(self, timeout: float = 120.0) -> torch.Tensor:
        if self._fill is not None:
            fill, self._fill = self._fill, None
            fill(timeout)
        return self.shards


class ECError(Exception):
    pass


class ShortDataError(ECError):
    pass


class VerifyError(ECError):
    pass


@dataclass
class CodecConfig:
    """ec.Config analog (blobstore/common/ec/encoder.go). ``engine`` None
    means ``CUBEFS_TPU_EC_ENGINE`` or ``cuda``. ``device`` None means the
    current CUDA device; ``"cpu"`` runs the plain PyTorch path."""

    mode: cm.CodeMode
    enable_verify: bool = False
    engine: str | None = None
    device: str | torch.device | None = None


def new_encoder(cfg: CodecConfig) -> "Encoder":
    t = cm.tactic(cfg.mode)
    eng = admit(cfg.device, engine=cfg.engine or engines.default_name())
    if t.is_msr():
        return MsrEncoder(cfg, t, eng)
    if t.l != 0:
        return LrcEncoder(cfg, t, eng)
    return Encoder(cfg, t, eng)


class Encoder:
    """Plain N+M Reed-Solomon codec over stripes."""

    def __init__(self, cfg: CodecConfig, t: cm.Tactic, engine: AdmittedEngine):
        self.cfg = cfg
        self.t = t
        self.engine = engine

    @property
    def device(self) -> torch.device | None:
        return self.engine.device

    @property
    def host(self) -> bool:
        """Whether stripes live in host memory (every engine but ``cuda``)."""
        return self.engine.host

    # -- shape helpers ---------------------------------------------------
    def _check(self, shards, total: int | None = None, write: bool = True) -> torch.Tensor:
        """The stripe as a tensor (a host stripe's numpy array as a CPU
        tensor over the same memory, so rows written land in it)."""
        total = total if total is not None else self.t.total
        if self.host:
            shards = self._host_tensor(shards, write)
        elif not isinstance(shards, torch.Tensor):
            # a silent copy would break the in-place contract of
            # encode/reconstruct; the caller moves data to the device
            raise ECError(f"stripe must be a torch.Tensor, got {type(shards).__name__}")
        if shards.dtype != torch.uint8:
            raise ECError(f"stripe dtype must be uint8, got {shards.dtype}")
        if not self.host and shards.device != self.device:
            raise ECError(f"stripe is on {shards.device}, the encoder on {self.device}")
        if shards.dim() < 2 or shards.shape[-2] != total:
            raise ECError(
                f"stripe has shape {tuple(shards.shape)}, want {total} shards for {self.t}")
        return shards

    def _host_tensor(self, shards, write: bool) -> torch.Tensor:
        if isinstance(shards, np.ndarray):
            if shards.dtype != np.uint8:
                raise ECError(f"stripe dtype must be uint8, got {shards.dtype}")
            if write and not shards.flags.writeable:
                raise ECError("stripe array is read-only")
            with warnings.catch_warnings():  # a read-only array is only read
                warnings.simplefilter("ignore", UserWarning)
                return torch.from_numpy(shards)
        if isinstance(shards, torch.Tensor):
            if shards.device.type != "cpu":
                raise ECError(f"stripe is on {shards.device}; the {self.engine.engine} "
                              "engine's stripes live in host memory")
            return shards
        raise ECError(f"stripe must be a numpy array or a CPU tensor, got "
                      f"{type(shards).__name__}")

    def shard_size(self, data_len: int) -> int:
        """Per-shard size for a payload: max(ceil(len/N), min_shard_size)."""
        return max(-(-data_len // self.t.n), self.t.min_shard_size)

    # -- reference Encoder interface ------------------------------------
    def encode(self, shards):
        """Fill parity rows from data rows; returns the same stripe."""
        st = self._check(shards)
        n, m = self.t.n, self.t.m
        if m:  # the engine writes the parity rows in place
            self.engine.encode_parity(st[..., :n, :], m, out=st[..., n : n + m, :])
        if self.cfg.enable_verify and not self.verify(st):
            raise VerifyError("parity verify failed after encode")
        return shards

    def encode_async(self, shards) -> PendingEncode:
        """Admit the parity encode and return at once; ``wait()`` fills
        the parity rows in place. The step runs, coalesced with
        concurrent submissions, while the caller does other work; with
        the batcher's door closed the encode runs inline."""
        st = self._check(shards)
        n, m = self.t.n, self.t.m
        if not m:
            return PendingEncode(shards)
        return self._pending(shards, st, lambda b, flat: b.submit_encode_async(
            self.device, flat[:, :n], m, out=flat[:, n:n + m], engine=self.engine.engine))

    def _pending(self, shards, st: torch.Tensor, submit) -> PendingEncode:
        """``submit(batcher, stripes)`` admits the encode of the
        (B, total, S) view of ``st`` (the stripe ``shards`` as a tensor),
        writing the parity rows in place; ``wait()`` collects it."""
        batcher = self.engine.batcher
        if not batcher.enabled:
            return PendingEncode(self.encode(shards))
        fut = submit(batcher, st.view(-1, *st.shape[-2:]))

        def fill(timeout: float) -> None:
            fut.result(timeout)
            if self.cfg.enable_verify and not self.verify(st):
                raise VerifyError("parity verify failed after encode")

        return PendingEncode(shards, fill, fut)

    def verify(self, shards) -> bool:
        st = self._check(shards, write=False)
        n, m = self.t.n, self.t.m
        if not m:
            return True
        parity = self.engine.encode_parity(st[..., :n, :], m)
        return bool(torch.equal(parity, st[..., n : n + m, :]))

    def reconstruct(self, shards, bad_idx: list[int]):
        return self._reconstruct(shards, bad_idx, wanted=sorted(set(bad_idx)))

    def reconstruct_data(self, shards, bad_idx: list[int]):
        wanted = sorted({i for i in bad_idx if i < self.t.n})
        return self._reconstruct(shards, bad_idx, wanted=wanted)

    def _reconstruct(self, shards, bad_idx: list[int], wanted: list[int]):
        st = self._check(shards, total=self.t.n + self.t.m)
        if not wanted:
            return shards
        n, total = self.t.n, self.t.n + self.t.m
        bad = set(bad_idx)
        present = [i for i in range(total) if i not in bad]
        if len(present) < n:
            raise ECError(f"unrecoverable: only {len(present)} of {n} shards")
        rows = rs_kernel.reconstruct_rows(n, total, present, wanted)
        st[..., wanted, :] = self.engine.matrix_apply(rows, st[..., present[:n], :])
        return shards

    def split(self, data):
        """Lay a payload (bytes, numpy or tensor) into a zero-padded
        (total, S) stripe: data rows filled, parity rows zero until
        encode. A tensor on the encoder's device for ``cuda``, a numpy
        array for the host engines."""
        if self.host:
            buf = (np.frombuffer(data, dtype=np.uint8)
                   if isinstance(data, (bytes, bytearray, memoryview))
                   else np.asarray(_host_bytes(data), dtype=np.uint8).ravel())
            if buf.size == 0:
                raise ShortDataError("empty payload")
            stripe = np.zeros((self.t.total, self.shard_size(buf.size)), dtype=np.uint8)
            stripe.reshape(-1)[: buf.size] = buf
            return stripe
        if isinstance(data, (bytes, bytearray, memoryview)):
            buf = torch.from_numpy(np.frombuffer(data, dtype=np.uint8).copy())
        elif isinstance(data, torch.Tensor):
            buf = data.reshape(-1).to(torch.uint8)
        else:
            buf = torch.from_numpy(np.asarray(data, dtype=np.uint8).ravel())
        if buf.numel() == 0:
            raise ShortDataError("empty payload")
        s = self.shard_size(buf.numel())
        stripe = torch.zeros((self.t.total, s), dtype=torch.uint8, device=self.device)
        stripe.view(-1)[: buf.numel()] = buf.to(self.device)
        return stripe

    def join(self, shards, out_size: int) -> bytes:
        shards = self._check(shards, write=False)
        if shards.dim() != 2:
            raise ECError("join takes a single (total, S) stripe, not a batch")
        flat = shards[: self.t.n].reshape(-1)
        if out_size > flat.numel():
            raise ECError(f"out_size {out_size} exceeds data capacity {flat.numel()}")
        return flat[:out_size].cpu().numpy().tobytes()

    def get_data_shards(self, shards: torch.Tensor) -> torch.Tensor:
        return shards[..., : self.t.n, :]

    def get_parity_shards(self, shards: torch.Tensor) -> torch.Tensor:
        return shards[..., self.t.n : self.t.n + self.t.m, :]

    def get_local_shards(self, shards: torch.Tensor) -> torch.Tensor:
        return shards[..., self.t.total : self.t.total, :]  # empty

    def get_shards_in_idc(self, shards: torch.Tensor, az: int) -> torch.Tensor:
        n, m, azc = self.t.n, self.t.m, self.t.az_count
        ln, lm = n // azc, m // azc
        idx = list(range(az * ln, (az + 1) * ln)) + list(
            range(n + lm * az, n + lm * (az + 1))
        )
        return shards[..., idx, :]


def _rows(shards) -> int | None:
    """The shard count of a stripe (tensor or array), None for anything else."""
    ok = isinstance(shards, (torch.Tensor, np.ndarray)) and shards.ndim >= 2
    return shards.shape[-2] if ok else None


def _host_bytes(data):
    """A payload tensor's bytes on the host, anything else as it is."""
    return data.reshape(-1).cpu().numpy() if isinstance(data, torch.Tensor) else data


class MsrEncoder(Encoder):
    """Product-matrix MSR codec: the Encoder interface, with parity and
    reconstruction over the sub-shard space (each shard is alpha rows of
    beta bytes), so a single-shard repair pulls beta-sized helper
    symbols instead of full shards (``ops/msr.py``). Shard sizes are
    rounded up to a multiple of alpha."""

    @property
    def alpha(self) -> int:
        return self.t.alpha

    def shard_size(self, data_len: int) -> int:
        per = super().shard_size(data_len)
        return -(-per // self.alpha) * self.alpha

    def _parity_rows(self) -> np.ndarray:
        t = self.t
        return rs_kernel.msr_encode_rows(t.n, t.n + t.m, t.d)

    def encode(self, shards):
        st = self._check(shards)
        n, a = self.t.n, self.alpha
        # sub-shard views of the stripe: the engine writes the parity in place
        self.engine.matrix_apply(self._parity_rows(), rs_kernel.msr_subshards(st[..., :n, :], a),
                                 out=rs_kernel.msr_subshards(st[..., n:, :], a))
        if self.cfg.enable_verify and not self.verify(st):
            raise VerifyError("parity verify failed after encode")
        return shards

    def encode_async(self, shards) -> PendingEncode:
        st = self._check(shards)
        n, a = self.t.n, self.alpha
        return self._pending(shards, st, lambda b, flat: b.submit_apply_async(
            self.device, self._parity_rows(), rs_kernel.msr_subshards(flat[:, :n], a),
            out=rs_kernel.msr_subshards(flat[:, n:], a), engine=self.engine.engine))

    def verify(self, shards) -> bool:
        st = self._check(shards, write=False)
        n, a = self.t.n, self.alpha
        parity = self.engine.matrix_apply(self._parity_rows(),
                                          rs_kernel.msr_subshards(st[..., :n, :], a))
        return bool(torch.equal(rs_kernel.msr_join_subshards(parity, a), st[..., n:, :]))

    def _reconstruct(self, shards, bad_idx: list[int], wanted: list[int]):
        st = self._check(shards, total=self.t.total)
        if not wanted:
            return shards
        t, a = self.t, self.alpha
        n, total = t.n, t.total
        bad = set(bad_idx)
        present = [i for i in range(total) if i not in bad]
        if len(present) < n:
            raise ECError(f"unrecoverable: only {len(present)} of {n} shards")
        rows = rs_kernel.msr_reconstruct_rows(n, total, t.d, tuple(present[:n]), tuple(wanted))
        sub = rs_kernel.msr_subshards(st[..., present[:n], :], a)
        st[..., wanted, :] = rs_kernel.msr_join_subshards(self.engine.matrix_apply(rows, sub), a)
        return shards


class LrcEncoder(Encoder):
    """Two-level LRC codec: global RS(N+M) plus per-AZ local parity
    RS((N+M)/az, L/az). Local stripes allow intra-AZ reconstruction
    without crossing AZs (lrcencoder.go semantics).

    Local parity is linear in the data rows, so encode is ONE apply of
    the (M+L, N) matrix whose row i-N yields shard i (``_encode_rows``),
    written through one view of shards N..N+M+L-1. The reference makes
    1 + az_count parity calls; the bytes are the same."""

    @property
    def _local_nm(self) -> tuple[int, int]:
        t = self.t
        return (t.n + t.m) // t.az_count, t.l // t.az_count

    @functools.cached_property
    def _encode_rows(self) -> np.ndarray:
        t = self.t
        stripes, ln, _ = t.all_local_stripes()
        rows = rs_kernel.lrc_reconstruct_rows(t.n, t.n + t.m, stripes, ln, list(range(t.n)),
                                              list(range(t.n, t.total)))
        rows.setflags(write=False)
        return rows

    def encode(self, shards):
        st = self._check(shards)
        n = self.t.n
        self.engine.matrix_apply(self._encode_rows, st[..., :n, :], out=st[..., n:, :])
        if self.cfg.enable_verify and not self.verify(st):
            raise VerifyError("parity verify failed after encode")
        return shards

    def encode_async(self, shards) -> PendingEncode:
        st = self._check(shards)
        n = self.t.n
        return self._pending(shards, st, lambda b, flat: b.submit_apply_async(
            self.device, self._encode_rows, flat[:, :n], out=flat[:, n:],
            engine=self.engine.engine))

    def verify(self, shards) -> bool:
        ln, lm = self._local_nm
        if _rows(shards) == ln + lm:  # a bare local stripe
            st = self._check(shards, total=ln + lm, write=False)
            parity = self.engine.encode_parity(st[..., :ln, :], lm)
            return bool(torch.equal(parity, st[..., ln:, :]))
        st = self._check(shards, write=False)
        # the global parity matches iff the stored stripe members are the
        # data's, so the local parity computed from the data is the local
        # parity of the stored members: one apply checks both levels
        n = self.t.n
        parity = self.engine.matrix_apply(self._encode_rows, st[..., :n, :])
        return bool(torch.equal(parity, st[..., n:, :]))

    def reconstruct(self, shards, bad_idx: list[int]):
        t = self.t
        ln, lm = self._local_nm
        if _rows(shards) == ln + lm:
            # intra-AZ repair on a bare local stripe (no cross-AZ traffic)
            st = self._check(shards, total=ln + lm)
            bad = sorted(set(bad_idx))
            if not bad:
                return shards
            present = [i for i in range(ln + lm) if i not in bad]
            if len(present) < ln:
                raise ECError(f"unrecoverable local stripe: only {len(present)} of {ln} shards")
            rows = rs_kernel.reconstruct_rows(ln, ln + lm, present, bad)
            st[..., bad, :] = self.engine.matrix_apply(rows, st[..., present[:ln], :])
            return shards
        st = self._check(shards)
        global_bad = sorted({i for i in bad_idx if i < t.n + t.m})
        if global_bad:
            self._reconstruct(st[..., : t.n + t.m, :], global_bad, wanted=global_bad)
        # local parities are recomputed from their (now complete) stripes
        local_bad_azs = sorted(
            {(i - t.n - t.m) * t.az_count // t.l for i in bad_idx if i >= t.n + t.m})
        for az in local_bad_azs:
            stripe_idx, _, _ = t.local_stripe_in_az(az)
            first = stripe_idx[ln]  # an AZ's local parity rows are contiguous
            self.engine.encode_parity(st[..., stripe_idx[:ln], :], lm,
                                      out=st[..., first:first + lm, :])
        return shards

    def reconstruct_data(self, shards, bad_idx: list[int]):
        t = self.t
        # data recovery needs only the global stripe: accept the full
        # (N+M+L) layout or just the (N+M) rows (degraded GET path)
        st = self._check(shards, total=t.n + t.m if _rows(shards) == t.n + t.m else None)
        global_bad = [i for i in bad_idx if i < t.n + t.m]
        wanted = sorted({i for i in global_bad if i < t.n})
        if wanted:
            self._reconstruct(st[..., : t.n + t.m, :], global_bad, wanted=wanted)
        return shards

    def get_local_shards(self, shards: torch.Tensor) -> torch.Tensor:
        return shards[..., self.t.n + self.t.m :, :]

    def get_shards_in_idc(self, shards: torch.Tensor, az: int) -> torch.Tensor:
        stripe_idx, _, _ = self.t.local_stripe_in_az(az)
        return shards[..., stripe_idx, :]
