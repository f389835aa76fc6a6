"""Encoder: the reference codec interface over stripe tensors.

Semantics mirror blobstore/common/ec/encoder.go (Encode/Verify/
Reconstruct/ReconstructData/Split/Join/GetDataShards/GetParityShards/
GetLocalShards/GetShardsInIdc) and lrcencoder.go, as the JAX package's
``cubefs_tpu/codec/encoder.py`` does, for plain N+M Reed-Solomon, the
two-level LRC modes and the product-matrix MSR modes. A stripe is ONE
(total, S) uint8 tensor on the encoder's device (or a (B, total, S)
batch); encode and reconstruct fill rows in place. Every encoder
reaches device math through the admission layer (``codec/batcher.py``),
so concurrent callers of one geometry coalesce into one device step.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import rs_kernel
from . import codemode as cm
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
    """ec.Config analog (blobstore/common/ec/encoder.go). ``device`` None
    means the current CUDA device; ``"cpu"`` runs the plain PyTorch path."""

    mode: cm.CodeMode
    enable_verify: bool = False
    device: str | torch.device | None = None


def new_encoder(cfg: CodecConfig) -> "Encoder":
    t = cm.tactic(cfg.mode)
    eng = admit(cfg.device)
    if t.is_msr():
        return MsrEncoder(cfg, t, eng)
    if t.l != 0:
        return LrcEncoder(cfg, t, eng)
    return Encoder(cfg, t, eng)


class Encoder:
    """Plain N+M Reed-Solomon codec over stripe tensors."""

    def __init__(self, cfg: CodecConfig, t: cm.Tactic, engine: AdmittedEngine):
        self.cfg = cfg
        self.t = t
        self.engine = engine

    @property
    def device(self) -> torch.device:
        return self.engine.device

    # -- shape helpers ---------------------------------------------------
    def _check(self, shards, total: int | None = None) -> torch.Tensor:
        total = total if total is not None else self.t.total
        if not isinstance(shards, torch.Tensor):
            # a silent copy would break the in-place contract of
            # encode/reconstruct; the caller moves data to the device
            raise ECError(f"stripe must be a torch.Tensor, got {type(shards).__name__}")
        if shards.dtype != torch.uint8:
            raise ECError(f"stripe dtype must be uint8, got {shards.dtype}")
        if shards.device != self.device:
            raise ECError(f"stripe is on {shards.device}, the encoder on {self.device}")
        if shards.dim() < 2 or shards.shape[-2] != total:
            raise ECError(
                f"stripe has shape {tuple(shards.shape)}, want {total} shards for {self.t}")
        return shards

    def shard_size(self, data_len: int) -> int:
        """Per-shard size for a payload: max(ceil(len/N), min_shard_size)."""
        return max(-(-data_len // self.t.n), self.t.min_shard_size)

    # -- reference Encoder interface ------------------------------------
    def encode(self, shards: torch.Tensor) -> torch.Tensor:
        """Fill parity rows from data rows; returns the same tensor."""
        shards = self._check(shards)
        n, m = self.t.n, self.t.m
        if m:  # the kernel writes the parity rows in place
            self.engine.encode_parity(shards[..., :n, :], m, out=shards[..., n : n + m, :])
        if self.cfg.enable_verify and not self.verify(shards):
            raise VerifyError("parity verify failed after encode")
        return shards

    def encode_async(self, shards: torch.Tensor) -> PendingEncode:
        """Admit the parity encode and return at once; ``wait()`` fills
        the parity rows in place. The device step runs, coalesced with
        concurrent submissions, while the caller does other work; with
        the batcher's door closed the encode runs inline."""
        shards = self._check(shards)
        n, m = self.t.n, self.t.m
        if not m:
            return PendingEncode(shards)
        return self._pending(shards, lambda b, flat: b.submit_encode_async(
            self.device, flat[:, :n], m, out=flat[:, n:n + m]))

    def _pending(self, shards: torch.Tensor, submit) -> PendingEncode:
        """``submit(batcher, stripes)`` admits the encode of the
        (B, total, S) view of ``shards``, writing the parity rows in
        place; ``wait()`` collects it."""
        batcher = self.engine.batcher
        if not batcher.enabled:
            return PendingEncode(self.encode(shards))
        fut = submit(batcher, shards.view(-1, *shards.shape[-2:]))

        def fill(timeout: float) -> None:
            fut.result(timeout)
            if self.cfg.enable_verify and not self.verify(shards):
                raise VerifyError("parity verify failed after encode")

        return PendingEncode(shards, fill, fut)

    def verify(self, shards: torch.Tensor) -> bool:
        shards = self._check(shards)
        n, m = self.t.n, self.t.m
        if not m:
            return True
        parity = self.engine.encode_parity(shards[..., :n, :], m)
        return bool(torch.equal(parity, shards[..., n : n + m, :]))

    def reconstruct(self, shards: torch.Tensor, bad_idx: list[int]) -> torch.Tensor:
        return self._reconstruct(shards, bad_idx, wanted=sorted(set(bad_idx)))

    def reconstruct_data(self, shards: torch.Tensor, bad_idx: list[int]) -> torch.Tensor:
        wanted = sorted({i for i in bad_idx if i < self.t.n})
        return self._reconstruct(shards, bad_idx, wanted=wanted)

    def _reconstruct(
        self, shards: torch.Tensor, bad_idx: list[int], wanted: list[int]
    ) -> torch.Tensor:
        shards = self._check(shards, total=self.t.n + self.t.m)
        if not wanted:
            return shards
        n, total = self.t.n, self.t.n + self.t.m
        bad = set(bad_idx)
        present = [i for i in range(total) if i not in bad]
        if len(present) < n:
            raise ECError(f"unrecoverable: only {len(present)} of {n} shards")
        rows = rs_kernel.reconstruct_rows(n, total, present, wanted)
        shards[..., wanted, :] = self.engine.matrix_apply(rows, shards[..., present[:n], :])
        return shards

    def split(self, data) -> torch.Tensor:
        """Lay a payload (bytes, numpy or tensor) into a zero-padded
        (total, S) stripe on the encoder's device: data rows filled,
        parity rows zero until encode."""
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

    def join(self, shards: torch.Tensor, out_size: int) -> bytes:
        shards = self._check(shards)
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
    """The shard count of a stripe tensor, None for anything else."""
    return shards.shape[-2] if isinstance(shards, torch.Tensor) and shards.dim() >= 2 else None


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

    def encode(self, shards: torch.Tensor) -> torch.Tensor:
        shards = self._check(shards)
        n, a = self.t.n, self.alpha
        # sub-shard views of the stripe: the kernel writes the parity in place
        self.engine.matrix_apply(self._parity_rows(), rs_kernel.msr_subshards(shards[..., :n, :], a),
                                 out=rs_kernel.msr_subshards(shards[..., n:, :], a))
        if self.cfg.enable_verify and not self.verify(shards):
            raise VerifyError("parity verify failed after encode")
        return shards

    def encode_async(self, shards: torch.Tensor) -> PendingEncode:
        shards = self._check(shards)
        n, a = self.t.n, self.alpha
        return self._pending(shards, lambda b, flat: b.submit_apply_async(
            self.device, self._parity_rows(), rs_kernel.msr_subshards(flat[:, :n], a),
            out=rs_kernel.msr_subshards(flat[:, n:], a)))

    def verify(self, shards: torch.Tensor) -> bool:
        shards = self._check(shards)
        n, a = self.t.n, self.alpha
        parity = self.engine.matrix_apply(self._parity_rows(),
                                          rs_kernel.msr_subshards(shards[..., :n, :], a))
        return bool(torch.equal(rs_kernel.msr_join_subshards(parity, a), shards[..., n:, :]))

    def _reconstruct(
        self, shards: torch.Tensor, bad_idx: list[int], wanted: list[int]
    ) -> torch.Tensor:
        shards = self._check(shards, total=self.t.total)
        if not wanted:
            return shards
        t, a = self.t, self.alpha
        n, total = t.n, t.total
        bad = set(bad_idx)
        present = [i for i in range(total) if i not in bad]
        if len(present) < n:
            raise ECError(f"unrecoverable: only {len(present)} of {n} shards")
        rows = rs_kernel.msr_reconstruct_rows(n, total, t.d, tuple(present[:n]), tuple(wanted))
        sub = rs_kernel.msr_subshards(shards[..., present[:n], :], a)
        shards[..., wanted, :] = rs_kernel.msr_join_subshards(self.engine.matrix_apply(rows, sub), a)
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

    def encode(self, shards: torch.Tensor) -> torch.Tensor:
        shards = self._check(shards)
        n = self.t.n
        self.engine.matrix_apply(self._encode_rows, shards[..., :n, :], out=shards[..., n:, :])
        if self.cfg.enable_verify and not self.verify(shards):
            raise VerifyError("parity verify failed after encode")
        return shards

    def encode_async(self, shards: torch.Tensor) -> PendingEncode:
        shards = self._check(shards)
        n = self.t.n
        return self._pending(shards, lambda b, flat: b.submit_apply_async(
            self.device, self._encode_rows, flat[:, :n], out=flat[:, n:]))

    def verify(self, shards: torch.Tensor) -> bool:
        ln, lm = self._local_nm
        if _rows(shards) == ln + lm:  # a bare local stripe
            shards = self._check(shards, total=ln + lm)
            parity = self.engine.encode_parity(shards[..., :ln, :], lm)
            return bool(torch.equal(parity, shards[..., ln:, :]))
        shards = self._check(shards)
        # the global parity matches iff the stored stripe members are the
        # data's, so the local parity computed from the data is the local
        # parity of the stored members: one apply checks both levels
        n = self.t.n
        parity = self.engine.matrix_apply(self._encode_rows, shards[..., :n, :])
        return bool(torch.equal(parity, shards[..., n:, :]))

    def reconstruct(self, shards: torch.Tensor, bad_idx: list[int]) -> torch.Tensor:
        t = self.t
        ln, lm = self._local_nm
        if _rows(shards) == ln + lm:
            # intra-AZ repair on a bare local stripe (no cross-AZ traffic)
            shards = self._check(shards, total=ln + lm)
            bad = sorted(set(bad_idx))
            if not bad:
                return shards
            present = [i for i in range(ln + lm) if i not in bad]
            if len(present) < ln:
                raise ECError(f"unrecoverable local stripe: only {len(present)} of {ln} shards")
            rows = rs_kernel.reconstruct_rows(ln, ln + lm, present, bad)
            shards[..., bad, :] = self.engine.matrix_apply(rows, shards[..., present[:ln], :])
            return shards
        shards = self._check(shards)
        global_bad = sorted({i for i in bad_idx if i < t.n + t.m})
        if global_bad:
            self._reconstruct(shards[..., : t.n + t.m, :], global_bad, wanted=global_bad)
        # local parities are recomputed from their (now complete) stripes
        local_bad_azs = sorted(
            {(i - t.n - t.m) * t.az_count // t.l for i in bad_idx if i >= t.n + t.m})
        for az in local_bad_azs:
            stripe_idx, _, _ = t.local_stripe_in_az(az)
            first = stripe_idx[ln]  # an AZ's local parity rows are contiguous
            self.engine.encode_parity(shards[..., stripe_idx[:ln], :], lm,
                                      out=shards[..., first:first + lm, :])
        return shards

    def reconstruct_data(self, shards: torch.Tensor, bad_idx: list[int]) -> torch.Tensor:
        t = self.t
        # data recovery needs only the global stripe: accept the full
        # (N+M+L) layout or just the (N+M) rows (degraded GET path)
        if _rows(shards) != t.n + t.m:
            shards = self._check(shards)
        global_bad = [i for i in bad_idx if i < t.n + t.m]
        wanted = sorted({i for i in global_bad if i < t.n})
        if wanted:
            self._reconstruct(shards[..., : t.n + t.m, :], global_bad, wanted=wanted)
        return shards

    def get_local_shards(self, shards: torch.Tensor) -> torch.Tensor:
        return shards[..., self.t.n + self.t.m :, :]

    def get_shards_in_idc(self, shards: torch.Tensor, az: int) -> torch.Tensor:
        stripe_idx, _, _ = self.t.local_stripe_in_az(az)
        return shards[..., stripe_idx, :]
