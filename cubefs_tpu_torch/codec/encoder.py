"""Encoder: the reference codec interface over stripe tensors.

Semantics mirror blobstore/common/ec/encoder.go (Encode/Verify/
Reconstruct/ReconstructData/Split/Join/GetDataShards/GetParityShards/
GetLocalShards/GetShardsInIdc) for plain N+M Reed-Solomon, as the JAX
package's ``cubefs_tpu/codec/encoder.py`` does. A stripe is ONE
(total, S) uint8 tensor on the encoder's device (or a (B, total, S)
batch); encode and reconstruct fill rows in place.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import rs_kernel
from . import codemode as cm
from .engine import CudaEngine, get_engine


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
    if t.is_msr() or t.l != 0:
        raise NotImplementedError(
            f"{cm.CodeMode(cfg.mode).name}: the port has no "
            f"{'MSR' if t.is_msr() else 'LRC'} encoder yet")
    return Encoder(cfg, t, get_engine("cuda", cfg.device))


class Encoder:
    """Plain N+M Reed-Solomon codec over stripe tensors."""

    def __init__(self, cfg: CodecConfig, t: cm.Tactic, engine: CudaEngine):
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
