"""The codec's device engine.

The JAX package keeps a registry of engines (host table, native SIMD, XOR
programs, jnp, Pallas) behind a fallback chain. The port has one engine,
``cuda``: GF(2^8) shard math on tensors of one device. On a CUDA device
it runs the hand-written kernel; with ``device="cpu"`` it runs the plain
PyTorch version. Nothing falls back from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as devlib
from ..ops import rs_kernel


class CudaEngine:
    """Shard-level GF(2^8) math over (..., C, S) uint8 tensors."""

    name = "cuda"

    def __init__(self, device: str | torch.device | None = None):
        self.device = devlib.resolve(device)

    def _on_device(self, x) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint8))
        return x.to(self.device)

    def matrix_apply(self, coeff: np.ndarray, shards, out: torch.Tensor | None = None
                     ) -> torch.Tensor:
        """(R, C) GF matrix x (..., C, S) shards -> (..., R, S) on the
        engine's device, written into ``out`` if given."""
        return rs_kernel.gf_matrix_apply(coeff, self._on_device(shards), out=out)

    def encode_parity(self, data, n_parity: int, out: torch.Tensor | None = None
                      ) -> torch.Tensor:
        """(..., N, S) data -> (..., M, S) parity on the engine's device,
        written into ``out`` if given."""
        return rs_kernel.encode_parity(self._on_device(data), n_parity, out=out)


def get_engine(name: str = "cuda", device: str | torch.device | None = None) -> CudaEngine:
    if name != CudaEngine.name:
        raise KeyError(f"unknown ec engine {name!r}; have ['cuda']")
    return CudaEngine(device)
