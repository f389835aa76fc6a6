"""Wrapper of the GF(2^8) apply kernel (``csrc/gf_apply.cu``).

The port's counterpart of ``cubefs_tpu/ops/pallas_gf.py``. Its plain
PyTorch version is ``rs_kernel.gf_apply_bits``; ``rs_kernel.gf_matrix_apply``
chooses between them by the tensor's device. This wrapper takes CUDA
tensors only: it launches the kernel or raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build

# The kernel keeps 32 bytes of nibble tables per coefficient in shared
# memory; 48 KiB is what a block gets without opting in to more.
MAX_TABLE_BYTES = 48 << 10
_MAX_GRID_Y = 65535


@functools.lru_cache(maxsize=256)
def _device_coeff(coeff_bytes: bytes, device: torch.device) -> torch.Tensor:
    return torch.frombuffer(bytearray(coeff_bytes), dtype=torch.uint8).to(device)


def gf_apply(coeff: np.ndarray, shards: torch.Tensor) -> torch.Tensor:
    """(R, C) GF(2^8) coefficients x (..., C, S) uint8 CUDA shards ->
    (..., R, S) uint8 on the same device, for any S. The shapes and dtype
    are checked by the caller, ``rs_kernel.gf_matrix_apply``."""
    coeff = np.ascontiguousarray(coeff, dtype=np.uint8)
    if not shards.is_cuda:
        raise ValueError(f"gf_apply launches a CUDA kernel; got a tensor on "
                         f"{shards.device}")
    r, c = coeff.shape
    *lead, _, s = shards.shape
    if r * c * 32 > MAX_TABLE_BYTES:
        raise ValueError(f"{r}x{c} coefficients need {r * c * 32} bytes of tables, "
                         f"over {MAX_TABLE_BYTES}")
    x = shards.reshape(-1, c, s)
    if x.stride(-1) != 1 or x.stride(-2) != s:
        x = x.contiguous()  # the kernel wants each stripe's rows back to back
    b = x.shape[0]
    out = torch.empty((b, r, s), dtype=torch.uint8, device=shards.device)
    if b and r and s:
        m = _device_coeff(coeff.tobytes(), shards.device)
        with torch.cuda.device(shards.device):
            stream = torch.cuda.current_stream().cuda_stream
            for i in range(0, b, _MAX_GRID_Y):
                n = min(_MAX_GRID_Y, b - i)
                _build.launch("gf_apply", x[i].data_ptr(), x.stride(0), out[i].data_ptr(),
                              m.data_ptr(), r, c, s, n, stream)
    return out.reshape(*lead, r, s)
