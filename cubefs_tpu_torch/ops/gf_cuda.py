"""Wrapper of the GF(2^8) apply kernel (``csrc/gf_apply.cu``) and the host
half of its design.

The port's counterpart of ``cubefs_tpu/ops/pallas_gf.py``. Its plain
PyTorch version is ``rs_kernel.gf_apply_bits``; ``rs_kernel.gf_matrix_apply``
chooses between them by the tensor's device. This wrapper takes CUDA
tensors only: it launches the kernel or raises.

Multiplying by a constant is GF(2)-linear, a * x = XOR over k of
bit_k(x) * (a * 2^k), so the kernel needs, per coefficient, the eight
products a * 2^k, each copied into the four bytes of a word
(``swar_table``): a word of four input bytes then multiplies by one
coefficient as eight AND-XORs of those words with the input's bit masks
(0xFF in each byte whose bit k is set).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build, gf256

# The kernel keeps 32 bytes of products per coefficient in shared
# memory; 48 KiB is what a block gets without opting in to more.
MAX_TABLE_BYTES = 48 << 10
_MAX_GRID_Y = 65535


def swar_table(coeff: np.ndarray) -> np.ndarray:
    """(R, C) GF(2^8) coefficients -> (R, C, 8) uint32: entry [r, c, k]
    holds coeff[r, c] * 2^k in each of its four bytes."""
    coeff = np.asarray(coeff, dtype=np.uint8)
    powers = (1 << np.arange(8)).astype(np.uint8)
    prod = gf256.gf_mul(coeff[:, :, None], powers[None, None, :]).astype(np.uint32)
    return prod * np.uint32(0x01010101)


@functools.lru_cache(maxsize=256)
def _device_table(coeff_bytes: bytes, r: int, c: int, device: torch.device) -> torch.Tensor:
    coeff = np.frombuffer(coeff_bytes, dtype=np.uint8).reshape(r, c)
    return torch.from_numpy(swar_table(coeff).view(np.int32)).to(device)


def gf_apply(coeff: np.ndarray, shards: torch.Tensor, out: torch.Tensor | None = None
             ) -> torch.Tensor:
    """(R, C) GF(2^8) coefficients x (..., C, S) uint8 CUDA shards ->
    (..., R, S) uint8 on the same device, for any S. The shapes and dtype
    are checked by the caller, ``rs_kernel.gf_matrix_apply``.

    ``out``, if given, is a (..., R, S) uint8 view the kernel writes in
    place (for example the parity rows of the stripes whose data rows are
    ``shards``); its rows and stripes may have any stride, its bytes must
    be contiguous, and it must not overlap ``shards``."""
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
    if out is None:
        y = torch.empty((b, r, s), dtype=torch.uint8, device=shards.device)
    else:
        if (out.shape != (*lead, r, s) or out.dtype != torch.uint8
                or out.device != shards.device):
            raise ValueError(f"out must be a {(*lead, r, s)} uint8 tensor on "
                             f"{shards.device}, got {tuple(out.shape)} {out.dtype} "
                             f"on {out.device}")
        try:
            y = out.view(b, r, s)  # never a copy: the kernel writes through it
        except RuntimeError as e:
            raise ValueError(f"out (strides {out.stride()}) is not viewable as "
                             f"{(b, r, s)}") from e
        if s > 1 and y.stride(-1) != 1:
            raise ValueError(f"out rows must be contiguous, got strides {out.stride()}")
    if b and r and s:
        k = _device_table(coeff.tobytes(), r, c, shards.device)
        # a stride of a dim of size 1 is never followed; pass 0 so it cannot
        # spoil the kernel's alignment test
        x_st = x.stride(0) if b > 1 else 0
        y_st = [st if n > 1 else 0 for st, n in zip(y.stride()[:2], y.shape[:2])]
        with torch.cuda.device(shards.device):
            cur = torch.cuda.current_stream()
            # the cached table was allocated on the stream of its first
            # use: once evicted, its memory must not go to new work on
            # that stream before this launch has read it
            k.record_stream(cur)
            stream = cur.cuda_stream
            for i in range(0, b, _MAX_GRID_Y):
                n = min(_MAX_GRID_Y, b - i)
                _build.launch("gf_apply", x[i].data_ptr(), x_st, y[i].data_ptr(), *y_st,
                              k.data_ptr(), r, c, s, n, stream)
    return y.reshape(*lead, r, s) if out is None else out
