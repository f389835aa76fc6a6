"""Reed-Solomon encode and reconstruct as GF(2^8) matrix applies (PyTorch).

The hot path of the reference's erasure-coding plane, GF(2^8) matrix
times shards (blobstore/common/ec/encoder.go encode,
blobnode/worker_slice_recover.go reconstruct). Shards are (..., C, S)
uint8 tensors: leading batch dims (stripes), C shards of S bytes.

``gf_matrix_apply`` sends a CUDA tensor to the hand-written kernel
(``gf_cuda``, ``csrc/gf_apply.cu``) for any S, and a CPU tensor to the
plain PyTorch version ``gf_apply_bits``: the GF(2) bit expansion of the
coefficient matrix (plane-major, ``coeff_bits``) times the unpacked bit
planes, a float32 product of 0/1 values (exact: sums <= 8*36 = 288),
then mod 2 and a repack. Both are exact integer math, so the outputs are
bit-identical to the reference engine for the same encode matrix.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bitlin, gf256, gf_cuda

# Columns of S per slice of the plain version: bounds its float32 bit
# planes to 8*C*4 bytes per column.
_PLAIN_COLS = 1 << 20


def coeff_bits(coeff: np.ndarray) -> np.ndarray:
    """(R, C) GF(2^8) matrix -> its (8R, 8C) 0/1 int8 matrix in the
    plane-major layout on both sides (row k*R+r, column k*C+c)."""
    coeff = np.asarray(coeff, dtype=np.uint8)
    r, c = coeff.shape
    return bitlin.w_to_bitmajor(bitlin.gf_matrix_to_bits(coeff), r, c)


def unpack_bits(x: torch.Tensor) -> torch.Tensor:
    """(..., B, S) uint8 -> (..., 8B, S) uint8 bits, LSB-first,
    plane-major: row k*B + b holds bit k of byte row b."""
    *lead, b, s = x.shape
    sh = torch.arange(8, dtype=torch.uint8, device=x.device)[:, None, None]
    return ((x.unsqueeze(-3) >> sh) & 1).reshape(*lead, 8 * b, s)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 8B, S) {0,1} plane-major -> (..., B, S) uint8."""
    *lead, b8, s = bits.shape
    planes = bits.reshape(*lead, 8, b8 // 8, s).to(torch.int32)
    sh = torch.arange(8, dtype=torch.int32, device=bits.device)[:, None, None]
    return (planes << sh).sum(-3).to(torch.uint8)


def gf_apply_bits(w_bits: torch.Tensor, shards: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the GF apply kernel.

    w_bits: (8R, 8C) 0/1 plane-major (``coeff_bits``), any dtype;
    shards: (..., C, S) uint8 -> (..., R, S) uint8. Runs stripe by
    stripe in slices of at most _PLAIN_COLS columns.
    """
    *lead, c, s = shards.shape
    r = w_bits.shape[0] // 8
    w = w_bits.to(device=shards.device, dtype=torch.float32)
    flat = shards.reshape(-1, c, s)
    out = torch.empty((flat.shape[0], r, s), dtype=torch.uint8, device=shards.device)
    for i in range(flat.shape[0]):
        for j in range(0, s, _PLAIN_COLS):
            x = unpack_bits(flat[i, :, j : j + _PLAIN_COLS]).float()
            out[i, :, j : j + _PLAIN_COLS] = pack_bits((w @ x).to(torch.int32) & 1)
    return out.reshape(*lead, r, s)


def gf_matrix_apply(coeff: np.ndarray, shards: torch.Tensor) -> torch.Tensor:
    """shards: (..., C, S) uint8, coeff: (R, C) GF(2^8) -> (..., R, S) on
    the shards' device. The coefficient matrix is a runtime argument of
    the kernel: a new erasure pattern compiles nothing."""
    coeff = np.ascontiguousarray(coeff, dtype=np.uint8)
    if (coeff.ndim != 2 or not coeff.shape[1] or shards.dim() < 2
            or shards.shape[-2] != coeff.shape[1]):
        raise ValueError(f"coefficient matrix {coeff.shape} does not apply to "
                         f"shards {tuple(shards.shape)}")
    if shards.dtype != torch.uint8:
        raise ValueError(f"shards must be uint8, got {shards.dtype}")
    if shards.is_cuda:
        return gf_cuda.gf_apply(coeff, shards)
    if shards.device.type != "cpu":
        raise ValueError(f"unsupported device {shards.device}")
    return gf_apply_bits(torch.from_numpy(coeff_bits(coeff)), shards)


def encode_parity(data: torch.Tensor, n_parity: int) -> torch.Tensor:
    """data: (..., N, S) uint8 -> parity (..., M, S) uint8."""
    return gf_matrix_apply(gf256.parity_matrix(int(data.shape[-2]), n_parity), data)


def reconstruct_rows(
    n_data: int, n_total: int, present: list[int], wanted: list[int]
) -> np.ndarray:
    """GF matrix mapping the first n_data present shards to the wanted
    shard indices: data rows from the inverted submatrix, parity rows by
    re-encoding (the reference engine's Reconstruct algebra)."""
    present = sorted(present)[:n_data]
    dec = gf256.decode_matrix(n_data, n_total, present)
    enc = gf256.encode_matrix(n_data, n_total)
    return gf256.gf_matmul(enc[np.asarray(wanted)], dec)


def reconstruct_stripes(
    surviving: torch.Tensor,
    present: list[int],
    wanted: list[int],
    n_data: int,
    n_total: int,
) -> torch.Tensor:
    """surviving: (..., n_data, S) uint8 = the first n_data present shards
    in ascending shard-index order; returns (..., len(wanted), S)."""
    return gf_matrix_apply(reconstruct_rows(n_data, n_total, present, wanted), surviving)
