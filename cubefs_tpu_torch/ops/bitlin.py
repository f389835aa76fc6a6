"""GF(2)-linear form of GF(2^8) codes (host, numpy).

A multiply by a fixed coefficient c is linear over GF(2): an 8x8
bit-matrix L_c maps the bits of x to the bits of c*x. An (R, C) GF(2^8)
matrix is therefore one (8R, 8C) 0/1 matrix, and applying it to shard
bytes is a 0/1 matrix product with mod-2 accumulation. The port's plain
PyTorch path (``rs_kernel.gf_apply_bits``) computes exactly that; the
CUDA kernel computes the same bytes from nibble tables instead.

Bit order: LSB-first within a byte. Byte-major row ``b*8+k`` holds bit k
of byte b; plane-major row ``k*n+b`` holds the same bit (``bitmajor_perm``).
"""

from __future__ import annotations

import numpy as np

from . import gf256


def coeff_bitmatrix(c: int) -> np.ndarray:
    """8x8 GF(2) matrix L_c for y = gf_mul(c, x): column j holds the bits
    of gf_mul(c, 1 << j)."""
    cols = gf256.gf_mul(np.full(8, c, np.uint8), (1 << np.arange(8)).astype(np.uint8))
    return ((cols[None, :] >> np.arange(8)[:, None]) & 1).astype(np.int8)


def gf_matrix_to_bits(m: np.ndarray) -> np.ndarray:
    """Expand an (R, C) GF(2^8) matrix into its byte-major (8R, 8C) GF(2) form."""
    m = np.asarray(m, dtype=np.uint8)
    r, c = m.shape
    out = np.zeros((8 * r, 8 * c), dtype=np.int8)
    for i in range(r):
        for j in range(c):
            out[8 * i : 8 * i + 8, 8 * j : 8 * j + 8] = coeff_bitmatrix(int(m[i, j]))
    return out


def bitmajor_perm(n_bytes: int) -> np.ndarray:
    """Map byte-major bit index b*8+k to plane-major position k*n_bytes+b."""
    idx = np.arange(8 * n_bytes)
    return (idx % 8) * n_bytes + idx // 8


def w_to_bitmajor(w: np.ndarray, rows_bytes: int, cols_bytes: int) -> np.ndarray:
    """Permute an (8R, 8C) byte-major GF(2) matrix so it consumes
    plane-major inputs and produces plane-major outputs."""
    rp = bitmajor_perm(rows_bytes)
    cp = bitmajor_perm(cols_bytes)
    out = np.zeros_like(w)
    out[rp[:, None], cp[None, :]] = w
    return out
