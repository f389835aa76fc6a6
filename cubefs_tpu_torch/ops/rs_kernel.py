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

The LRC and MSR families use the same apply: ``lrc_reconstruct_rows``
composes a local parity's row with its stripe members' rows, and the
``msr_*`` rows (``ops/msr.py``) apply to sub-shard views of the stripes
(``msr_subshards``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import bitlin, gf256, gf_cuda, msr

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
    flat = shards.reshape(math.prod(lead), c, s)  # not -1: S may be 0
    out = torch.empty((flat.shape[0], r, s), dtype=torch.uint8, device=shards.device)
    for i in range(flat.shape[0]):
        for j in range(0, s, _PLAIN_COLS):
            x = unpack_bits(flat[i, :, j : j + _PLAIN_COLS]).float()
            out[i, :, j : j + _PLAIN_COLS] = pack_bits((w @ x).to(torch.int32) & 1)
    return out.reshape(*lead, r, s)


def gf_matrix_apply(coeff: np.ndarray, shards: torch.Tensor,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """shards: (..., C, S) uint8, coeff: (R, C) GF(2^8) -> (..., R, S) on
    the shards' device. The coefficient matrix is a runtime argument of
    the kernel: a new erasure pattern compiles nothing. ``out``, a
    (..., R, S) uint8 view that does not overlap ``shards``, receives the
    result in place (the kernel writes it directly) and is returned."""
    coeff = np.ascontiguousarray(coeff, dtype=np.uint8)
    if (coeff.ndim != 2 or not coeff.shape[1] or shards.dim() < 2
            or shards.shape[-2] != coeff.shape[1]):
        raise ValueError(f"coefficient matrix {coeff.shape} does not apply to "
                         f"shards {tuple(shards.shape)}")
    if shards.dtype != torch.uint8:
        raise ValueError(f"shards must be uint8, got {shards.dtype}")
    if shards.is_cuda:
        return gf_cuda.gf_apply(coeff, shards, out=out)
    if shards.device.type != "cpu":
        raise ValueError(f"unsupported device {shards.device}")
    y = gf_apply_bits(torch.from_numpy(coeff_bits(coeff)), shards)
    if out is None:
        return y
    if out.shape != y.shape or out.dtype != y.dtype or out.device != y.device:
        raise ValueError(f"out must be a {tuple(y.shape)} uint8 tensor on {y.device}, got "
                         f"{tuple(out.shape)} {out.dtype} on {out.device}")
    return out.copy_(y)


def encode_parity(data: torch.Tensor, n_parity: int,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """data: (..., N, S) uint8 -> parity (..., M, S) uint8, written into
    ``out`` if given."""
    return gf_matrix_apply(gf256.parity_matrix(int(data.shape[-2]), n_parity), data, out=out)


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


def lrc_reconstruct_rows(
    n_data: int, n_total: int, stripes: list[list[int]], ln: int,
    present: list[int], wanted: list[int],
) -> np.ndarray:
    """reconstruct_rows over the full two-level LRC shard space.

    ``present`` indexes the global stripe (< n_total: data and global
    parity); ``wanted`` may include local-parity indices (>= n_total). A
    local parity is the local code's re-encode of its stripe's first
    ``ln`` members, all global-space indices, so its row is the local
    encode row composed with the global solve: one matrix, one apply.
    With the data shards as ``present`` the solve is the identity, and
    the rows of every parity shard are the LRC encode matrix."""
    present = sorted(present)[:n_data]
    dec = gf256.decode_matrix(n_data, n_total, present)
    enc = gf256.encode_matrix(n_data, n_total)
    rows = np.zeros((len(wanted), n_data), dtype=np.uint8)
    for r, w in enumerate(wanted):
        if w < n_total:
            rows[r] = enc[w]
            continue
        stripe = next(s for s in stripes if w in s)
        local = gf256.encode_matrix(ln, len(stripe))
        members = enc[np.asarray(stripe[:ln])]
        rows[r] = gf256.gf_matmul(local[[stripe.index(w)]], members)[0]
    return gf256.gf_matmul(rows, dec)


# ---------------- product-matrix MSR (regenerating code) ----------------
# Row construction lives in ops/msr.py (tiny exact host math, cached per
# geometry, failed slot and helper set); the byte work is one
# gf_matrix_apply, the same kernel as RS.

msr_encode_rows = msr.encode_rows
msr_helper_rows = msr.helper_rows
msr_repair_rows = msr.repair_rows
msr_verify_rows = msr.verify_rows
msr_reconstruct_rows = msr.reconstruct_rows


def msr_subshards(shards: torch.Tensor, alpha: int) -> torch.Tensor:
    """(..., B, S) -> (..., B*alpha, S/alpha): each shard's alpha
    sub-shards as rows, so MSR coefficient matrices apply. A view, never
    a copy (it raises if the rows of a shard are not back to back), so a
    kernel writing into it writes into the stripe. S must be divisible
    by alpha (``MsrEncoder.shard_size`` rounds to it)."""
    *lead, b, s = shards.shape
    if s % alpha:
        raise ValueError(f"shard size {s} not divisible by alpha={alpha}")
    return shards.view(*lead, b * alpha, s // alpha)


def msr_join_subshards(sub: torch.Tensor, alpha: int) -> torch.Tensor:
    """Inverse of msr_subshards: (..., B*alpha, beta) -> (..., B, S), a view."""
    *lead, rows, beta = sub.shape
    return sub.view(*lead, rows // alpha, alpha * beta)


def msr_encode_parity(data: torch.Tensor, k: int, total: int, d: int) -> torch.Tensor:
    """data: (..., k, S) uint8 -> parity (..., total-k, S) uint8 through
    the product-matrix generator (``MsrEncoder.encode`` applies the same
    rows straight into the stripe's parity sub-shards)."""
    alpha = d - k + 1
    return msr_join_subshards(
        gf_matrix_apply(msr.encode_rows(k, total, d), msr_subshards(data, alpha)), alpha)


def msr_repair_shard(payloads: torch.Tensor, k: int, total: int, d: int,
                     failed: int, helpers: tuple[int, ...]) -> torch.Tensor:
    """payloads: (..., d, beta) helper symbols (in ``helpers`` order) ->
    the failed shard (..., S = alpha*beta): d*beta bytes of repair
    traffic instead of the conventional k*alpha*beta."""
    out = gf_matrix_apply(msr.repair_rows(k, total, d, failed, tuple(helpers)), payloads)
    *lead, alpha, beta = out.shape
    return out.view(*lead, alpha * beta)
