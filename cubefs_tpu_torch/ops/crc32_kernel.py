"""Batched CRC32 (IEEE, zlib-identical) of equal-length blocks.

CRC32 is affine in the message bits: crc(m) = L(m) XOR crc(0^len), with
L the raw CRC (init 0, no final XOR). A block splits into chunks whose
raw CRCs are independent; each is moved to the end of the block by a
32x32 zero-extension matrix A^n ("append n zero bytes", zlib's
crc32_combine algebra) and the results XOR together.

Host half (numpy): the byte table, the zero-extension and chunk
matrices, crc32_zeros, crc32_combine and fit_chunk_len, copied from the
JAX package's ``cubefs_tpu/ops/crc32_kernel.py``.

Device half: ``crc32_blocks`` sends a CUDA tensor to the hand-written
kernel (``crc_cuda``, ``csrc/crc32_blocks.cu``, which cuts blocks into
its own spans and needs no chunk length) and a CPU tensor to the
plain PyTorch version, ``crc32_blocks_plain``: the chunk bits times the
(8L, 32) chunk matrix, then the fold with the shift matrices, both as
float32 products of 0/1 values (exact: sums stay far below 2^24).
CRCs come back as int64 tensors holding the unsigned 32-bit value.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import bitlin

_POLY_REFLECTED = 0xEDB88320

# Target chunk length of the plain version: the largest divisor of the
# block length up to it is used. It sets how a block is cut up, never the
# result.
CHUNK_LEN = 1024

# Peak-memory budget for the plain version's bit-unpack intermediate:
# 32 bytes per payload byte (8 float32 bits). Larger batches run in
# slices of whole blocks.
_UNPACK_BUDGET_BYTES = 512 << 20


@functools.cache
def _byte_table() -> np.ndarray:
    """Standard reflected CRC32 byte table T[b] (uint32)."""
    t = np.zeros(256, dtype=np.uint64)
    for b in range(256):
        c = b
        for _ in range(8):
            c = (c >> 1) ^ (_POLY_REFLECTED if c & 1 else 0)
        t[b] = c
    return t.astype(np.uint32)


def _state_bits(x: int) -> np.ndarray:
    return ((np.uint64(x) >> np.arange(32, dtype=np.uint64)) & np.uint64(1)).astype(np.uint8)


def _bits_to_u32(bits: np.ndarray) -> int:
    return int((bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum() & np.uint64(0xFFFFFFFF))


@functools.cache
def zero_byte_matrix() -> bytes:
    """32x32 GF(2) matrix A: state after absorbing one zero byte,
    state' = (state >> 8) ^ T[state & 0xff]."""
    a = np.zeros((32, 32), dtype=np.uint8)
    t = _byte_table()
    for i in range(32):
        s = 1 << i
        a[:, i] = _state_bits((s >> 8) ^ int(t[s & 0xFF]))
    return a.tobytes()


def _matpow(a: np.ndarray, n: int) -> np.ndarray:
    r = np.eye(32, dtype=np.uint8)
    base = a.copy()
    while n:
        if n & 1:
            r = (r @ base) & 1
        base = (base @ base) & 1
        n >>= 1
    return r


@functools.cache
def zeros_matrix(n_bytes: int) -> np.ndarray:
    """A^n: effect of appending n zero bytes on the raw CRC state."""
    a = np.frombuffer(zero_byte_matrix(), dtype=np.uint8).reshape(32, 32)
    return _matpow(a, n_bytes)


@functools.cache
def chunk_matrix(chunk_len: int) -> np.ndarray:
    """(32, 8*chunk_len) GF(2) matrix W: raw CRC of a standalone chunk as
    a function of its bits (byte-major columns). Column for bit i of byte
    j is A^(chunk_len-1-j) @ T_column(1<<i)."""
    t = _byte_table()
    a = np.frombuffer(zero_byte_matrix(), dtype=np.uint8).reshape(32, 32)
    w = np.zeros((32, 8 * chunk_len), dtype=np.uint8)
    cols = np.stack([_state_bits(int(t[1 << i])) for i in range(8)], axis=1)
    for j in range(chunk_len - 1, -1, -1):  # cols = A^(chunk_len-1-j) @ base
        w[:, 8 * j : 8 * j + 8] = cols
        cols = (a @ cols) & 1
    return w


@functools.cache
def shift_matrices(chunk_len: int, n_chunks: int) -> np.ndarray:
    """(n_chunks, 32, 32): chunk k's zero-extension to the end of its
    block, A^((n_chunks-1-k)*chunk_len)."""
    step = zeros_matrix(chunk_len)
    out = np.zeros((n_chunks, 32, 32), dtype=np.uint8)
    m = np.eye(32, dtype=np.uint8)
    for k in range(n_chunks - 1, -1, -1):
        out[k] = m
        m = (m @ step) & 1
    out.setflags(write=False)
    return out


@functools.cache
def shift_columns(chunk_len: int, n_chunks: int) -> np.ndarray:
    """shift_matrices as 32 uint32 column masks per chunk position:
    entry [k, i] has bit j set where matrix k has a 1 at row j, column i
    (the form the CUDA kernel takes, one chunk per span)."""
    m = shift_matrices(chunk_len, n_chunks).astype(np.uint64)
    cols = (m << np.arange(32, dtype=np.uint64)[None, :, None]).sum(axis=1)
    out = cols.astype(np.uint32)
    out.setflags(write=False)
    return out


@functools.cache
def crc32_zeros(n: int) -> int:
    """crc32 of n zero bytes, computed via the shift matrices (no buffer)."""
    s = (zeros_matrix(n) @ _state_bits(0xFFFFFFFF)) & 1
    return _bits_to_u32(s) ^ 0xFFFFFFFF


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """zlib crc32_combine: crc of concat(m1, m2) from crc(m1), crc(m2)
    and len(m2)."""
    s1 = _state_bits(crc1 ^ 0xFFFFFFFF)  # internal state after m1
    crc_m1_zeros = _bits_to_u32((zeros_matrix(len2) @ s1) & 1) ^ 0xFFFFFFFF
    return crc_m1_zeros ^ crc2 ^ crc32_zeros(len2)


@functools.cache
def fit_chunk_len(chunk_len: int, total_len: int) -> int:
    """Largest divisor of total_len that is <= chunk_len (>= 1); cached,
    since the search is O(sqrt(total_len)) Python."""
    if total_len <= chunk_len:
        return total_len
    best = 1
    d = 1
    while d * d <= total_len:
        if total_len % d == 0:
            if d <= chunk_len:
                best = max(best, d)
            if total_len // d <= chunk_len:
                best = max(best, total_len // d)
        d += 1
    return best


@functools.cache
def _plane_major_wt(chunk_len: int) -> np.ndarray:
    """(8L, 32) transposed chunk matrix with plane-major rows (bit k of
    byte j at row k*L + j), as the Pallas kernel's Wt."""
    w = chunk_matrix(chunk_len)
    w_pm = np.zeros_like(w)
    w_pm[:, bitlin.bitmajor_perm(chunk_len)] = w
    return np.ascontiguousarray(w_pm.T)


def linear_crc_bits(segments: torch.Tensor, chunk_len: int) -> torch.Tensor:
    """Raw (linear) CRC of equal-length byte segments as bit vectors.

    segments: (..., seg_len) uint8 -> (..., 32) int32 in {0, 1}, L(m) with
    crc32(m) == L(m) XOR crc32(0^seg_len).
    """
    *lead, seg_len = segments.shape
    if seg_len % chunk_len:
        raise ValueError(f"seg_len {seg_len} % chunk_len {chunk_len} != 0")
    n_chunks = seg_len // chunk_len
    dev = segments.device
    wt = torch.as_tensor(_plane_major_wt(chunk_len), device=dev).float()
    shifts = torch.from_numpy(shift_matrices(chunk_len, n_chunks).copy()).to(dev).float()
    flat = segments.reshape(-1, n_chunks, chunk_len)
    planes = (flat.unsqueeze(-2) >> torch.arange(8, dtype=torch.uint8, device=dev)[:, None]) & 1
    bits = planes.reshape(flat.shape[0], n_chunks, 8 * chunk_len).float()
    part = (bits @ wt).to(torch.int32) & 1  # (B, C, 32) raw CRC per chunk
    folded = torch.einsum("cij,bcj->bi", shifts, part.float()).to(torch.int32) & 1
    return folded.reshape(*lead, 32)


def pack_crc_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 32) {0,1} -> (...,) int64 holding the unsigned 32-bit value."""
    pow2 = torch.arange(32, dtype=torch.int64, device=bits.device)
    return (bits.to(torch.int64) << pow2).sum(-1)


def crc32_blocks_plain(blocks: torch.Tensor, chunk_len: int = CHUNK_LEN) -> torch.Tensor:
    """Plain PyTorch version of the CRC kernel. blocks: (..., block_len)
    uint8 -> (...) int64 CRC32 values, bit-identical to zlib.crc32.

    Batches whose bit unpack would pass the memory budget run in slices
    of whole blocks (at least one block per slice)."""
    *lead, block_len = blocks.shape
    flat = blocks.reshape(-1, block_len)
    chunk_len = fit_chunk_len(chunk_len, block_len)
    const = torch.as_tensor(_state_bits(crc32_zeros(block_len)).astype(np.int32),
                            device=blocks.device)
    micro = max(1, _UNPACK_BUDGET_BYTES // (32 * block_len))
    out = torch.empty(flat.shape[0], dtype=torch.int64, device=blocks.device)
    for i in range(0, flat.shape[0], micro):
        linear = linear_crc_bits(flat[i : i + micro], chunk_len)
        out[i : i + micro] = pack_crc_bits(linear ^ const)
    return out.reshape(lead)


def crc32_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """Batched zlib-compatible CRC32 of equal-length blocks.

    blocks: (..., block_len) uint8 -> (...) int64 holding each block's
    unsigned CRC32. A CUDA tensor goes to the CUDA kernel, which reads
    strided leading dims in place; a CPU tensor to the plain PyTorch
    version.
    """
    if blocks.dim() < 2 or blocks.dtype != torch.uint8:
        raise ValueError(f"blocks must be (..., B, block_len) uint8, got "
                         f"{tuple(blocks.shape)} {blocks.dtype}")
    if blocks.is_cuda:
        from . import crc_cuda

        return crc_cuda.crc32_blocks(blocks)
    if blocks.device.type != "cpu":
        raise ValueError(f"unsupported device {blocks.device}")
    return crc32_blocks_plain(blocks)
