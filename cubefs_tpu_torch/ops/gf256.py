"""GF(2^8) arithmetic and Reed-Solomon matrix construction (host, numpy).

The port's own copy of the field and encode-matrix math of the JAX
package (``cubefs_tpu/ops/gf256.py``), trimmed to what the RS encode and
repair path uses: GF(2^8) with the 0x11D field polynomial and the
systematic matrix ``V * inv(V_top)`` built from the Vandermonde matrix
``V[r][c] = r^c`` (klauspost/reedsolomon's default, as the reference's
blobstore/common/ec/encoder.go uses it).

Everything here is tiny exact integer math that runs once per codemode
or erasure pattern on the host; the byte work happens on the card in
``csrc/gf_apply.cu``.
"""

from __future__ import annotations

import functools

import numpy as np

FIELD_POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1, generator 2
FIELD_SIZE = 256


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= FIELD_POLY
    exp[255:510] = exp[0:255]
    return exp, log


EXP, LOG = _build_tables()


@functools.cache
def mul_table() -> np.ndarray:
    """Full 256x256 GF(2^8) multiplication table (row a, col b)."""
    a = np.arange(256)
    t = EXP[(LOG[a][:, None] + LOG[a][None, :]) % 255].copy()
    t[0, :] = 0
    t[:, 0] = 0
    return t


@functools.cache
def inv_table() -> np.ndarray:
    t = np.zeros(256, dtype=np.uint8)
    t[1:] = EXP[(255 - LOG[np.arange(1, 256)]) % 255]
    return t


def gf_mul(a, b):
    """Element-wise GF(2^8) multiply of arrays/scalars of uint8."""
    return mul_table()[np.asarray(a, dtype=np.uint8), np.asarray(b, dtype=np.uint8)]


def gf_exp(a: int, n: int) -> int:
    """a^n with the reference's galExp conventions: a^0 == 1 for every a
    (including 0); 0^n == 0 for n > 0."""
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(EXP[(int(LOG[a]) * n) % 255])


def gf_matmul(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """GF(2^8) matrix product. A: (m, k) uint8, B: (k, n) uint8."""
    A = np.asarray(A, dtype=np.uint8)
    B = np.asarray(B, dtype=np.uint8)
    mt = mul_table()
    out = np.zeros((A.shape[0], B.shape[1]), dtype=np.uint8)
    for j in range(A.shape[1]):
        out ^= mt[A[:, j][:, None], B[j][None, :]]
    return out


def gf_inv_matrix(M: np.ndarray) -> np.ndarray:
    """Invert a square GF(2^8) matrix by Gauss-Jordan elimination."""
    M = np.asarray(M, dtype=np.uint8)
    n = M.shape[0]
    if M.shape != (n, n):
        raise ValueError("matrix must be square")
    mt = mul_table()
    inv = inv_table()
    work = np.concatenate([M.copy(), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        pivot = col
        while pivot < n and work[pivot, col] == 0:
            pivot += 1
        if pivot == n:
            raise np.linalg.LinAlgError("singular GF(2^8) matrix")
        if pivot != col:
            work[[col, pivot]] = work[[pivot, col]]
        work[col] = mt[work[col], inv[work[col, col]]]
        for r in range(n):
            if r != col and work[r, col] != 0:
                work[r] ^= mt[work[col], work[r, col]]
    return work[:, n:].copy()


def vandermonde(rows: int, cols: int) -> np.ndarray:
    v = np.zeros((rows, cols), dtype=np.uint8)
    for r in range(rows):
        for c in range(cols):
            v[r, c] = gf_exp(r, c)
    return v


@functools.cache
def encode_matrix(n_data: int, n_total: int) -> np.ndarray:
    """Systematic (n_total, n_data) encode matrix: identity on top, parity
    generator rows below (reedsolomon.New(n_data, n_total-n_data))."""
    if not (0 < n_data <= n_total <= FIELD_SIZE):
        raise ValueError(f"invalid shard counts n={n_data} total={n_total}")
    v = vandermonde(n_total, n_data)
    m = gf_matmul(v, gf_inv_matrix(v[:n_data]))
    m.setflags(write=False)
    return m


def parity_matrix(n_data: int, n_parity: int) -> np.ndarray:
    """(n_parity, n_data) rows that produce parity shards from data."""
    return encode_matrix(n_data, n_data + n_parity)[n_data:]


def decode_matrix(n_data: int, n_total: int, present: list[int]) -> np.ndarray:
    """(n_data, n_data) matrix recovering all data shards from the first
    n_data present shards (sorted indices into the full shard list)."""
    if len(present) < n_data:
        raise ValueError(f"need {n_data} shards, have {len(present)}")
    return gf_inv_matrix(encode_matrix(n_data, n_total)[np.asarray(present[:n_data])])
