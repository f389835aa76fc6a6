"""GF(2^8) with the polynomial x^8 + x^4 + x^3 + x^2 + 1 (0x11D), and the
matrices of the codes: systematic RS encode rows, decode rows for any
set of survivors, and the LRC local rows.

Host numpy, exact integer math: matrices are tiny. ``apply`` does the
byte work as table lookups in plain PyTorch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

POLY = 0x11D


@functools.cache
def tables() -> tuple[np.ndarray, np.ndarray]:
    """(exp, log): exp[i] = 2^i for i < 510, log[2^i] = i."""
    exp = np.zeros(510, dtype=np.int64)
    log = np.zeros(256, dtype=np.int64)
    x = 1
    for i in range(255):
        exp[i] = exp[i + 255] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    return exp, log


@functools.cache
def mul_table() -> np.ndarray:
    """(256, 256) uint8: mul_table()[a, b] = a * b."""
    exp, log = tables()
    a = np.arange(256)
    out = exp[(log[a][:, None] + log[a][None, :]) % 255].astype(np.uint8)
    out[0, :] = 0
    out[:, 0] = 0
    return out


def mul(a: int, b: int) -> int:
    return int(mul_table()[a, b])


def power(a: int, n: int) -> int:
    """a^n, with a^0 = 1 for every a (0^0 included), as reedsolomon's galExp."""
    if n == 0:
        return 1
    if a == 0:
        return 0
    exp, log = tables()
    return int(exp[(log[a] * n) % 255])


def matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    t = mul_table()
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint8)
    for k in range(a.shape[1]):
        out ^= t[a[:, k][:, None], b[k][None, :]]
    return out


def inverse(m: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inverse of a square matrix; raises if singular."""
    m = np.asarray(m, dtype=np.uint8)
    n = m.shape[0]
    t = mul_table()
    work = np.concatenate([m.copy(), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        rows = [r for r in range(col, n) if work[r, col]]
        if not rows:
            raise ValueError("singular matrix")
        work[[col, rows[0]]] = work[[rows[0], col]]
        inv = next(x for x in range(1, 256) if mul(work[col, col], x) == 1)
        work[col] = t[work[col], inv]
        for r in range(n):
            if r != col and work[r, col]:
                work[r] ^= t[work[col], work[r, col]]
    return work[:, n:].copy()


@functools.cache
def rs_matrix(n: int, total: int) -> np.ndarray:
    """(total, n) systematic encode matrix: V * inv(V[:n]) with the
    Vandermonde V[r, c] = r^c; its top n rows are the identity."""
    v = np.array([[power(r, c) for c in range(n)] for r in range(total)], dtype=np.uint8)
    return matmul(v, inverse(v[:n]))


def decode_rows(n: int, total: int, solve: list[int], wanted: list[int]) -> np.ndarray:
    """(len(wanted), n) rows giving the ``wanted`` shards of an RS(n,
    total - n) stripe from the n shards ``solve`` (ascending)."""
    enc = rs_matrix(n, total)
    return matmul(enc[list(wanted)], inverse(enc[list(solve)]))


def apply(rows: np.ndarray, x: torch.Tensor, block: int = 8) -> torch.Tensor:
    """(R, C) GF(2^8) rows times (B, C, S) uint8 shards -> (B, R, S),
    byte by byte through the multiplication table, on ``x``'s device,
    ``block`` stripes at a time."""
    rows = np.asarray(rows, dtype=np.uint8)
    table = torch.from_numpy(mul_table().reshape(-1)).to(x.device)
    out = torch.zeros((x.shape[0], rows.shape[0], x.shape[2]), dtype=torch.uint8,
                      device=x.device)
    for i in range(0, x.shape[0], block):
        idx = x[i:i + block].long()
        for r in range(rows.shape[0]):
            for c in range(rows.shape[1]):
                if rows[r, c]:
                    out[i:i + block, r] ^= table[int(rows[r, c]) * 256 + idx[:, c]]
    return out
