"""The least time one H100 could take for the codec work of a window.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit): 3.35 TB/s of HBM3 and 1,979 TOP/s of int8.
A GF(2^8) apply of R rows over C input rows of S bytes, B stripes,
reads B*C*S bytes once and writes B*R*S once, and does R*C*S*B
multiply-adds, counted as two int8 operations each. The bound is the
larger of bytes over the bandwidth and operations over the peak.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1.979e15


def work(applies) -> tuple[int, int]:
    """(bytes, operations) of (R, C, S, B) applies."""
    nbytes = sum(b * (c + r) * s for r, c, s, b in applies)
    ops = sum(2 * r * c * s * b for r, c, s, b in applies)
    return nbytes, ops


def bound_s(applies) -> float:
    nbytes, ops = work(applies)
    return max(nbytes / HBM_BYTES_S, ops / INT8_OPS_S)
