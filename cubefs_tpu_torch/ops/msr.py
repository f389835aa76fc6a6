"""Product-matrix MSR regenerating-code matrices (host, numpy).

The port's own copy of ``cubefs_tpu/ops/msr.py``: the Rashmi-Shah-Kumar
product-matrix construction at the MSR point (PAPERS.md,
arXiv:1412.3022 "Fast Product-Matrix Regenerating Codes"). A
(total, k, d) code stores every shard as alpha = d-k+1 sub-shards of
beta = S/alpha bytes, and repairing ONE failed shard downloads a single
beta-sized symbol from each of d helpers instead of k full shards, a
k*alpha/d reduction in repair traffic.

Construction (d = 2k-2, the exact MSR point):
  * message matrix M = [S1; S2], S1/S2 symmetric alpha x alpha, holding
    B = k*alpha free symbols;
  * encoding matrix Psi (n x 2*alpha) Vandermonde in distinct lambdas,
    so row i splits as [phi_i | lambda_i^alpha * phi_i] with
    phi_i = [1, lambda_i, ..., lambda_i^(alpha-1)];
  * node i stores t_i = psi_i^T M (alpha symbols).
Repair of node f: helper h sends the scalar t_h . phi_f; the d received
symbols solve Psi_rep x = recv for x = M phi_f, and symmetry gives
t_f = (S1 phi_f)^T + lambda_f (S2 phi_f)^T.

d > 2k-2 is reached by SHORTENING: build the parent (total+j, k+j,
d+j) code with j = d-2k+2 virtual systematic nodes pinned to zero data.
Their stored content is zero, so their columns are dropped from every
matrix before it is cached.

Everything here is tiny exact host math producing coefficient matrices;
the byte work is one GF(2^8) matrix apply on the card
(``rs_kernel.gf_matrix_apply``, kernel ``csrc/gf_apply.cu``), exactly
as for RS. Every public *_rows function is cached in the shared capped
cache (``ops/progcache.py``, family "msr"), so the inverse for a
(geometry, failed slot, helper set) key is solved once per process.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from . import gf256, progcache


def feasible_nodes(alpha: int) -> int:
    """Max parent-code nodes GF(256) supports for a given alpha: the
    lambdas must be distinct AND have distinct alpha-th powers (the
    Lambda diagonal of Psi), and the nonzero field elements yield only
    255/gcd(alpha, 255) distinct alpha-th powers."""
    return 255 // math.gcd(alpha, 255)


def validate_geometry(k: int, total: int, d: int) -> None:
    """Reject geometries the product-matrix construction cannot build.
    Raises ValueError with a distinct message per failure mode."""
    if k < 2:
        raise ValueError(f"MSR needs k >= 2 data shards, got k={k}")
    if d < k:
        raise ValueError(
            f"MSR d={d} < k={k}: a regenerating repair needs at least "
            f"as many helpers as a conventional decode")
    if d >= total:
        raise ValueError(
            f"MSR d={d} >= total={total}: helpers must be surviving "
            f"shards, so d can be at most total-1")
    if d < 2 * k - 2:
        raise ValueError(
            f"product-matrix MSR exists only for d >= 2k-2 = {2 * k - 2}, "
            f"got d={d} (interior points need a different construction)")
    alpha = d - k + 1
    nbar = total + (d - (2 * k - 2))
    if nbar > feasible_nodes(alpha):
        raise ValueError(
            f"GF(256) admits only {feasible_nodes(alpha)} nodes with "
            f"distinct lambda^{alpha} values; geometry needs {nbar}")


@dataclass(frozen=True)
class MsrParams:
    """Derived parent-code parameters of a shortened (total, k, d)
    product-matrix MSR code."""

    k: int
    total: int
    d: int
    j: int        # virtual (shortened) systematic nodes
    alpha: int    # sub-shards per shard; beta = S / alpha
    kbar: int     # parent k = k + j
    nbar: int     # parent n = total + j
    lambdas: tuple[int, ...]  # parent-node Vandermonde points


@progcache.cached("msr")
def params(k: int, total: int, d: int) -> MsrParams:
    validate_geometry(k, total, d)
    j = d - (2 * k - 2)
    alpha = d - k + 1
    nbar = total + j
    # greedy lambda election: distinct elements with distinct alpha-th
    # powers (deterministic, so every process derives the same code)
    lambdas: list[int] = []
    powers: set[int] = set()
    for cand in range(1, 256):
        p = gf256.gf_exp(cand, alpha)
        if p in powers:
            continue
        powers.add(p)
        lambdas.append(cand)
        if len(lambdas) == nbar:
            break
    if len(lambdas) < nbar:  # pragma: no cover - validate() bounds this
        raise ValueError(f"lambda election failed for alpha={alpha}")
    return MsrParams(k, total, d, j, alpha, k + j, nbar, tuple(lambdas))


def _psi(p: MsrParams) -> np.ndarray:
    """(nbar, 2*alpha) Vandermonde encoding matrix of the parent code."""
    dbar = 2 * p.alpha
    psi = np.zeros((p.nbar, dbar), dtype=np.uint8)
    for i, lam in enumerate(p.lambdas):
        for c in range(dbar):
            psi[i, c] = gf256.gf_exp(lam, c)
    return psi


def _sym_index(alpha: int, a: int, b: int) -> int:
    """Row-major upper-triangle index of symmetric entry (a, b)."""
    a, b = (a, b) if a <= b else (b, a)
    return a * alpha - a * (a - 1) // 2 + (b - a)


@progcache.cached("msr")
def _generator(k: int, total: int, d: int) -> np.ndarray:
    """Systematic generator G (nbar*alpha, kbar*alpha) of the parent
    code: G = E . inv(A), where E maps the B free message symbols to
    all node contents and A is its square top (the parent systematic
    nodes). Top kbar*alpha rows of G are the identity."""
    p = params(k, total, d)
    alpha, kbar, nbar = p.alpha, p.kbar, p.nbar
    half = alpha * (alpha + 1) // 2  # free symbols in each of S1, S2
    bbar = kbar * alpha              # == 2 * half
    psi = _psi(p)
    e = np.zeros((nbar * alpha, bbar), dtype=np.uint8)
    for i in range(nbar):
        for col in range(alpha):
            row = i * alpha + col
            for a in range(alpha):  # S1 contribution: psi[i, a]*S1[a, col]
                e[row, _sym_index(alpha, a, col)] ^= psi[i, a]
            for a in range(alpha):  # S2: psi[i, alpha+a]*S2[a, col]
                e[row, half + _sym_index(alpha, a, col)] ^= psi[i, alpha + a]
    a_inv = gf256.gf_inv_matrix(e[: kbar * alpha])
    g = gf256.gf_matmul(e, a_inv)
    g.setflags(write=False)
    return g


@progcache.cached("msr")
def encode_rows(k: int, total: int, d: int) -> np.ndarray:
    """((total-k)*alpha, k*alpha) parity generator over the sub-shard
    space: apply to a (.., k*alpha, beta) stack of data sub-shards to
    produce every parity shard's sub-shards. Virtual rows/columns of
    the shortened parent are already dropped (zero data)."""
    p = params(k, total, d)
    g = _generator(k, total, d)
    rows = g[p.kbar * p.alpha:, p.j * p.alpha:]
    rows = np.ascontiguousarray(rows)
    rows.setflags(write=False)
    return rows


@progcache.cached("msr")
def helper_rows(k: int, total: int, d: int, failed: int) -> np.ndarray:
    """(1, alpha) helper-side combination for repairing `failed`: each
    helper applies this to its own alpha sub-shards and ships the single
    beta-sized result — THE bandwidth saving of the whole scheme."""
    p = params(k, total, d)
    if not 0 <= failed < total:
        raise ValueError(f"failed index {failed} outside [0, {total})")
    lam = p.lambdas[failed + p.j]
    phi = np.array([[gf256.gf_exp(lam, c) for c in range(p.alpha)]],
                   dtype=np.uint8)
    phi.setflags(write=False)
    return phi


def _psi_rep_inv(p: MsrParams, failed: int,
                 helpers: tuple[int, ...]) -> np.ndarray:
    """inv of the (dbar, dbar) helper-row submatrix of Psi; helper
    order: the j virtual nodes first, then `helpers` as given."""
    if len(helpers) != p.d:
        raise ValueError(f"need exactly d={p.d} helpers, got {len(helpers)}")
    if failed in helpers:
        raise ValueError(f"failed shard {failed} cannot be its own helper")
    if len(set(helpers)) != len(helpers):
        raise ValueError(f"duplicate helper in {helpers}")
    psi = _psi(p)
    parent = list(range(p.j)) + [h + p.j for h in helpers]
    return gf256.gf_inv_matrix(psi[np.asarray(parent)])


@progcache.cached("msr")
def repair_rows(k: int, total: int, d: int, failed: int,
                helpers: tuple[int, ...]) -> np.ndarray:
    """(alpha, d) repair matrix: apply to the (.., d, beta) stack of
    helper symbols (in `helpers` order) to rebuild the failed shard's
    alpha sub-shards. Cached per (geometry, failed_slot, helper-set) —
    the inverse is solved once, then reused for every stripe."""
    p = params(k, total, d)
    rep_inv = _psi_rep_inv(p, failed, helpers)
    # recv = Psi_rep [S1 phi_f; S2 phi_f]; symmetry turns the solved
    # columns back into the failed row: t_f = x1 + lambda_f^alpha * x2
    # (lambda^alpha is the Lambda-diagonal entry of psi_f = [phi | L phi])
    lam_a = gf256.gf_exp(p.lambdas[failed + p.j], p.alpha)
    r = np.zeros((p.alpha, 2 * p.alpha), dtype=np.uint8)
    for t in range(p.alpha):
        r[t, t] = 1
        r[t, p.alpha + t] = lam_a
    rows = gf256.gf_matmul(r, rep_inv)[:, p.j:]  # virtual symbols are 0
    rows = np.ascontiguousarray(rows)
    rows.setflags(write=False)
    return rows


@progcache.cached("msr")
def verify_rows(k: int, total: int, d: int, failed: int,
                helpers: tuple[int, ...], extra: int) -> np.ndarray:
    """(1, d) consistency row: applied to the same d helper symbols, it
    predicts what helper `extra` must have sent. A corrupted download
    breaks the prediction — the MSR analog of the conventional path's
    extra-survivor pre-writeback verification."""
    p = params(k, total, d)
    if extra == failed or extra in helpers:
        raise ValueError(f"extra helper {extra} overlaps the repair set")
    rep_inv = _psi_rep_inv(p, failed, helpers)
    psi = _psi(p)
    row = gf256.gf_matmul(psi[[extra + p.j]], rep_inv)[:, p.j:]
    row = np.ascontiguousarray(row)
    row.setflags(write=False)
    return row


@progcache.cached("msr")
def reconstruct_rows(k: int, total: int, d: int, present: tuple[int, ...],
                     wanted: tuple[int, ...]) -> np.ndarray:
    """(len(wanted)*alpha, k*alpha) conventional-decode matrix over the
    sub-shard space: recover the wanted shards from any k present full
    shards — the k-shard fallback path and the degraded-GET solve,
    playing the role reconstruct_rows plays for RS."""
    p = params(k, total, d)
    present = tuple(sorted(present))[:k]
    if len(present) < k:
        raise ValueError(f"need {k} present shards, have {len(present)}")
    g = _generator(k, total, d)
    alpha = p.alpha

    def node_rows(idx: list[int]) -> np.ndarray:
        sel = np.concatenate([np.arange(alpha) + (i + p.j) * alpha
                              for i in idx])
        return g[sel]

    # parent solve set: the j virtual nodes (rows 0..j*alpha of g) plus
    # the k present real nodes; square (kbar*alpha, kbar*alpha)
    sel = np.concatenate(
        [np.arange(p.j * alpha)]
        + [np.arange(alpha) + (i + p.j) * alpha for i in present])
    t_inv = gf256.gf_inv_matrix(g[sel.astype(np.intp)])
    w = node_rows(list(wanted))
    rows = gf256.gf_matmul(w, t_inv)[:, p.j * alpha:]  # virtual payload = 0
    rows = np.ascontiguousarray(rows)
    rows.setflags(write=False)
    return rows
