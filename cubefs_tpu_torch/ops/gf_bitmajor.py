"""The bit-matrix GF(2^8) apply on int8 tensor cores (``csrc/gf_bitmajor.cu``),
its tuning variants and probes, and their plain PyTorch versions.

The port's counterpart of the tuning kernels of the JAX package:
``benchmarks/pallas_tuning.py::_kernel_bitmajor`` (C) and
``benchmarks/pallas_tuning2.py::_mk_kernel`` (D). Both compute A's
function, a GF(2^8) matrix times shards, as the (8R, 8C) 0/1 matrix times
the plane-major bit planes of the shards, then ``& 1`` and a repack. D's
probes drop part of that work to show where the time goes:

- ``nodot``: the extraction, then rows 0, 8, 16, ... of the plane-major
  bits repacked, with no dot;
- ``noext``: the dot on faked bits, byte row 0 cast to int8 and broadcast
  to all 8C bit rows, with no extraction.

``bitmajor_apply`` and ``bitmajor_probe`` take CUDA tensors only: they
launch the kernel or raise. The plain versions run anywhere; the tests
use them on the CPU, and the card holds the kernels against them.

Variant names are the reference's. ``extract``: ``int32`` and ``loop``
(shift and mask each byte), ``u8`` and ``bcast`` (one shift and mask of a
32-bit word of four bytes), ``bool`` (compare with the plane's mask).
``grid``: ``stripe`` (one launch per stripe, the reference's vmap) or
``flat`` (one launch, stripes in the grid, the reference's flatgrid).
``tile``: columns of S per work item, a multiple of 32. The kernel is
persistent: its blocks walk the (stripe, tile) items, and each block's
input ring holds ``ring_stages`` tiles of the C shard rows.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import device as devlib
from . import _build, bitlin, rs_kernel

EXTRACTS = {"int32": 0, "loop": 0, "u8": 1, "bcast": 1, "bool": 2}
GRIDS = ("stripe", "flat")
PROBES = {"nodot": 1, "noext": 2}
DEFAULT_TILE = 1024
# Shared memory a block may opt in to on an H100 (232,448 bytes).
MAX_SMEM_BYTES = 227 << 10
MAX_STAGES = 3  # the input ring's depth where shared memory allows
OUT_STAGES = 2  # output stages: one is written out while the next item computes


def padded(r: int, c: int) -> tuple[int, int]:
    """(Rpad, Cpad): R rounded up to even and C to a multiple of 4, so that
    W's sides 8 * Rpad and 8 * Cpad are whole m16n8k32 tiles. The CUDA
    source pads by the same rule."""
    return r + r % 2, -(-c // 4) * 4


def _smem(r: int, c: int, tile: int, stages: int) -> int:
    rpad, cpad = padded(r, c)
    return 16 * MAX_STAGES + 64 * rpad * cpad + stages * cpad * tile + OUT_STAGES * rpad * tile


def ring_stages(r: int, c: int, tile: int) -> int:
    """Depth of the kernel's input ring: 3 (Cpad, tile) stages where they
    fit in ``MAX_SMEM_BYTES``, else 2. Mirrors ``ring_stages`` in the CUDA
    source."""
    return MAX_STAGES if _smem(r, c, tile, MAX_STAGES) <= MAX_SMEM_BYTES else 2


def smem_bytes(r: int, c: int, tile: int) -> int:
    """Dynamic shared memory of one block at ``ring_stages`` depth: the
    ring's mbarriers, W in fragment order, the input ring of raw (Cpad,
    tile) byte tiles and two (Rpad, tile) output stages. Over
    ``MAX_SMEM_BYTES`` the launch is refused. Mirrors ``smem_bytes`` in
    the CUDA source."""
    return _smem(r, c, tile, ring_stages(r, c, tile))


def blocks_per_sm(r: int, c: int, tile: int, extract: str = "bcast",
                  probe: str | None = None) -> int:
    """Blocks of one variant an SM of the current CUDA device holds at
    (r, c, tile), from its registers and shared memory (the CUDA
    occupancy calculator). The persistent grid of a launch is this times
    the SMs, capped at the work items (stripes x tiles)."""
    query = _build.library("gf_bitmajor").gf_bitmajor_blocks_per_sm
    query.argtypes = [ctypes.c_int] * 5
    query.restype = ctypes.c_int
    n = query(r, c, tile, EXTRACTS[extract], 0 if probe is None else PROBES[probe])
    if n < 0:
        raise RuntimeError(f"gf_bitmajor occupancy query failed: CUDA error {-n}")
    return n


def bitmajor_operand(coeff: np.ndarray) -> np.ndarray:
    """(R, C) GF(2^8) matrix -> the kernel's int8 W operand, (8 * Rpad,
    8 * Cpad) (``padded``). It holds the reference's plane-major
    ``w_to_bitmajor(gf_matrix_to_bits(coeff))`` (row k*R + r, column
    k*C + c) in the kernel's order:
    - row k*R + r at 8r + k: one output byte's 8 planes together, as the
      accumulator fragment spreads them over 8 lanes;
    - column k*C + c at 32 * (c // 4) + 4k + c % 4: each 32-deep K chunk
      is the 8 planes of one group of 4 shard rows, and each 4-byte group
      of K is one plane of those rows, as an s8 B-fragment register holds
      them.
    The padding is zero."""
    coeff = np.asarray(coeff, dtype=np.uint8)
    r, c = coeff.shape
    rpad, cpad = padded(r, c)
    k = np.arange(8)[:, None]
    rows = (8 * np.arange(r)[None, :] + k).ravel()  # at index k*R + r
    cj = np.arange(c)[None, :]
    cols = (32 * (cj // 4) + 4 * k + cj % 4).ravel()  # at index k*C + c
    out = np.zeros((8 * rpad, 8 * cpad), dtype=np.int8)
    out[np.ix_(rows, cols)] = bitlin.w_to_bitmajor(bitlin.gf_matrix_to_bits(coeff), r, c)
    return out


# -- plain versions ----------------------------------------------------------

def bitmajor_plain(w_bits: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """C, and D without a probe: (8R, 8C) plane-major 0/1 matrix
    (``rs_kernel.coeff_bits``) x (..., C, S) uint8 -> (..., R, S) uint8."""
    return rs_kernel.gf_apply_bits(w_bits, x)


def _by_slices(x: torch.Tensor, r: int, fn) -> torch.Tensor:
    """Apply fn((C, cols) uint8) -> (r, cols) uint8 stripe by stripe over
    slices of columns, which bounds the intermediates' memory."""
    *lead, c, s = x.shape
    flat = x.reshape(-1, c, s)
    out = torch.empty((flat.shape[0], r, s), dtype=torch.uint8, device=x.device)
    for i in range(flat.shape[0]):
        for j in range(0, s, rs_kernel._PLAIN_COLS):
            out[i, :, j : j + rs_kernel._PLAIN_COLS] = fn(flat[i, :, j : j + rs_kernel._PLAIN_COLS])
    return out.reshape(*lead, r, s)


def probe_nodot_plain(x: torch.Tensor, r: int) -> torch.Tensor:
    """D's ``nodot``: (..., C, S) uint8 -> (..., r, S) uint8 whose byte
    (i, s) has bit k = row 8i + k of the plane-major bits (row k'*C + c
    holds bit k' of x[c]). Needs r <= C, as the reference's slice does."""
    c = x.shape[-2]
    if r > c:
        raise ValueError(f"nodot repacks rows 0..8r of 8C bit rows; r={r} > C={c}")
    sh = torch.arange(8, dtype=torch.int32, device=x.device)[:, None]

    def one(xs):
        bits = rs_kernel.unpack_bits(xs)[: 8 * r].reshape(r, 8, -1).to(torch.int32)
        return (bits << sh).sum(1).to(torch.uint8)

    return _by_slices(x, r, one)


def probe_noext_plain(w_bits: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """D's ``noext``: every one of the 8C bit rows is byte row 0 cast to
    int8 with wraparound (200 -> -56), dotted with the (8R, 8C) matrix,
    ``& 1`` on the signed sums, repacked -> (..., R, S) uint8. The dot of
    a broadcast row is the row sums of W times that row, exact in int32
    (|sum| <= 8C * 128)."""
    rowsum = w_bits.to(device=x.device, dtype=torch.int32).sum(1)[:, None]

    def one(xs):
        x0 = xs[0].view(torch.int8).to(torch.int32)[None, :]
        return rs_kernel.pack_bits((rowsum * x0) & 1)

    return _by_slices(x, w_bits.shape[0] // 8, one)


def plain(coeff: np.ndarray, x: torch.Tensor, probe: str | None = None) -> torch.Tensor:
    """The plain version of a variant: the GF apply, or a probe's function."""
    coeff = np.ascontiguousarray(coeff, dtype=np.uint8)
    w = torch.from_numpy(rs_kernel.coeff_bits(coeff))
    if probe is None:
        return bitmajor_plain(w, x)
    if probe == "nodot":
        return probe_nodot_plain(x, coeff.shape[0])
    if probe == "noext":
        return probe_noext_plain(w, x)
    raise ValueError(f"unknown probe {probe!r}; expected one of {sorted(PROBES)}")


# -- the kernels -------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def _device_operand(coeff_bytes: bytes, r: int, c: int, device: torch.device) -> torch.Tensor:
    coeff = np.frombuffer(coeff_bytes, dtype=np.uint8).reshape(r, c)
    return torch.from_numpy(bitmajor_operand(coeff)).to(device)


def _launch(kernel: str, coeff: np.ndarray, shards: torch.Tensor, tile: int, extract: str,
            grid: str, probe: str | None) -> torch.Tensor:
    coeff = np.ascontiguousarray(coeff, dtype=np.uint8)
    if coeff.ndim != 2 or shards.dim() < 2 or shards.shape[-2] != coeff.shape[1]:
        raise ValueError(f"coefficient matrix {coeff.shape} does not apply to shards "
                         f"{tuple(shards.shape)}")
    if shards.dtype != torch.uint8:
        raise ValueError(f"shards must be uint8, got {shards.dtype}")
    if extract not in EXTRACTS:
        raise ValueError(f"unknown extract {extract!r}; expected one of {sorted(EXTRACTS)}")
    if grid not in GRIDS:
        raise ValueError(f"unknown grid {grid!r}; expected one of {GRIDS}")
    r, c = coeff.shape
    if probe == "nodot" and r > c:
        raise ValueError(f"nodot needs R <= C, got {r}x{c}")
    if tile < 32 or tile % 32:
        raise ValueError(f"tile must be a positive multiple of 32 columns, got {tile}")
    if smem_bytes(r, c, tile) > MAX_SMEM_BYTES:
        raise ValueError(f"{r}x{c} at tile {tile} needs {smem_bytes(r, c, tile)} bytes of "
                         f"shared memory, over {MAX_SMEM_BYTES}")
    if not shards.is_cuda:
        raise ValueError(f"{kernel} launches a CUDA kernel; got a tensor on {shards.device}")
    *lead, _, s = shards.shape
    x = shards.reshape(-1, c, s)
    if x.stride(-1) != 1 or x.stride(-2) != s:
        x = x.contiguous()  # the kernel wants each stripe's rows back to back
    b = x.shape[0]
    out = torch.empty((b, r, s), dtype=torch.uint8, device=shards.device)
    if b and r and s:
        w = _device_operand(coeff.tobytes(), r, c, shards.device)
        extra = (EXTRACTS[extract],) if probe is None else (EXTRACTS[extract], PROBES[probe])
        with torch.cuda.device(shards.device):
            stream = torch.cuda.current_stream().cuda_stream
            step = 1 if grid == "stripe" else b
            for i in range(0, b, step):
                n = min(step, b - i)
                _build.launch(kernel, x[i].data_ptr(), x.stride(0), out[i].data_ptr(),
                              w.data_ptr(), r, c, s, n, tile, *extra, stream)
    return out.reshape(*lead, r, s)


def bitmajor_apply(coeff: np.ndarray, shards: torch.Tensor, *, tile: int = DEFAULT_TILE,
                   extract: str = "bcast", grid: str = "flat") -> torch.Tensor:
    """Kernel C (and D without a probe): (R, C) GF(2^8) coefficients x
    (..., C, S) uint8 CUDA shards -> (..., R, S) uint8, for any S. The
    coefficients are a runtime operand: a new matrix compiles nothing."""
    return _launch("gf_bitmajor", coeff, shards, tile, extract, grid, None)


def bitmajor_probe(coeff: np.ndarray, shards: torch.Tensor, *, probe: str,
                   tile: int = DEFAULT_TILE, extract: str = "bcast",
                   grid: str = "stripe") -> torch.Tensor:
    """Kernel D's probes (``nodot``, ``noext``) on CUDA shards; each
    computes its plain version's function (``plain(coeff, x, probe)``)."""
    if probe not in PROBES:
        raise ValueError(f"unknown probe {probe!r}; expected one of {sorted(PROBES)}")
    return _launch("gf_bitmajor_probe", coeff, shards, tile, extract, grid, probe)


def verify_variant(coeff: np.ndarray, launch, tile: int, seed: int = 0, *,
                   probe: str | None = None, device=None) -> bool:
    """Gate of one variant at one tile, the counterpart of
    ``pallas_gf.verify_tile``: ``launch`` maps (B, C, S) shards to its
    output; it runs on random shards of 2 stripes, two tiles wide (so the
    kernel runs more than one block per stripe), and its output is held
    against the plain version on the same device, never against a kernel."""
    coeff = np.ascontiguousarray(coeff, dtype=np.uint8)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(0, 256, (2, coeff.shape[1], 2 * tile), dtype=np.uint8))
    x = x.to(devlib.resolve(device))
    return bool(torch.equal(launch(x), plain(coeff, x, probe)))
