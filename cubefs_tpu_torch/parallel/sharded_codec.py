"""The codec math sharded over the (dp, tp, sp) mesh of ``parallel/mesh.py``.

The port's counterpart of ``cubefs_tpu/parallel/sharded_codec.py``. Each
function takes this rank's block and returns this rank's block of the
result; every rank runs the port's kernels on its own block (on a CUDA
tensor: kernel A, ``csrc/gf_apply.cu``, and kernel B,
``csrc/crc32_blocks.cu``) and the collectives go over the sub-group of
one axis:

  * GF(2^8) matrix apply (encode / reconstruct): the contraction runs
    over the shard axis N, split over ``tp``. Each rank applies its own
    columns of the coefficient matrix to its shards; the byte partials
    XOR-combine over tp as an all-gather followed by a XOR (no backend
    reduces by XOR: the reference sums int32 bit partials and takes & 1,
    and the parity of a sum is the XOR of the parities). The byte axis
    splits over ``sp`` with no communication (GF math is byte-local).

  * CRC32: byte segments split over ``sp``. Each rank takes the zlib CRC
    of its segment; the ranks all-gather the (rows,) values over sp and
    fold them in zlib order on the device: segment d's linear part moves
    past the bytes after it by the zero-extension matrix
    A^((sp-1-d) * local_len), the parts XOR together and crc32(0^total)
    closes the sum.

Shapes are checked before any collective, so a bad shape raises
ValueError on every rank alike instead of leaving the others waiting.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from ..ops import crc32_kernel, gf256, rs_kernel
from .mesh import Mesh


def _xor_combine(mesh: Mesh, axis: str, part: torch.Tensor) -> torch.Tensor:
    """XOR of ``part`` over the ranks of one mesh axis, on every one."""
    group = mesh.groups[axis]
    if group is None:
        return part
    parts = [torch.empty_like(part) for _ in range(mesh.dims[axis])]
    dist.all_gather(parts, part, group=group)
    out = parts[0]
    for p in parts[1:]:
        out ^= p
    return out


def local_columns(mesh: Mesh, coeff: np.ndarray, n_in: int) -> np.ndarray:
    """This rank's columns of an (R, n_in) coefficient matrix: the ones
    that take its tp slice of the shards."""
    coeff = np.asarray(coeff, dtype=np.uint8)
    tp = mesh.dims["tp"]
    if n_in % tp:
        raise ValueError(f"shard axis {n_in} not divisible by tp={tp}")
    if coeff.ndim != 2 or coeff.shape[1] != n_in:
        raise ValueError(f"coefficient matrix {coeff.shape} does not take {n_in} shards")
    per = n_in // tp
    t = mesh.coords["tp"]
    return np.ascontiguousarray(coeff[:, t * per:(t + 1) * per])


def gf_matrix_apply_sharded(mesh: Mesh, coeff: np.ndarray, n_in: int):
    """Build fn: local (B/dp, n_in/tp, S/sp) uint8 -> (B/dp, R, S/sp): this
    rank's block of the input sharded (dp, tp, sp), its block of the
    output (dp, None, sp). Every rank of a tp group holds the full result
    rows for its byte slice, like every blobnode holding the full parity
    it must write."""
    local_coeff = local_columns(mesh, coeff, n_in)
    per = local_coeff.shape[1]

    def fn(local: torch.Tensor) -> torch.Tensor:
        if local.dim() != 3 or local.shape[1] != per:
            raise ValueError(f"local block must be (B/dp, {per}, S/sp), got "
                             f"{tuple(local.shape)}")
        return _xor_combine(mesh, "tp", rs_kernel.gf_matrix_apply(local_coeff, local))

    return fn


def encode_sharded(mesh: Mesh, n_data: int, n_parity: int):
    """local data (B/dp, N/tp, S/sp) -> local parity (B/dp, M, S/sp)."""
    return gf_matrix_apply_sharded(mesh, gf256.parity_matrix(n_data, n_parity), n_data)


@functools.lru_cache(maxsize=64)
def _fold(sp: int, local_len: int, device: torch.device):
    """The fold's device constants: the (sp, 32, 32) zero-extension
    matrices (float 0/1: the product sums stay exact), crc32(0^local_len)
    and crc32(0^(sp*local_len))."""
    shifts = np.stack([crc32_kernel.zeros_matrix((sp - 1 - d) * local_len) for d in range(sp)])
    return (torch.from_numpy(shifts.astype(np.float32)).to(device),
            crc32_kernel.crc32_zeros(local_len), crc32_kernel.crc32_zeros(sp * local_len))


def crc32_sharded(mesh: Mesh, seg_len_total: int):
    """Build fn: local (rows, seg_len_total/sp) uint8 -> (rows,) int64
    holding the unsigned zlib CRC32 of each whole row (the rows are this
    rank's dp slice; every rank of an sp group gets the same values)."""
    sp = mesh.dims["sp"]
    if seg_len_total % sp:
        raise ValueError(f"segment {seg_len_total} not divisible by sp={sp}")
    local_len = seg_len_total // sp

    def fn(local: torch.Tensor) -> torch.Tensor:
        if local.dim() != 2 or local.shape[1] != local_len:
            raise ValueError(f"local segments must be (rows, {local_len}), got "
                             f"{tuple(local.shape)}")
        crcs = crc32_kernel.crc32_blocks(local)
        if mesh.groups["sp"] is None:
            return crcs
        parts = [torch.empty_like(crcs) for _ in range(sp)]
        dist.all_gather(parts, crcs, group=mesh.groups["sp"])
        shifts, zeros_local, zeros_total = _fold(sp, local_len, local.device)
        linear = torch.stack(parts) ^ zeros_local  # (sp, rows) raw CRC per segment
        bits = (linear[..., None] >> torch.arange(32, device=local.device)) & 1
        folded = torch.einsum("dij,drj->ri", shifts, bits.float()).to(torch.int64) & 1
        return crc32_kernel.pack_crc_bits(folded) ^ zeros_total

    return fn
