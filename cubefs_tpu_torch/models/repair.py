"""Flagship pipeline: the blobnode repair-worker step on the card.

The compute of the reference's disk-repair hot path
(blobstore/blobnode/worker_slice_recover.go RecoverShards ->
engine.Reconstruct, then CRC checks of the rebuilt shards) over a BATCH
of stripes, as the JAX package's ``cubefs_tpu/models/repair.py`` does:

    surviving shards --> GF reconstruct ------------> recovered shards
                     +-> re-derive extra survivors --> ok?
    recovered shards --> batched CRC32 --> shard CRCs

Both GF legs read the same first n_data survivors, so they run as ONE
apply of the stacked coefficient rows: the survivors leave device memory
once per step.

``sharded_repair_step`` runs the step over a (dp, tp, sp) process mesh
(``parallel/``): stripes over dp, shards over tp, bytes over sp; the
reconstruct XOR-combines over tp and the CRC folds over sp.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import crc32_kernel, rs_kernel
from ..parallel import sharded_codec
from ..parallel.mesh import Mesh


@dataclass(frozen=True)
class RepairPlan:
    """Static description of one erasure pattern for a codemode: which
    shard indices survive (first n_data used) and which to recover."""

    n_data: int
    n_total: int
    present: tuple[int, ...]
    wanted: tuple[int, ...]

    @property
    def rows(self) -> np.ndarray:
        return rs_kernel.reconstruct_rows(
            self.n_data, self.n_total, list(self.present), list(self.wanted))


def make_plan(n_data: int, n_parity: int, bad: list[int]) -> RepairPlan:
    total = n_data + n_parity
    present = tuple(i for i in range(total) if i not in set(bad))
    return RepairPlan(n_data, total, present, tuple(sorted(set(bad))))


@functools.lru_cache(maxsize=256)
def _step_rows(plan: RepairPlan) -> np.ndarray:
    """Recovery rows stacked over the rows that re-derive the extra
    survivors (present beyond the first n_data) from the same inputs.
    Re-deriving a shard inside the solving set would be a tautology; the
    extras are an independent view of the data."""
    return rs_kernel.reconstruct_rows(
        plan.n_data, plan.n_total, list(plan.present),
        list(plan.wanted) + list(plan.present[plan.n_data:]))


def repair_step(plan: RepairPlan, surviving: torch.Tensor):
    """Fused repair: reconstruct + integrity check + CRC, on the device
    that holds ``surviving``.

    surviving: (B, P, S) uint8, ALL present shards in ascending
    shard-index order (P = len(plan.present) >= n_data).

    Returns (recovered (B, W, S) uint8, crcs (B, W) int64 holding the
    unsigned CRC32 of each recovered shard, ok (B,) bool). ok compares
    the extra survivors with their reconstruction from the first n_data:
    the worker's check before writeback (True when no extras were read).
    ``recovered`` is a view of the step's one GF output, and the CRC reads
    it in place.
    """
    if surviving.dim() != 3 or surviving.shape[1] != len(plan.present):
        raise ValueError(f"surviving must be (B, {len(plan.present)}, S), got "
                         f"{tuple(surviving.shape)}")
    n, w = plan.n_data, len(plan.wanted)
    out = rs_kernel.gf_matrix_apply(_step_rows(plan), surviving[:, :n, :])
    recovered = out[:, :w]
    ok = (out[:, w:] == surviving[:, n:, :]).flatten(1).all(dim=1)
    return recovered, crc32_kernel.crc32_blocks(recovered), ok


def sharded_repair_step(mesh: Mesh, plan: RepairPlan, local_surviving: torch.Tensor):
    """Mesh-sharded repair: this rank's (B/dp, n_data/tp, S/sp) block of
    the survivors in, its blocks of the results out.

    The contract differs from repair_step's, as the reference's does: the
    survivors are exactly the first n_data present shards (n_data must
    divide by the mesh's tp), and there is NO integrity output (the
    extras do not shard evenly over tp; check them with repair_step).
    Returns (recovered (B/dp, W, S/sp) uint8, crcs (B/dp, W) int64
    holding the unsigned CRC32 of each whole recovered shard); every tp
    rank holds the same blocks.
    """
    tp, sp = mesh.dims["tp"], mesh.dims["sp"]
    if local_surviving.dim() != 3 or local_surviving.shape[1] * tp != plan.n_data:
        raise ValueError(f"sharded repair takes exactly n_data={plan.n_data} shards "
                         f"({plan.n_data}/tp={tp} a rank), got a block of "
                         f"{tuple(local_surviving.shape)} (drop the extra survivors)")
    b, _, s = local_surviving.shape
    apply, crc = _sharded_step_fns(mesh, plan, s * sp)
    recovered = apply(local_surviving)
    w = recovered.shape[1]
    return recovered, crc(recovered.reshape(b * w, s)).reshape(b, w)


@functools.lru_cache(maxsize=64)
def _sharded_step_fns(mesh: Mesh, plan: RepairPlan, seg_len: int):
    """The sharded step's apply and CRC functions for one mesh, plan and
    shard length: the row solve and the rank's columns, built once."""
    return (sharded_codec.gf_matrix_apply_sharded(mesh, plan.rows, plan.n_data),
            sharded_codec.crc32_sharded(mesh, seg_len))
