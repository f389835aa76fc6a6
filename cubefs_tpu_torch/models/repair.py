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
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import crc32_kernel, rs_kernel


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
