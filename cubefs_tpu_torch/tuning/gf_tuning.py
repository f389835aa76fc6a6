"""Verify-then-time sweeps of the GF(2^8) apply's kernel variants on the card.

The counterpart of the JAX package's tuning scripts
``benchmarks/pallas_tuning.py`` (round 1) and
``benchmarks/pallas_tuning2.py`` (round 2), which chose the layout of the
shipped Pallas kernel. Same shape: the recovery rows of RS(12+4) with
shards 1 and 7 lost, (2, 12), applied to survivors of shape (4, 12, 4 MiB)
drawn from ``np.random.default_rng(5)``. Variants:

round 1  base         A as shipped (``csrc/gf_apply.cu``, SWAR bit masks)
         bitmajor     C, int32 extraction (per byte), one launch per stripe
         bitmajor-u8  C, u8 extraction (SWAR on 32-bit words), per stripe
         flatgrid     C, u8 extraction, one launch with stripes in the grid
round 2  bm-loop      D, loop extraction (per byte), per stripe
         bm-bcast     D, bcast extraction (SWAR), per stripe
         bm-bool      D, bool extraction (compare with the plane's mask)
         bm-flat      D, bcast, one launch with stripes in the grid
         bm-nodot     D's probe: extraction and repack, no dot
         bm-noext     D's probe: the dot on faked bits, no extraction

Each variant runs at each tile of ``TILES``, columns of S per work item
of the bit-matrix kernel. The TPU sweep's 8192-131072 were VMEM block
sizes. Here the kernel is persistent: as many blocks as the SMs hold
walk the (stripe, tile) items, each block laying out W (1.5 KiB at R=2,
C=12) once, and a tile is one stage of a block's input ring (12 * tile
bytes, 3 stages) and of its two output stages (2 * tile bytes each):
41.5 KiB of shared memory at tile 1024, 161.5 KiB at 4096
(``gf_bitmajor.smem_bytes``). So the sweep runs from 16,384 items per
stripe of 256 columns, one group of 32 columns for each of the 8
consumer warps, to 1,024 items of 4,096 columns, 16 groups a warp.
A's block width is fixed (4,096 columns), so ``base`` repeats the same
kernel at every tile: its spread is the sweep's noise.

Order of each run, as in the reference: first ``verify_variant`` (a
random input two tiles wide, held against the plain version on the card);
a wrong output is recorded as ``{"error": "wrong output"}`` and never
timed; a variant that raises is recorded with its error and the sweep
goes on. Then CUDA-event time. GiB/s = B * N * S / time, the reference's
definition. ``BEST`` excludes the probes and every error.

    python -m cubefs_tpu_torch.tuning.gf_tuning [--round 1|2]

needs a CUDA device and raises without one. Importing this module touches
no device and builds nothing.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass

import numpy as np
import torch

from .. import device as devlib
from ..models import repair
from ..ops import gf_bitmajor, gf_cuda
from ..utils.benchtime import timed_ms

N, M, S, BR = 12, 4, 4 << 20, 4
BAD = (1, 7)
SEED = 5
TILES = (256, 512, 1024, 2048, 4096)
REPS = 10


@dataclass(frozen=True)
class Variant:
    name: str
    extract: str | None = None  # None: A as shipped
    grid: str = "stripe"
    probe: str | None = None

    def launcher(self, coeff: np.ndarray, tile: int):
        if self.extract is None:
            return lambda x: gf_cuda.gf_apply(coeff, x)
        if self.probe is None:
            return lambda x: gf_bitmajor.bitmajor_apply(
                coeff, x, tile=tile, extract=self.extract, grid=self.grid)
        return lambda x: gf_bitmajor.bitmajor_probe(
            coeff, x, tile=tile, extract=self.extract, grid=self.grid, probe=self.probe)


ROUNDS = {
    1: (Variant("base"),
        Variant("bitmajor", "int32"),
        Variant("bitmajor-u8", "u8"),
        Variant("flatgrid", "u8", "flat")),
    2: (Variant("bm-loop", "loop"),
        Variant("bm-bcast", "bcast"),
        Variant("bm-bool", "bool"),
        Variant("bm-flat", "bcast", "flat"),
        Variant("bm-nodot", "bcast", probe="nodot"),
        Variant("bm-noext", "bcast", probe="noext")),
}


def coefficients() -> np.ndarray:
    """The sweep's (2, 12) matrix: RS(12+4) recovery rows for shards 1, 7."""
    return np.ascontiguousarray(repair.make_plan(N, M, list(BAD)).rows, dtype=np.uint8)


def run_variant(variant: Variant, launch, coeff: np.ndarray, surv: torch.Tensor,
                tile: int, timer=None) -> dict:
    """Verify, then time (``timer(fn, reps)`` -> ms, CUDA events by
    default), one (variant, tile); never raises."""
    timer = timer or timed_ms
    rec = {"v": variant.name, "tile": tile}
    try:
        if not gf_bitmajor.verify_variant(coeff, launch, tile, seed=tile,
                                          probe=variant.probe, device=surv.device):
            return {**rec, "error": "wrong output"}
        ms = timer(lambda: launch(surv), REPS)
    except Exception as e:  # one failing variant must not void the others
        return {**rec, "error": f"{type(e).__name__}: {e}"[:200]}
    return {**rec, "gibs": surv.numel() / (ms / 1e3) / 2**30, "ms": ms}


def best(records: list[dict]) -> dict | None:
    """The fastest record that is neither a probe nor an error."""
    probes = {v.name for r in ROUNDS.values() for v in r if v.probe}
    ok = [r for r in records if "gibs" in r and r["v"] not in probes]
    return max(ok, key=lambda r: r["gibs"]) if ok else None


def _cuda_device(device) -> torch.device:
    dev = devlib.resolve(device)
    if dev.type != "cuda":
        raise RuntimeError("the GF tuning sweep times CUDA kernels; it needs a CUDA device")
    return dev


def sweep(round_: int, device=None, emit=None) -> list[dict]:
    """Run one round at the reference's shape on ``device`` (the current
    CUDA device by default) and return its records; ``emit`` gets each
    tile's group of records as it completes."""
    dev = _cuda_device(device)
    coeff = coefficients()
    surv = torch.from_numpy(
        np.random.default_rng(SEED).integers(0, 256, (BR, N, S), dtype=np.uint8)).to(dev)
    records = []
    for tile in TILES:
        group = [run_variant(v, v.launcher(coeff, tile), coeff, surv, tile)
                 for v in ROUNDS[round_]]
        records += group
        if emit is not None:
            emit(group)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--round", type=int, choices=sorted(ROUNDS), default=1)
    args = ap.parse_args(argv)
    records = sweep(args.round, emit=lambda g: print(json.dumps(g), flush=True))
    print("BEST:", json.dumps(best(records)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
