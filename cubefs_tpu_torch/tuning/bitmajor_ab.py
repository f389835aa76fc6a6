"""A/B of two trees' bit-matrix kernels (C and D, ``csrc/gf_bitmajor.cu``) on one card.

Each tree's package is imported in a process of its own, so each builds
and launches its own kernel through its own wrappers; both get the same
inputs from the same seeds. Runs go parent, new, new, parent, so drift
on the card shows as a difference between the two runs of one tree.
Every case is first held against its plain version (``torch.equal``),
then timed as the kernel's device time from the profiler's CUDA trace
(``benchtime.device_ms``, mean of 10 after a warm-up).

Cases: the tuning shape (``tuning/gf_tuning.py``: the (2, 12) recovery
rows on (4, 12, 4 MiB) shards) for the bcast/flat apply at every tile of
``TILES``, and at tile 1024 the nodot and noext probes (bcast/flat) and
nodot per stripe; a random 36 x 36 matrix on (1, 36, 4 MiB) at tile 1024;
and at tile 1024 the (4, 12) repair-step rows on 2 stripes of 4 MiB with
16-byte aligned rows, with S = 4 MiB + 123 (rows not aligned) and with a
stripe stride of 12 * 4 MiB + 5 (stripes not aligned), the last two
through the producer's own loads instead of bulk copies.

    python -m cubefs_tpu_torch.tuning.bitmajor_ab --parent DIR [--out FILE]

DIR is the root of the other tree (for example ``git archive <commit>
cubefs_tpu_torch`` unpacked into a directory that git ignores). Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

TILES = (256, 512, 1024, 2048, 4096)
ORDER = ("parent", "new", "new", "parent")
SEED = 5
MIB = 1 << 20
HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))


def cases():
    """(case, probe, extract, grid, tile) of one run."""
    out = [("tuning_rows_2x12_B4", None, "bcast", "flat", t) for t in TILES]
    out += [("tuning_rows_2x12_B4", "nodot", "bcast", "flat", 1024),
            ("tuning_rows_2x12_B4", "noext", "bcast", "flat", 1024),
            ("tuning_rows_2x12_B4", "nodot", "bcast", "stripe", 1024),
            ("random_36x36_B1", None, "bcast", "flat", 1024)]
    out += [(case, None, "bcast", "flat", 1024) for case in
            ("step_rows_4x12_B2", "step_rows_4x12_ragged_B2", "step_rows_4x12_stride_not_16_B2")]
    return out


def measure(root: str) -> dict:
    """Import the package of the tree at ``root`` and time every case."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from cubefs_tpu_torch.models import repair
    from cubefs_tpu_torch.ops import gf_bitmajor
    from cubefs_tpu_torch.utils.benchtime import device_ms

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def rand(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)

    plan = repair.make_plan(12, 4, [1, 7])
    step_rows = np.ascontiguousarray(repair._step_rows(plan), dtype=np.uint8)
    stride = 12 * 4 * MIB + 5
    shapes = {
        "tuning_rows_2x12_B4": (np.ascontiguousarray(plan.rows, dtype=np.uint8),
                                rand(4, 12, 4 * MIB)),
        "random_36x36_B1": (np.random.default_rng(36).integers(0, 256, (36, 36), dtype=np.uint8),
                            rand(1, 36, 4 * MIB)),
        "step_rows_4x12_B2": (step_rows, rand(2, 12, 4 * MIB)),
        "step_rows_4x12_ragged_B2": (step_rows, rand(2, 12, 4 * MIB + 123)),
        "step_rows_4x12_stride_not_16_B2": (
            step_rows, rand(stride + 12 * 4 * MIB).as_strided((2, 12, 4 * MIB),
                                                              (stride, 4 * MIB, 1))),
    }
    results = []
    for case, probe, extract, grid, tile in cases():
        coeff, x = shapes[case]
        kw = {"tile": tile, "extract": extract, "grid": grid}
        if probe is None:
            def fn():
                return gf_bitmajor.bitmajor_apply(coeff, x, **kw)
        else:
            def fn():
                return gf_bitmajor.bitmajor_probe(coeff, x, probe=probe, **kw)
        equal = bool(torch.equal(fn(), gf_bitmajor.plain(coeff, x, probe)))
        results.append({"case": case, "probe": probe, "extract": extract, "grid": grid,
                        "tile": tile, "equal": equal,
                        "device_ms": device_ms(fn, 10, "gf_bitmajor")})
    return {"root": root, "device": torch.cuda.get_device_name(0), "cases": results}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of the tree to compare with")
    ap.add_argument("--out", help="also write the record to this file")
    ap.add_argument("--measure", metavar="ROOT", help=argparse.SUPPRESS)  # one run, in its own process
    args = ap.parse_args(argv)
    if args.measure:
        print(json.dumps(measure(os.path.abspath(args.measure))), flush=True)
        return 0
    if not args.parent:
        ap.error("--parent DIR is needed")
    roots = {"parent": os.path.abspath(args.parent), "new": ROOT}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    runs = []
    for tree in ORDER:
        proc = subprocess.run([sys.executable, HERE, "--measure", roots[tree]], cwd=roots[tree],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode:
            raise RuntimeError(f"run of {roots[tree]} failed:\n{proc.stdout[-4000:]}\n"
                               f"{proc.stderr[-4000:]}")
        runs.append({"tree": tree, **json.loads(proc.stdout.strip().splitlines()[-1])})
    summary = []
    for i, c in enumerate(cases()):
        row = {k: v for k, v in zip(("case", "probe", "extract", "grid", "tile"), c)}
        for tree in ("parent", "new"):
            times = [r["cases"][i]["device_ms"] for r in runs if r["tree"] == tree]
            row[f"{tree}_ms"] = times
            row[f"{tree}_median_ms"] = statistics.median(times)
        row["equal"] = all(r["cases"][i]["equal"] for r in runs)
        summary.append(row)
    record = {"card": card, "order": ORDER, "summary": summary, "runs": runs}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    for row in summary:
        print(json.dumps(row), flush=True)
    print(card, flush=True)
    return 0 if all(row["equal"] for row in summary) else 1


if __name__ == "__main__":
    sys.exit(main())
