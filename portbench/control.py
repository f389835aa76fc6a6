"""The readings the limits of ``correct`` are set from, at a cell's own
size on the card: sound runs of the program on many seeds (the lower
reading), the control (the plain reference with the configuration's
guarantee broken, in the program's codec's place) and each planted fault
(``traffic/faults.py``), all in one process, a short window each.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 --seconds 3 \\
        --modes sound,control,unchanged,half,altered

One JSON line per (mode, seed): the numbers compared and ``correct``.
Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench.run import run_cell


def readings(workload: str, seeds: list[int], seconds: float, modes: list[str],
             device="cuda", params=None, config=None):
    """Yield one record per (mode, seed)."""
    from portbench.traffic import faults

    for mode in modes:
        for seed in seeds:
            plant = faults.planted(mode) if mode in faults.FAULTS else None
            res = run_cell(workload, seed, seconds, False, device=device, params=params,
                           config=config, control=mode == "control", plant=plant)
            yield {"mode": mode, "seed": seed, "correct": res["line"]["correct"],
                   "attempted": res["line"]["attempted"],
                   "checks": {n: v for n, v, _, _ in res["checks"]},
                   "errors": res["errors"][:2]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--modes", default="sound,control,unchanged,half,altered")
    ap.add_argument("--params", default="{}",
                    help="JSON overrides of the cell's traffic parameters, such as "
                         '{"sample_every": 1} to keep every call of a slow control')
    args = ap.parse_args(argv)
    for rec in readings(args.workload, [int(s) for s in args.seeds.split(",")],
                        args.seconds, args.modes.split(","), params=json.loads(args.params)):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
