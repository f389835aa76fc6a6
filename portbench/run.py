"""Run one cell of the benchmark once and print one JSON line last.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for (``BENCHMARK.json``). Set-up (inputs from the seed, the program
built and warmed at the cell's shapes) is timed as ``setup_s``; then the
cell's closed loop runs ``--seconds``; then, with the program's state
freed, the kept answers are compared with the plain reference. With
``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a ``torch.profiler``
trace of the window, the program's counters and the harness's clock; an
untraced run traces the window too where one of its end-to-end metrics
comes from the device trace.
The numbers compared, each beside its limit, come last on standard
error and last in the line.

Exits 2 without the cards the cell needs, 3 if the process holds JAX or
the JAX package once the window has closed, 1 on any other failure;
none of these prints a result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "cubefs_tpu")


def forbidden_modules() -> list[str]:
    """Modules loaded whose top-level name is one the port must not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _delta(before: list, after: list) -> list:
    was = {(n, tuple(sorted(lab.items()))): v for n, lab, v in before}
    return [(n, lab, v - was.get((n, tuple(sorted(lab.items()))), 0.0)) for n, lab, v in after]


def holds(value, limit, kind: str) -> bool:
    return value <= limit if kind == "max" else value >= limit


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             params: dict | None = None, config: dict | None = None, control: bool = False,
             plant=None, t0: float | None = None) -> dict:
    """One run of cell ``name``: the result line's fields, and ``checks``
    (name, value, limit, kind). ``params`` and ``config`` override the
    cell's traffic parameters and configuration (the tests' small
    sizes); ``control`` puts the control in the program's codec's place;
    ``plant``, a context manager, is entered around the window alone (a
    fault under the timed path); set-up counts from ``t0`` (now, by
    default)."""
    import contextlib

    import torch

    from portbench import harness, readers, tracing

    t0 = time.perf_counter() if t0 is None else t0
    bench = harness.benchmark()
    spec = harness.workload(name)
    cell = harness.driver(spec["traffic"]).Cell(
        {**harness.config(spec["config"]), **(config or {})},
        {**spec["params"], **(params or {})}, seed, device, control)
    cuda = torch.device(device).type == "cuda"
    try:
        cell.setup()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t0
        before = cell.counters()
        # an untraced run traces the card too where an end-to-end metric
        # comes from the device trace
        wanted = harness.cell_metrics(bench, name, "per_layer" if trace else "end_to_end")
        prof = (tracing.start() if trace or any(m["source"] == "device_trace" for m in wanted)
                else None)
        with plant or contextlib.nullcontext():
            window = harness.closed_loop(cell.clients, cell.call, seconds,
                                         annotate=tracing.WINDOW if prof else "")
        summary = (tracing.summarize(tracing.stop(prof), [s for c in window.calls
                                                          for s in c.spans], window.start)
                   if prof else None)
        counters = _delta(before, cell.counters())
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        cell.release()
        if cuda:
            torch.cuda.empty_cache()
        checks = cell.check(window)
    finally:
        cell.close()
    run = readers.Run(window=window, trace=summary, counters=counters, setup_s=setup_s)
    metrics = {}
    for m in wanted:
        value = setup_s if m["name"] == "setup_s" else harness.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    out = {"correct": all(holds(v, lim, k) for _, v, lim, k in checks),
           "attempted": len(window.calls),
           "failed": sum(not c.ok for c in window.calls),
           "metrics": metrics, "device": dev}
    if trace and summary is not None:
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    out["checks"] = {n: {"value": v, "limit": lim, "holds": "<=" if k == "max" else ">="}
                     for n, v, lim, k in checks}
    errors = sorted({c.error for c in window.calls if not c.ok})
    return {"line": out, "checks": checks, "errors": errors, "window": window,
            "phases": dict(cell.phases)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    chips = next((w["chips"] for w in harness.benchmark()["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"portbench: {args.workload} is not a cell of BENCHMARK.json", file=sys.stderr)
        return 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    res = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t0=T0)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process holds {', '.join(bad)}", file=sys.stderr)
        return 3
    print(f"portbench: set-up phases (s): {json.dumps(res['phases'])}", file=sys.stderr)
    for err in res["errors"][:5]:
        print(f"portbench: a call failed: {err}", file=sys.stderr)
    for n, v, lim, k in res["checks"]:
        print(f"check {n} = {v} (limit {'<=' if k == 'max' else '>='} {lim})",
              file=sys.stderr)
    print(json.dumps(res["line"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
