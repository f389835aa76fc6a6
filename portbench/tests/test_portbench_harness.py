"""BENCHMARK.json against the benchmark's contract, the files it names,
the trace reduction, and what the harness's processes import."""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys

from portbench import harness, tracing

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
FORBIDDEN = {"jax", "jaxlib", "flax", "cubefs_tpu"}


def test_benchmark_json_names_files_that_exist():
    b = harness.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.fullmatch(c["name"])
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    configs = {c["name"] for c in b["configs"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.fullmatch(w["name"]) and len(w["why"]) <= 200
        spec = harness.workload(w["name"])
        assert spec["config"] == w["config"] in configs and spec["traffic"] == w["traffic"]
        assert (harness.PKG / "traffic" / f"{spec['traffic']}.py").exists()
    assert {w["config"] for w in b["workloads"]} == configs
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"] != "setup_s":
            assert (harness.PKG / "metrics" / f"{m['name']}.py").exists(), m["name"]
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
    for cell in cells:  # every cell: setup_s, another end-to-end metric, a per-layer one
        assert len(harness.cell_metrics(b, cell, "end_to_end")) >= 2
        assert harness.cell_metrics(b, cell, "per_layer")
    assert len(json.dumps(b)) < 64 << 10


def _kept(seed: int, calls: int, every: int = 3, most: int = 2) -> list[int]:
    sampler = harness.Sampler(seed, 1, every, most)
    recs = [harness.Call(client=0, start=0.0) for _ in range(calls)]
    for k, rec in enumerate(recs):
        if sampler.keep(0, k, rec):
            rec.sample = k
    return sorted(r.sample for r in recs if r.sample is not None)


def test_the_checked_calls_are_drawn_over_the_whole_window():
    """Each client keeps ``most`` answers, the same for one seed, drawn
    from every candidate call of the window, its last ones as often as
    its first; dropped answers are freed."""
    assert _kept(2**31 + 5, 3000) == _kept(2**31 + 5, 3000)
    runs = [_kept(seed, 3000) for seed in range(2**31, 2**31 + 200)]
    assert all(len(k) == 2 and k[0] % 3 == k[1] % 3 for k in runs)
    kept = [k for ks in runs for k in ks]
    assert 1200 < statistics.mean(kept) < 1800
    assert sum(k >= 2000 for k in kept) > len(kept) // 5
    assert _kept(2**31, 1) in ([], [0])


def test_the_trace_reduction_on_a_known_timeline():
    ev = [{"ph": "X", "name": "pb.window", "cat": "user_annotation", "ts": 0, "dur": 1000},
          {"ph": "X", "name": "Memcpy HtoD (Pinned -> Device)", "cat": "gpu_memcpy",
           "ts": 100, "dur": 200, "args": {"bytes": 4096}},
          {"ph": "X", "name": "Memcpy DtoD (Device -> Device)", "cat": "gpu_memcpy",
           "ts": 150, "dur": 10, "args": {"bytes": 8192}},
          {"ph": "X", "name": "gf_apply_kernel", "cat": "kernel", "ts": 250, "dur": 100},
          {"ph": "X", "name": "Memcpy DtoH (Device -> Pinned)", "cat": "gpu_memcpy",
           "ts": 900, "dur": 200, "args": {"bytes": 1024}},
          {"ph": "X", "name": "Memcpy HtoD (Pinned -> Device)", "cat": "gpu_memcpy",
           "ts": 1200, "dur": 10, "args": {"bytes": 2048}}]
    # host phases on the host clock, which read 5.0 s at the window's start
    s = tracing.summarize(ev, [("pb.fill", 5.000350, 5.000850), ("pb.encode", 5.0, 5.0001)],
                          start=5.0)
    assert s["window_s"] == 1000e-6
    assert abs(s["busy_s"] - 350e-6) < 1e-12  # 100-350 and 900-1000
    assert abs(s["copy_s"] - 300e-6) < 1e-12
    assert abs(s["kernel_s"] - 100e-6) < 1e-12
    assert s["copy_bytes"] == 4096 + 1024  # host-device copies in the window, whole
    assert s["idle_gaps"][0][0] == "pb.fill"
    assert abs(s["idle_gaps"][0][1] - 550e-6) < 1e-12
    assert s["device_ops"][0][0] == "Memcpy HtoD (Pinned -> Device)"


def test_no_module_the_harness_runs_is_jax_or_the_jax_package():
    """Every module of portbench imported in a fresh process: no top-level
    name jax, jaxlib, flax or cubefs_tpu (compared whole: the port's
    cubefs_tpu_torch starts with it), and the reference, the readers and
    the trace reduction load nothing of the port."""
    code = (
        "import sys, importlib, pathlib\n"
        "pure = ['portbench.reference.gf256', 'portbench.reference.codes',"
        " 'portbench.readers', 'portbench.roofline', 'portbench.tracing', 'portbench.harness']\n"
        "for m in pure: importlib.import_module(m)\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "assert 'cubefs_tpu_torch' not in top, sorted(top)\n"
        "from portbench import harness\n"
        "for p in sorted((harness.PKG).rglob('*.py')):\n"
        "    rel = p.relative_to(harness.ROOT).with_suffix('')\n"
        "    if 'tests' in rel.parts or p.parent.name == 'metrics':\n"
        "        continue\n"
        "    importlib.import_module('.'.join(rel.parts))\n"
        "for p in sorted((harness.PKG / 'metrics').glob('*.py')):\n"
        "    harness.metric_reader(p.stem)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "cubefs_tpu_torch" in top and "portbench" in top
    assert not top & FORBIDDEN, top & FORBIDDEN
