"""Cold-tier capacity A/B: 3x-replicated hot extents vs EC(6,3) blob
storage, plus the door-off FSM-digest identity check.

Leg A writes a cold dataset onto the fs plane and measures the physical
bytes the datanodes hold (3-way chain replication -> ~3.0x logical).
Leg B runs the same dataset through the lifecycle tiering state machine
(fs/tiering.py) into an EC6P3 blob volume, drives the metanode free
scan so the released hot extents are physically deleted, and measures
blobnode bytes (~1.5x logical plus stripe padding).

The digest legs prove the `CUBEFS_TIERING` door is inert when closed:
the same workload against a plain FileSystem and against one built with
`CUBEFS_TIERING=0` + a blob client must export byte-identical metanode
FSM state (timestamps normalized — they are wall-clock, not FSM
decisions).

  python -m cubefs_tpu_torch.tool.tier_ab [--device cuda] [--out FILE]

The port's copy of ``cubefs_tpu/tool/tier_ab.py``. The blob plane's codec
runs on ``--device`` (the card unless ``cpu``) on engine ``cuda``: kernel
A encodes each tier PUT. The record goes to ``--out`` only when given.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import tempfile
import time

import numpy as np

FILES = 8
FILE_SIZE = 192 << 10  # > TINY_THRESHOLD: rides real replicated extents


def _build(tmp: str, tag: str, *, with_blob: bool, door: str | None,
           device=None):
    """One in-process cluster; returns everything a leg needs. The blob
    plane's codec runs on ``device`` (None: the card)."""
    from ..blob.access import AccessConfig, AccessHandler
    from ..blob.blobnode import BlobNode
    from ..blob.clustermgr import ClusterMgr
    from ..fs.client import FileSystem
    from ..fs.datanode import DataNode
    from ..fs.master import Master
    from ..fs.metanode import MetaNode
    from ..utils import rpc
    from ..utils.rpc import NodePool

    pool = NodePool()
    master = Master(pool)
    pool.bind("master", master)
    metas, datas, data_dirs = [], [], []
    for i in range(2):
        node = MetaNode(i, addr=f"meta{i}", node_pool=pool)
        pool.bind(f"meta{i}", node)
        master.register_metanode(f"meta{i}")
        metas.append(node)
    for i in range(3):
        d = os.path.join(tmp, tag, f"d{i}")
        node = DataNode(i, d, f"data{i}", pool)
        pool.bind(f"data{i}", node)
        master.register_datanode(f"data{i}")
        datas.append(node)
        data_dirs.append(d)
    view = master.create_volume(f"tier{tag}", mp_count=1, dp_count=2)

    access = None
    blob_dirs = []
    if with_blob:
        cm = ClusterMgr(allow_colocated_units=True)
        blob_dirs = [os.path.join(tmp, tag, f"bd{i}") for i in range(9)]
        bn = BlobNode(0, blob_dirs, rpc.Client(cm), addr="bn0",
                      device=device, engine="cuda")
        bn.register()
        bn.send_heartbeat()
        pool.bind("bn0", bn)
        access = AccessHandler(rpc.Client(cm), pool,
                               AccessConfig(blob_size=64 << 10, engine="cuda",
                                            device=device))

    if door is None:
        fs = FileSystem(view, pool)
    else:
        os.environ["CUBEFS_TIERING"] = door
        try:
            fs = FileSystem(view, pool, blob_client=access)
        finally:
            os.environ.pop("CUBEFS_TIERING", None)
    return {"fs": fs, "pool": pool, "view": view, "metas": metas,
            "datas": datas, "data_dirs": data_dirs,
            "blob_dirs": blob_dirs, "access": access}


def _teardown(c) -> None:
    for n in c["metas"]:
        n.stop()
    for d in c["datas"]:
        d.stop()


def _workload(fs, seed: int) -> int:
    rng = np.random.default_rng(seed)
    fs.mkdir("/cold")
    total = 0
    for i in range(FILES):
        data = rng.integers(0, 256, FILE_SIZE, dtype=np.uint8).tobytes()
        fs.write_file(f"/cold/f{i}.bin", data)
        fs.meta.set_attr(fs.resolve(f"/cold/f{i}.bin"),
                         mtime=time.time() - 7200)
        total += len(data)
    return total


def _du(paths: list[str]) -> int:
    total = 0
    for root in paths:
        for dirpath, _, files in os.walk(root):
            for f in files:
                try:
                    total += os.path.getsize(os.path.join(dirpath, f))
                except OSError:
                    pass
    return total


def _strip_ts(obj):
    """Drop wall-clock fields: they vary run-to-run without being FSM
    decisions (every other field — inos, extents, gens, xattrs — IS)."""
    if isinstance(obj, dict):
        return {k: _strip_ts(v) for k, v in obj.items()
                if k not in ("ts", "mtime", "ctime", "atime")}
    if isinstance(obj, list):
        return [_strip_ts(v) for v in obj]
    return obj


def _fsm_digest(fs) -> str:
    h = hashlib.sha256()
    for mp in fs.meta.mps:
        state = json.loads(fs.meta._call(mp, "export_state", {})[1])
        h.update(json.dumps(_strip_ts(state), sort_keys=True).encode())
    return h.hexdigest()


def leg_replicated(tmp: str, seed: int) -> dict:
    c = _build(tmp, "a", with_blob=False, door=None)
    try:
        logical = _workload(c["fs"], seed)
        stored = _du(c["data_dirs"])
        return {"leg": "replicated_hot", "logical_bytes": logical,
                "stored_bytes": stored,
                "ratio": round(stored / logical, 3)}
    finally:
        _teardown(c)


class _StillTracker:
    """Empty SLO snapshot: the gate sees a healthy system."""

    def snapshot(self):
        return {}


def leg_tiered(tmp: str, seed: int, device=None) -> dict:
    from ..codec.codemode import CodeMode
    from ..fs.lcnode import LcNode, LifecycleRule
    from ..fs.tiering import TieringEngine
    from ..utils import qos

    # the benchmark's own write burst feeds the process-global SLO
    # tracker; left alone it browns out SCRUB and the migration leg
    # measures the brownout, not the tiering ratio
    qos.DEFAULT._tracker = _StillTracker()
    qos.DEFAULT._levels = {}
    qos.DEFAULT._last_refresh = float("-inf")

    c = _build(tmp, "b", with_blob=True, door=None, device=device)
    try:
        fs = c["fs"]
        logical = _workload(fs, seed)
        engine = TieringEngine(fs, c["access"],
                               codemode=int(CodeMode.EC6P3))
        lc = LcNode(fs, engine=engine)
        lc.set_rules([LifecycleRule("tier", prefix="/cold/",
                                    transition_after_s=3600)])
        report = lc.scan_once()
        # physically delete the released hot extents (deferred free)
        dp_view = {dp["dp_id"]: dp for dp in c["view"]["dps"]}
        for node in c["metas"]:
            node.set_dp_view(lambda: dp_view)
            node._free_scan()
        hot_left = _du(c["data_dirs"])
        cold = _du(c["blob_dirs"])
        return {"leg": "tiered_cold_ec6p3",
                "transitioned": report.transitioned,
                "logical_bytes": logical,
                "stored_bytes_blob": cold,
                "residual_hot_bytes": hot_left,
                "ratio": round(cold / logical, 3)}
    finally:
        _teardown(c)


def leg_digests(tmp: str, seed: int, device=None) -> dict:
    control = _build(tmp, "c", with_blob=False, door=None)
    try:
        _workload(control["fs"], seed)
        d_control = _fsm_digest(control["fs"])
    finally:
        _teardown(control)
    dooroff = _build(tmp, "d", with_blob=True, door="0", device=device)
    try:
        assert dooroff["fs"].tiering is None
        _workload(dooroff["fs"], seed)
        d_off = _fsm_digest(dooroff["fs"])
    finally:
        _teardown(dooroff)
    return {"leg": "door_off_fsm_identity", "control_digest": d_control,
            "door_off_digest": d_off, "identical": d_control == d_off}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the record here")
    ap.add_argument("--device", default="cuda",
                    help="the blob codec's device: cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=13)
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory(prefix="tier_ab_") as tmp:
        a = leg_replicated(tmp, args.seed)
        b = leg_tiered(tmp, args.seed, args.device)
        d = leg_digests(tmp, args.seed, args.device)

    out = {
        "bench": "TIER_AB", "seed": args.seed,
        "files": FILES, "file_size": FILE_SIZE,
        "legs": [a, b, d],
        "savings_x": round(a["ratio"] / b["ratio"], 2) if b["ratio"] else None,
    }
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
            f.write("\n")
    print(json.dumps(out, indent=2))
    ok = (d["identical"] and b["transitioned"] == FILES
          and 1.3 <= b["ratio"] <= 2.0 and 2.5 <= a["ratio"] <= 3.5)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
