"""The port's cold tier (``cubefs_tpu_torch/fs/tiering.py``, ``fs/lcnode.py``
and ``blob/sdk.py``) held against the reference's on the CPU, with the
port's blob plane on ``device="cpu"`` (kernel A's plain version).

- every scenario of the reference's ``tests/test_tiering.py`` runs on the
  port (``port_copy``), the chaos drill's kill at every phase boundary
  and the WAL replay of a half-committed transition included, and the
  two that drive ``fs/remotecache.py``'s ``FlashNode`` (burn-aware
  eviction, untagged entries as a plain LRU). The CLI view is the port's
  ``cli._tiering_view`` reading the port's own ``/metrics`` text
  (``tests/test_torch_operators.py`` holds each view against the
  reference's on the same text);
- a twin migration: the same aged file in both packages, each on its own
  blob plane, gives equal blob bytes on every disk, equal locations and
  equal cold reads, healthy and degraded;
- ``CUBEFS_TIERING`` and ``CUBEFS_UNTIER_HOT`` flipped give the
  reference's outcomes, and with the door off the path is the hot one,
  byte for byte;
- ``BlobClient`` (the embedded SDK a deployment hands the client) round
  trips through the port's access layer and raises without a card unless
  asked for the CPU.

Tolerance: exact equality.
"""

import functools
import json

import numpy as np
import pytest

from cubefs_tpu_torch.blob import access, blobnode
from cubefs_tpu_torch.utils import qos
from test_torch_raft import port_copy, run_scenario, scenarios


class _Still:
    def snapshot(self):
        return {}


@pytest.fixture(autouse=True)
def _port_qos_still(monkeypatch):
    """The port's QoS gate pinned burn-free, as the repo's conftest pins
    the reference's: a browned-out SCRUB class defers every migrate."""
    monkeypatch.setattr(qos.DEFAULT, "_tracker", _Still())
    monkeypatch.setattr(qos.DEFAULT, "_levels", {})
    monkeypatch.setattr(qos.DEFAULT, "_last_refresh", float("-inf"))
    monkeypatch.delenv("CUBEFS_TIERING", raising=False)
    monkeypatch.delenv("CUBEFS_UNTIER_HOT", raising=False)


TIERING = port_copy(
    "test_tiering",
    AccessConfig=functools.partial(access.AccessConfig, device="cpu"),
    AccessHandler=access.AccessHandler,
    BlobNode=functools.partial(blobnode.BlobNode, device="cpu"))


@pytest.mark.parametrize("name", scenarios(TIERING))
def test_reference_tiering_scenario_on_the_port(name, request):
    run_scenario(TIERING, name, request)


tiercluster = TIERING.tiercluster


# ---------------- the two packages, side by side ----------------

@pytest.fixture
def ref(monkeypatch):
    """The reference's tiering scenarios' module, its ``auto`` pinned to
    its host leg (no crossover is measured or written)."""
    import test_tiering as ref_tiering
    from cubefs_tpu.codec import engine as ref_engine

    monkeypatch.setattr(ref_engine, "_policy", [[1 << 62, "cpp"]])
    monkeypatch.setattr(ref_engine, "_dead_engines", set())
    return ref_tiering


def payload(seed, n):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def stop(metas, datas):
    for n in (*metas, *datas):
        n.stop()


def stripes(blob, loc) -> dict:
    """Every shard of every blob of a location, read off the blobnode:
    {(vid, bid, unit index): bytes}."""
    h = blob.inner._h
    out = {}
    for sl in loc["slices"]:
        vol = h.cm.call("get_volume", {"vid": sl["vid"]})[0]["volume"]
        for bid in range(sl["min_bid"], sl["min_bid"] + sl["count"]):
            for idx, u in enumerate(vol["units"]):
                node = h.nodes.get(u["node_addr"])._target
                out[(sl["vid"], bid, idx)] = bytes(node.get_shard(u["disk_id"], u["chunk_id"],
                                                                  bid)[0])
    return out


def test_twin_migration_gives_equal_blobs_and_cold_reads(ref, tmp_path):
    """The same aged file tiered by one scan in each package: equal
    locations, equal shard bytes on every unit of every stripe, equal
    cold reads; then with a data unit of every stripe deleted, equal
    degraded cold reads (the port's rebuild is kernel A's plain version)."""
    data = payload(21, 3 * (64 << 10) + 1234)  # four blobs of 64 KiB
    out = {}
    for name, mod in (("port", TIERING), ("ref", ref)):
        fs, view, pool, engine, blob, metas, datas = mod._build_cluster(tmp_path, name)
        try:
            fs.mkdir("/cold")
            ino = mod._write_aged(fs, "/cold/twin", data)
            rep = mod._lc(fs, engine).scan_once()
            inode = fs.meta.inode_get(ino)
            loc = json.loads(inode["xattr"]["cold.location"])
            shards = stripes(blob, loc)
            reads = [engine.read_cold(inode, 0, len(data)), engine.read_cold(inode, 5000, 70_000)]
            h = blob.inner._h
            for sl in loc["slices"]:
                vol = h.cm.call("get_volume", {"vid": sl["vid"]})[0]["volume"]
                u = vol["units"][1]
                node = h.nodes.get(u["node_addr"])._target
                for bid in range(sl["min_bid"], sl["min_bid"] + sl["count"]):
                    node.delete_shard(u["disk_id"], u["chunk_id"], bid)
            reads.append(engine.read_cold(inode, 0, len(data)))
            out[name] = {"transitioned": rep.transitioned, "extents": inode["extents"],
                         "location": loc, "shards": shards, "reads": reads}
        finally:
            stop(metas, datas)
    assert out["port"] == out["ref"]
    assert out["port"]["transitioned"] == 1 and not out["port"]["extents"]
    assert out["port"]["reads"] == [data, data[5000:75_000], data]
    assert len({k[1] for k in out["port"]["shards"]}) == 4


def door_drive(mod, root) -> dict:
    """What ``CUBEFS_TIERING`` and ``CUBEFS_UNTIER_HOT`` decide for a
    ``FileSystem`` built with a blob client, on one aged file: whether the
    door opens, what one scan does, what a read of the tiered file gives,
    and how many cold reads make it a re-heat candidate."""
    fs, view, pool, engine, blob, metas, datas = mod._build_cluster(root)
    try:
        fs2 = mod.FileSystem(view, pool, blob_client=blob)
        data = payload(22, 100_001)
        fs2.mkdir("/cold")
        ino = mod._write_aged(fs2, "/cold/door", data)
        out = {"door": fs2.tiering is not None}
        if fs2.tiering is None:
            rep = mod._lc(fs2, None).scan_once()  # no engine: rules find no tier target
            inode = fs2.meta.inode_get(ino)
            out.update(scanned=rep.scanned, transitioned=rep.transitioned,
                       hot=bool(inode["extents"]), read=fs2.read_file("/cold/door") == data)
            return out
        rep = mod._lc(fs2, fs2.tiering).scan_once()
        reads = 0
        while not fs2.tiering.hot_candidates() and reads < 10:
            assert fs2.read_file("/cold/door") == data
            reads += 1
        rep2 = mod._lc(fs2, fs2.tiering).scan_once()
        out.update(scanned=rep.scanned, transitioned=rep.transitioned,
                   reads_to_reheat=reads, untiered=rep2.untiered,
                   hot_again=bool(fs2.meta.inode_get(ino)["extents"]),
                   read=fs2.read_file("/cold/door") == data)
        return out
    finally:
        stop(metas, datas)


@pytest.mark.parametrize("env", [{}, {"CUBEFS_TIERING": "1"}, {"CUBEFS_TIERING": "0"},
                                 {"CUBEFS_TIERING": "1", "CUBEFS_UNTIER_HOT": "1"},
                                 {"CUBEFS_TIERING": "1", "CUBEFS_UNTIER_HOT": "5"}],
                         ids=["default", "on", "off", "on-untier1", "on-untier5"])
def test_doors_flipped_give_the_reference_result(env, ref, tmp_path, monkeypatch):
    """``CUBEFS_TIERING`` (off by default) and ``CUBEFS_UNTIER_HOT``: each
    setting gives the reference's outcome; with the door shut the file
    stays on its extents and reads back byte for byte."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port = door_drive(TIERING, tmp_path / "port")
    assert port == door_drive(ref, tmp_path / "ref")
    if env.get("CUBEFS_TIERING") != "1":
        assert port == {"door": False, "scanned": 1, "transitioned": 0, "hot": True,
                        "read": True}
    else:
        assert port["transitioned"] == 1 and port["untiered"] == 1 and port["hot_again"]
        assert port["reads_to_reheat"] == int(env.get("CUBEFS_UNTIER_HOT", "3"))


def test_blob_client_round_trip_and_device(tmp_path):
    """The embedded SDK over the port's access layer: put, get and delete
    of a location dict on a ``cfg`` with ``device="cpu"``; without a card
    it refuses the default device."""
    import torch

    from cubefs_tpu_torch.blob.clustermgr import ClusterMgr
    from cubefs_tpu_torch.blob.sdk import BlobClient
    from cubefs_tpu_torch.utils import rpc

    cm = ClusterMgr(allow_colocated_units=True)
    pool = rpc.NodePool()
    bn = blobnode.BlobNode(0, [str(tmp_path / f"d{i}") for i in range(9)], rpc.Client(cm),
                           addr="bn0", device="cpu")
    bn.register()
    bn.send_heartbeat()
    pool.bind("bn0", bn)
    cli = BlobClient(cm, pool, access.AccessConfig(blob_size=64 << 10, device="cpu"))
    data = payload(23, 150_000)
    loc = cli.put(data, priority=qos.SCRUB)
    assert isinstance(loc, dict) and cli.get(loc) == data
    cli.delete(loc)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            BlobClient(cm, pool)


def test_native_meta_reads_see_the_tiering_applies(tmp_path):
    """With the metanodes' native read plane serving the client (the
    launcher's deployment), an inode read after a migration, and after a
    re-heat, answers what the partition holds: the port mirrors every
    tiering apply into the plane. (The reference mirrors none of them: its
    native reads go on answering the hot inode, extents and no
    ``cold.location``, after the migration.)"""
    from cubefs_tpu_torch.blob.clustermgr import ClusterMgr
    from cubefs_tpu_torch.fs.lcnode import LcNode, LifecycleRule
    from cubefs_tpu_torch.fs.tiering import TieringEngine, _AccessAdapter
    from cubefs_tpu_torch.utils import rpc
    from cubefs_tpu_torch.utils.retry import FakeClock
    from test_torch_fs import FS_E2E

    c = FS_E2E.FsCluster(tmp_path)
    try:
        cm = ClusterMgr(allow_colocated_units=True)
        bn = blobnode.BlobNode(0, [str(tmp_path / f"bd{i}") for i in range(9)], rpc.Client(cm),
                               addr="bn0", device="cpu")
        bn.register()
        bn.send_heartbeat()
        c.pool.bind("bn0", bn)
        engine = TieringEngine(c.fs, _AccessAdapter(access.AccessHandler(
            rpc.Client(cm), c.pool, access.AccessConfig(blob_size=64 << 10, device="cpu"))),
            untier_threshold=1)
        fs = c.fs
        fs.mkdir("/cold")
        data = payload(24, 150_001)
        ino = fs.write_file("/cold/n", data)
        fs.meta.set_attr(ino, mtime=TIERING.NOW - 7200)
        lc = LcNode(fs, engine=engine, clock=FakeClock(start=TIERING.NOW))
        lc.set_rules([LifecycleRule("tier", prefix="/cold/", transition_after_s=3600)])

        def native_and_held():
            ops = sum(m._native_lib.ms_op_count(m._native_h) for m in c.metas)
            got = fs.meta.inode_get(ino)
            assert sum(m._native_lib.ms_op_count(m._native_h) for m in c.metas) > ops
            # the leader's copy: the read is served by the leader's plane,
            # and a follower may not have applied the last entry yet
            mp = next(p for m in c.metas for pid, p in m.partitions.items()
                      if p.start <= ino < p.end and ino in p.inodes
                      and (pid not in m.rafts or m.rafts[pid].status()["role"] == "leader"))
            return got, json.loads(json.dumps(mp.inodes[ino]))

        assert lc.scan_once().transitioned == 1
        got, held = native_and_held()
        assert got == held and not got["extents"] and got["xattr"].get("cold.location")
        assert engine.read_cold(got, 0, len(data)) == data
        assert lc.scan_once().untiered == 1
        got, held = native_and_held()
        assert got == held and got["extents"] and not got["xattr"].get("cold.location")
        assert fs.read_file("/cold/n") == data
    finally:
        c.stop()
