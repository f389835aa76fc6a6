"""The port's blob plane (``cubefs_tpu_torch/blob/``) held against the
reference's (``cubefs_tpu/blob/``).

Twin in-process clusters from one seed — the reference's with its
``numpy`` engine, the port's with ``device="cpu"`` and engines ``auto``
and ``cuda`` (the plain version behind the same staging) — get the same
registrations and payloads and must agree on every Location, every shard
byte on every disk, every GET (healthy and with M disks down) and, after
the same disk breaks and the workers drain, on the destination disks and
the rebuilt bytes. Then every scenario of ``tests/test_blob_e2e.py``
whose modules this port holds runs against the port (the raft-replicated
clustermgr's runs in ``tests/test_torch_replicated.py``), and state
written by either package opens in the other.
"""

import json
import math
import os
import types

import numpy as np
import pytest

from cubefs_tpu_torch.blob import access, blobnode, chunkstore, clustermgr, mq, scheduler
from cubefs_tpu_torch.blob import types as btypes
from cubefs_tpu_torch.blob import worker
from cubefs_tpu_torch.codec import codemode as cmode
from cubefs_tpu_torch.utils import lockwitness, metrics, qos, rpc

PORT = types.SimpleNamespace(access=access, blobnode=blobnode, clustermgr=clustermgr, mq=mq,
                             scheduler=scheduler, worker=worker, rpc=rpc, types=btypes)
ENGINES = ["auto", "cuda"]


@pytest.fixture(scope="module")
def ref():
    from cubefs_tpu.blob import access, blobnode, clustermgr, mq, scheduler, worker
    from cubefs_tpu.blob import types as btypes
    from cubefs_tpu.utils import rpc

    return types.SimpleNamespace(access=access, blobnode=blobnode, clustermgr=clustermgr,
                                 mq=mq, scheduler=scheduler, worker=worker, rpc=rpc,
                                 types=btypes)


@pytest.fixture(scope="module", autouse=True)
def witness():
    """Every lock the port's clusters take in this module is witnessed:
    a lock-order inversion or a lock held across an RPC raises where it
    happens, and the teardown checks the witness watched the plane."""
    with lockwitness.installed() as w:
        yield w
    st = w.stats()
    assert st["acquisitions"] > 0 and st["rpc_checks"] > 0


class _Still:
    def snapshot(self):
        return {}


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    """The port's QoS gate pinned burn-free (the repo's conftest pins the
    reference's), the port's ``auto`` on its static table (no measured
    file), and the reference's ``auto`` (its blobnodes and inspector use
    it) on its host leg, so neither measures a crossover."""
    from cubefs_tpu_torch.codec import engine as E

    monkeypatch.setattr(qos.DEFAULT, "_tracker", _Still())
    monkeypatch.setattr(qos.DEFAULT, "_levels", {})
    monkeypatch.setattr(qos.DEFAULT, "_last_refresh", float("-inf"))
    monkeypatch.setattr(E, "_policy_path", lambda: str(tmp_path / "CROSSOVER.json"))
    monkeypatch.setattr(E, "_policy", None)
    for var in ("CUBEFS_CODEC_DEAD", "CUBEFS_CODEC_XOR", "CUBEFS_TPU_EC_ENGINE",
                "CUBEFS_CODEC_STEP_BYTES"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture
def ref_routing(monkeypatch, ref):
    from cubefs_tpu.codec import engine as ref_engine

    monkeypatch.setattr(ref_engine, "_policy", [[1 << 62, "cpp"]])
    monkeypatch.setattr(ref_engine, "_dead_engines", set())


class Cluster:
    """In-process blob cluster of either package: n_nodes x disks_per_node
    disks, the reference's test topology. ``engine`` None is the
    reference's ``numpy`` engine; a port cluster runs on the CPU."""

    def __init__(self, pkg, root, n_nodes=4, disks_per_node=3, data_dir=None, engine=None,
                 azs=None, blob_size=64 << 10, colocated=False):
        port = pkg is PORT
        dev = {"device": "cpu"} if port else {}
        os.makedirs(root, exist_ok=True)
        self.pkg = pkg
        self.cm = pkg.clustermgr.ClusterMgr(data_dir=data_dir, allow_colocated_units=colocated)
        self.cm_client = pkg.rpc.Client(self.cm)
        self.pool = pkg.rpc.NodePool()
        self.nodes = []
        for n in range(n_nodes):
            addr = f"node{n}"
            node = pkg.blobnode.BlobNode(
                node_id=n, disk_paths=[os.path.join(str(root), f"n{n}d{d}")
                                       for d in range(disks_per_node)],
                cm_client=self.cm_client, addr=addr, az=azs[n] if azs else "",
                **(dict(dev, engine=engine) if port else {}))
            node.register()
            node.send_heartbeat()
            self.pool.bind(addr, node)
            self.nodes.append(node)
        self.repair_q = pkg.mq.MessageQueue()
        self.delete_q = pkg.mq.MessageQueue()
        self.access = pkg.access.AccessHandler(
            self.cm_client, self.pool,
            pkg.access.AccessConfig(blob_size=blob_size, engine=engine or "numpy", **dev),
            repair_queue=self.repair_q, delete_queue=self.delete_q)
        self.sched = pkg.scheduler.Scheduler(
            self.cm, repair_queue=self.repair_q, delete_queue=self.delete_q,
            node_pool=self.pool, **(dict(dev, engine=engine) if port else {}))
        self.worker = pkg.worker.RepairWorker(pkg.rpc.Client(self.sched), self.cm_client,
                                              self.pool, engine=engine or "numpy", **dev)

    def node_of(self, addr: str):
        return self.nodes[int(addr.removeprefix("node"))]

    def drain_worker(self, max_tasks=100):
        for _ in range(max_tasks):
            if not self.worker.run_once():
                return
        raise AssertionError("worker did not drain")

    def shards(self) -> dict:
        """{(vid, unit index, bid): (disk, chunk, bytes)} over every
        readable unit of every volume."""
        out = {}
        for vid in sorted(self.cm.volumes):
            for u in self.cm.get_volume(vid).units:
                node = self.node_of(u.node_addr)
                if node._disk_down(u.disk_id):
                    continue
                for bid, _, _ in node.list_chunk(u.disk_id, u.chunk_id):
                    out[(vid, u.index, bid)] = (u.disk_id, u.chunk_id,
                                                node.get_shard(u.disk_id, u.chunk_id, bid)[0])
        return out


def payload(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


# ---------------- twin clusters: the port against the reference ----------------

TWINS = {
    # codemode, cluster shape and AZ labels, colocation, payload sizes
    "EC6P3": dict(n_nodes=4, disks_per_node=3, azs=None, colocated=False,
                  sizes=(100_000, 1_000)),
    "EC4P4L2": dict(n_nodes=6, disks_per_node=2, azs=["z0"] * 3 + ["z1"] * 3,
                    colocated=False, sizes=(70_000,)),
    "EC4P4MSR": dict(n_nodes=4, disks_per_node=3, azs=None, colocated=True,
                     sizes=(60_000, 9_999)),
}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("mode", sorted(TWINS))
def test_twin_clusters_agree_put_get_degraded_and_repair(ref, ref_routing, tmp_path, rng,
                                                         mode, engine):
    shape = dict(TWINS[mode])
    sizes = shape.pop("sizes")
    want = Cluster(ref, tmp_path / "ref", blob_size=32 << 10, **shape)
    got = Cluster(PORT, tmp_path / "port", engine=engine, blob_size=32 << 10, **shape)
    code = cmode.CodeMode[mode]
    data = [payload(rng, n) for n in sizes]

    # PUT: equal Locations, equal bytes on every disk
    locs = []
    for d in data:
        a, b = want.access.put(d, codemode=code), got.access.put(d, codemode=code)
        assert b.to_dict() == a.to_dict()
        locs.append((a, b))
    before = got.shards()
    assert before == want.shards() and before
    assert {k: got.cm.get_volume(k).to_dict() for k in got.cm.volumes} == \
        {k: want.cm.get_volume(k).to_dict() for k in want.cm.volumes}

    # GET healthy, then with M of the first volume's disks down
    for (a, b), d in zip(locs, data):
        assert got.access.get(b) == want.access.get(a) == d
    t = cmode.tactic(code)
    vol = got.cm.get_volume(locs[0][1].slices[0].vid)
    for c in (want, got):
        for u in vol.units[: t.m]:
            c.node_of(u.node_addr).break_disk(u.disk_id)
    for (a, b), d in zip(locs, data):
        assert got.access.get(b) == want.access.get(a) == d
    assert got.repair_q.backlog() == want.repair_q.backlog() > 0
    for c in (want, got):
        for node in c.nodes:
            node._broken.clear()

    # one disk breaks; the scheduler and the worker drain it
    victim = vol.units[2]
    subs0 = metrics.repair_subshard_reads.value()
    n_tasks = [c.sched.mark_disk_broken(victim.disk_id) for c in (want, got)]
    assert n_tasks[0] == n_tasks[1] >= 1
    for c in (want, got):
        c.node_of(victim.node_addr).break_disk(victim.disk_id)
        c.drain_worker()
        assert c.worker.completed == n_tasks[0] and c.worker.failed == 0
    dests = [sorted((x["vid"], x["unit_index"], x["dest_disk"], x["dest_chunk"])
                    for x in c.sched.tasks.values()) for c in (want, got)]
    assert dests[1] == dests[0]
    after = got.shards()
    assert after == want.shards()
    for (vid, idx, bid), (disk, chunk, blob) in before.items():
        if disk == victim.disk_id:  # rebuilt elsewhere, byte for byte
            assert after[(vid, idx, bid)][2] == blob and after[(vid, idx, bid)][0] != disk
    if t.is_msr():
        assert metrics.repair_subshard_reads.value() > subs0  # the sub-shard path
    for (a, b), d in zip(locs, data):
        assert got.access.get(b) == want.access.get(a) == d


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_state_written_by_either_package_opens_in_the_other(ref, ref_routing, tmp_path, rng,
                                                            writer, reader):
    """A cluster's clustermgr state (``data_dir``: snapshot + wal) and its
    disk directories, written by one package, are opened by the other:
    ``ClusterMgr(data_dir=...)`` reads the state, and each node attaches
    the disks the clustermgr lists under its address (``attach_local``).
    The reader GETs the writer's Locations byte for byte and its own PUTs
    read back through the writer."""
    pkgs = {"ref": ref, "port": PORT}
    w = Cluster(pkgs[writer], tmp_path / "disks", data_dir=str(tmp_path / "cm"),
                engine="auto" if writer == "port" else None)
    data = [payload(rng, n) for n in (120_000, 5_000)]
    locs = [w.access.put(d, codemode=cmode.CodeMode.EC6P3) for d in data]
    w.cm.snapshot()
    w.cm.set_config("after_snapshot", "1")  # rides the wal
    # a GET returns before its hedged reads do: drain them before the
    # stores close under them
    w.access._pool.shutdown(wait=True)
    for node in w.nodes:
        node.stop()

    def reopen(pkg, engine):
        p = pkg is PORT
        cm = pkg.clustermgr.ClusterMgr(data_dir=str(tmp_path / "cm"))
        cmc, pool = pkg.rpc.Client(cm), pkg.rpc.NodePool()
        nodes = {}
        for disk_id, disk in sorted(cm.disks.items()):
            node = nodes.get(disk.node_addr)
            if node is None:
                node = nodes[disk.node_addr] = pkg.blobnode.BlobNode(
                    int(disk.node_addr.removeprefix("node")), [], cmc, addr=disk.node_addr,
                    **({"device": "cpu", "engine": engine} if p else {}))
                pool.bind(disk.node_addr, node)
            node.attach_local(disk_id, disk.path)
        acc = pkg.access.AccessHandler(cmc, pool, pkg.access.AccessConfig(
            blob_size=64 << 10, engine=engine, **({"device": "cpu"} if p else {})))
        return cm, acc, list(nodes.values())

    cm, acc, nodes = reopen(pkgs[reader], "auto" if reader == "port" else "numpy")
    assert cm.get_config("after_snapshot") == "1"
    for loc, d in zip(locs, data):
        mine = pkgs[reader].types.Location.from_dict(loc.to_dict())
        assert acc.get(mine) == d
    extra = payload(rng, 70_000)
    new_loc = acc.put(extra, codemode=cmode.CodeMode.EC6P3)
    cm.snapshot()
    acc._pool.shutdown(wait=True)
    for node in nodes:
        node.stop()
    cm2, acc2, nodes2 = reopen(pkgs[writer], "auto" if writer == "port" else "numpy")
    assert acc2.get(pkgs[writer].types.Location.from_dict(new_loc.to_dict())) == extra
    acc2._pool.shutdown(wait=True)
    for node in nodes2:
        node.stop()


def test_entry_points_raise_without_a_gpu(tmp_path, monkeypatch):
    """With no card and no ``device="cpu"``, every blob entry point that
    holds a codec raises at construction; nothing drops to the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cm = clustermgr.ClusterMgr()
    cmc, pool = rpc.Client(cm), rpc.NodePool()
    for engine in ("auto", "cuda", "cpp"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            access.AccessHandler(cmc, pool, access.AccessConfig(engine=engine))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            blobnode.BlobNode(0, [str(tmp_path / "d")], cmc, engine=engine)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            scheduler.Scheduler(cm, engine=engine)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            worker.RepairWorker(rpc.Client(cm), cmc, pool, engine=engine)


def test_cuda_engine_stages_a_put_stack_once_each_way(tmp_path, rng, monkeypatch):
    """Under ``cuda`` a PUT's (B, total, S) stack goes to the device in
    one copy and its parity rows come back in one; a degraded stripe is
    one copy each way too (counted through ``codec/hostio.py``)."""
    from cubefs_tpu_torch.codec import hostio

    calls = {"to_device": [], "to_host": []}
    for name in calls:
        real = getattr(hostio, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name].append(tuple(a[1]) if _name == "to_device" else tuple(a[0].shape))
            return _real(*a, **kw)

        monkeypatch.setattr(hostio, name, spy)
    c = Cluster(PORT, tmp_path, engine="cuda")
    data = payload(rng, 200_000)  # 4 blobs of 64 KiB
    loc = c.access.put(data, codemode=cmode.CodeMode.EC6P3)
    s = -(-(64 << 10) // 6)
    assert calls == {"to_device": [(4, 9, s)], "to_host": [(4, 3, s)]}
    vol = c.cm.get_volume(loc.slices[0].vid)
    c.node_of(vol.units[0].node_addr).break_disk(vol.units[0].disk_id)
    calls["to_device"].clear()
    calls["to_host"].clear()
    assert c.access.get(loc) == data
    assert len(calls["to_device"]) == 4 and all(sh == (9, s) for sh in calls["to_device"])
    assert all(sh[0] >= 1 for sh in calls["to_host"]) and len(calls["to_host"]) == 4


def test_auto_cuda_leg_stages_a_put_stack_once_each_way(tmp_path, rng, monkeypatch):
    """A PUT that ``auto`` sends to its ``cuda`` leg takes the staging path
    of the ``cuda`` engine: the stack's data rows go to the device in one
    copy, straight from the caller's stripe, and the parity rows come back
    in one copy into it; the shards equal a ``cuda`` cluster's."""
    from cubefs_tpu_torch.codec import engine as E
    from cubefs_tpu_torch.codec import hostio

    calls = {"to_device": [], "to_host": []}
    for name in calls:
        real = getattr(hostio, name)

        def spy(*a, _real=real, _name=name, **kw):
            # the copy's shape, and whether it reads the caller's strided
            # rows (in) or writes the caller's rows (out)
            calls[_name].append((tuple(a[1]), not a[0].flags.c_contiguous)
                                if _name == "to_device"
                                else (tuple(a[0].shape), kw.get("out") is not None))
            return _real(*a, **kw)

        monkeypatch.setattr(hostio, name, spy)
    monkeypatch.setattr(E, "_policy", [[1 << 62, "cuda"]])
    data = payload(rng, 200_000)  # 4 blobs of 64 KiB
    auto = Cluster(PORT, tmp_path / "auto", engine="auto")
    loc = auto.access.put(data, codemode=cmode.CodeMode.EC6P3)
    s = -(-(64 << 10) // 6)
    assert calls == {"to_device": [((4, 6, s), True)], "to_host": [((4, 3, s), True)]}
    assert E.last_dispatch["served"] == "cuda"
    cuda = Cluster(PORT, tmp_path / "cuda", engine="cuda")
    assert cuda.access.put(data, codemode=cmode.CodeMode.EC6P3) == loc
    assert auto.shards() == cuda.shards()
    assert auto.access.get(loc) == data


# ---------------- the reference's scenarios, against the port ----------------

@pytest.fixture(params=ENGINES)
def cluster(request, tmp_path):
    return Cluster(PORT, tmp_path, engine=request.param)


@pytest.mark.parametrize("engine", ENGINES)
def test_put_get_roundtrip_multi_blob(tmp_path, rng, engine):
    c = Cluster(PORT, tmp_path, engine=engine)
    data = payload(rng, 200_000)  # 4 blobs of 64KiB
    loc = c.access.put(data, codemode=cmode.CodeMode.EC6P3)
    assert loc.size == len(data) and loc.slices[0].count == 4
    assert c.access.get(loc) == data


def test_degraded_get_with_broken_disk(cluster, rng):
    data = payload(rng, 100_000)
    loc = cluster.access.put(data, codemode=cmode.CodeMode.EC6P3)
    vol = cluster.cm.get_volume(loc.slices[0].vid)
    u = vol.units[0]
    cluster.node_of(u.node_addr).break_disk(u.disk_id)
    assert cluster.access.get(loc) == data  # reconstructed on the fly
    assert cluster.repair_q.backlog() > 0  # degraded read filed repair msgs


def test_disk_repair_end_to_end(cluster, rng):
    data = payload(rng, 150_000)
    loc = cluster.access.put(data, codemode=cmode.CodeMode.EC6P3)
    vid = loc.slices[0].vid
    vol_before = cluster.cm.get_volume(vid)
    victim = vol_before.units[2]
    victim_node = cluster.node_of(victim.node_addr)
    original = {bid: victim_node.get_shard(victim.disk_id, victim.chunk_id, bid)[0]
                for bid, _, _ in victim_node.list_chunk(victim.disk_id, victim.chunk_id)}
    victim_node.break_disk(victim.disk_id)
    assert cluster.sched.mark_disk_broken(victim.disk_id) >= 1
    cluster.drain_worker()
    vol_after = cluster.cm.get_volume(vid)
    new_unit = vol_after.units[2]
    assert (new_unit.disk_id, new_unit.chunk_id) != (victim.disk_id, victim.chunk_id)
    assert vol_after.epoch > vol_before.epoch
    new_node = cluster.node_of(new_unit.node_addr)
    for bid, blob in original.items():
        rebuilt, _ = new_node.get_shard(new_unit.disk_id, new_unit.chunk_id, bid)
        assert rebuilt == blob
    assert cluster.cm.disks[victim.disk_id].status == btypes.DiskStatus.REPAIRED
    assert cluster.access.get(loc) == data


def test_msr_disk_repair_pulls_subshards(cluster, rng):
    cluster.cm.allow_colocated_units = True  # 8 units on a 4-node cluster
    data = payload(rng, 60_000)
    loc = cluster.access.put(data, codemode=cmode.CodeMode.EC4P4MSR)
    vid = loc.slices[0].vid
    vol_before = cluster.cm.get_volume(vid)
    victim = vol_before.units[2]
    victim_node = cluster.node_of(victim.node_addr)
    original = {bid: victim_node.get_shard(victim.disk_id, victim.chunk_id, bid)[0]
                for bid, _, _ in victim_node.list_chunk(victim.disk_id, victim.chunk_id)}
    victim_node.break_disk(victim.disk_id)
    sub0 = metrics.repair_subshard_reads.value()
    pulled0 = sum(v for _, v in metrics.repair_bytes_pulled.samples())
    fb0 = sum(v for _, v in metrics.repair_msr_fallbacks.samples())
    assert cluster.sched.mark_disk_broken(victim.disk_id) >= 1
    cluster.drain_worker()
    n_subshard = metrics.repair_subshard_reads.value() - sub0
    assert n_subshard >= vol_before.tactic.d * len(original)
    assert sum(v for _, v in metrics.repair_msr_fallbacks.samples()) == fb0
    shard_bytes = max(len(b) for b in original.values())
    pulled = sum(v for _, v in metrics.repair_bytes_pulled.samples()) - pulled0
    assert pulled < vol_before.tactic.d * shard_bytes * len(original)
    new_unit = cluster.cm.get_volume(vid).units[2]
    new_node = cluster.node_of(new_unit.node_addr)
    for bid, blob in original.items():
        assert new_node.get_shard(new_unit.disk_id, new_unit.chunk_id, bid)[0] == blob
    assert cluster.cm.disks[victim.disk_id].status == btypes.DiskStatus.REPAIRED
    assert cluster.access.get(loc) == data


def test_unrecoverable_when_too_many_disks_down(cluster, rng):
    data = payload(rng, 50_000)
    loc = cluster.access.put(data, codemode=cmode.CodeMode.EC6P3)
    vol = cluster.cm.get_volume(loc.slices[0].vid)
    for u in vol.units[:4]:  # lose 4 > m=3
        cluster.node_of(u.node_addr).break_disk(u.disk_id)
    with pytest.raises(access.GetError):
        cluster.access.get(loc)


def test_async_delete_via_queue(cluster, rng):
    data = payload(rng, 30_000)
    loc = cluster.access.put(data, codemode=cmode.CodeMode.EC6P3)
    cluster.access.delete(loc)
    assert cluster.delete_q.backlog() == 1
    assert cluster.sched.consume_delete_msgs() == 1
    with pytest.raises(access.GetError):
        cluster.access.get(loc)


def test_put_quorum_failure(cluster, rng):
    for node in cluster.nodes[:2]:
        for d in node.disk_ids:
            node.break_disk(d)
    with pytest.raises(access.PutQuorumError):
        cluster.access.put(payload(rng, 10_000), codemode=cmode.CodeMode.EC6P3)


def test_shard_repair_msgs_consumed_into_tasks(cluster, rng):
    data = payload(rng, 20_000)
    loc = cluster.access.put(data, codemode=cmode.CodeMode.EC6P3)
    vol = cluster.cm.get_volume(loc.slices[0].vid)
    u = vol.units[1]
    cluster.node_of(u.node_addr).break_disk(u.disk_id)
    cluster.access.get(loc)  # degraded read enqueues repair msg
    assert cluster.sched.consume_repair_msgs() >= 1
    cluster.drain_worker()
    assert cluster.cm.get_volume(vol.vid).units[1].disk_id != u.disk_id
    assert cluster.access.get(loc) == data


def test_taskswitch_blocks_collection(cluster):
    cluster.sched.switch.disable("disk_repair")
    assert cluster.sched.collect_broken_disks() == []
    cluster.sched.switch.enable("disk_repair")
    assert cluster.sched.rpc_task_switch({"action": "list"}, b"")["switches"]["disk_repair"]
    cluster.sched.rpc_task_switch({"action": "disable", "kind": "scrub"}, b"")
    assert not cluster.sched.rpc_task_switch({"action": "list"}, b"")["switches"]["scrub"]
    with pytest.raises(rpc.RpcError, match="unknown task kind 'scrubber'"):
        cluster.sched.rpc_task_switch({"action": "disable", "kind": "scrubber"}, b"")


@pytest.mark.parametrize("engine", ENGINES)
def test_clustermgr_persistence(tmp_path, rng, engine):
    d = str(tmp_path / "cm")
    c1 = Cluster(PORT, tmp_path, data_dir=d, engine=engine)
    loc = c1.access.put(payload(rng, 10_000), codemode=cmode.CodeMode.EC6P3)
    vid = loc.slices[0].vid
    c1.cm.snapshot()
    c1.cm.set_config("k", "v")
    cm2 = clustermgr.ClusterMgr(data_dir=d)
    assert cm2.get_volume(vid).to_dict() == c1.cm.get_volume(vid).to_dict()
    assert cm2.get_config("k") == "v"
    assert cm2._next_bid == c1.cm._next_bid


def test_http_transport_smoke(cluster, rng):
    """Same services over the port's own RpcServer sockets."""
    servers = [rpc.RpcServer(rpc.expose(cluster.cm)).start()]
    cm_http = rpc.Client(servers[0].addr)
    pool = access.NodePool()
    for n, node in enumerate(cluster.nodes):
        s = rpc.RpcServer(rpc.expose(node)).start()
        servers.append(s)
        pool.bind(f"node{n}", s.addr)
        pool._clients[f"node{n}"] = rpc.Client(s.addr)
    acc = access.AccessHandler(cm_http, pool, access.AccessConfig(
        blob_size=32 << 10, engine=cluster.access.cfg.engine, device="cpu"))
    try:
        data = payload(rng, 90_000)
        loc = acc.put(data, codemode=cmode.CodeMode.EC6P3)
        assert acc.get(loc) == data
    finally:
        for s in servers:
            s.stop()


def test_manual_migrate(cluster, rng):
    data = payload(rng, 40_000)
    loc = cluster.access.put(data, codemode=cmode.CodeMode.EC6P3)
    vid = loc.slices[0].vid
    before = cluster.cm.get_volume(vid)
    cluster.sched.manual_migrate(vid, 4)
    cluster.drain_worker()
    after = cluster.cm.get_volume(vid)
    assert (after.units[4].disk_id, after.units[4].chunk_id) != (
        before.units[4].disk_id, before.units[4].chunk_id)
    assert cluster.access.get(loc) == data


def test_volume_inspector_clean_and_missing(cluster, rng):
    data = payload(rng, 60_000)
    loc = cluster.access.put(data, codemode=cmode.CodeMode.EC6P3)
    rep = cluster.sched.inspect_volumes()
    assert rep["checked"] >= 1 and rep["bad"] == 0
    vol = cluster.cm.get_volume(loc.slices[0].vid)
    u = vol.units[3]
    cluster.node_of(u.node_addr).delete_shard(u.disk_id, u.chunk_id, loc.slices[0].min_bid)
    cluster.sched.inspect_volumes()
    assert any(t["reason"].startswith("inspect:") for t in cluster.sched.tasks.values())
    cluster.drain_worker()
    assert cluster.access.get(loc) == data


def test_balancer_moves_from_hot_disk(cluster, rng):
    for _ in range(3):
        cluster.access.put(payload(rng, 20_000), codemode=cmode.CodeMode.EC6P3)
    hot = max(cluster.cm.disks.values(), key=lambda d: d.chunk_count)
    hot.chunk_count += 5  # simulate imbalance
    assert cluster.sched.balance(max_moves=2) >= 1
    cluster.drain_worker()


def test_balance_dedups_and_preserves_cm_counts(cluster, rng):
    for _ in range(2):
        cluster.access.put(payload(rng, 15_000), codemode=cmode.CodeMode.EC6P3)
    hot = max(cluster.cm.disks.values(), key=lambda d: d.chunk_count)
    hot.chunk_count += 5
    before = hot.chunk_count
    m1 = cluster.sched.balance(max_moves=1)
    m2 = cluster.sched.balance(max_moves=1)  # same task dedups -> no move
    assert m1 == 1 and m2 == 0
    assert hot.chunk_count == before  # scheduler never mutates cm records


def test_inspector_isolates_corrupt_data_shard(cluster, rng):
    data = payload(rng, 30_000)
    loc = cluster.access.put(data, codemode=cmode.CodeMode.EC6P3)
    vol = cluster.cm.get_volume(loc.slices[0].vid)
    bid = loc.slices[0].min_bid
    u = vol.units[2]  # a data unit
    node = cluster.node_of(u.node_addr)
    good, _ = node.get_shard(u.disk_id, u.chunk_id, bid)
    node.put_shard(u.disk_id, u.chunk_id, bid, bytes(b ^ 0xA5 for b in good))
    assert cluster.sched.inspect_volumes()["bad"] >= 1
    tasks = [t for t in cluster.sched.tasks.values() if "corrupt" in t["reason"]]
    assert tasks and tasks[0]["unit_index"] == 2  # the DATA unit, not parity
    cluster.drain_worker()
    assert cluster.access.get(loc) == data


@pytest.mark.parametrize("engine", ENGINES)
def test_lrc_codemode_through_access(tmp_path, rng, engine):
    c = Cluster(PORT, tmp_path, n_nodes=5, disks_per_node=2, engine=engine)
    c.cm.allow_colocated_units = True
    data = payload(rng, 80_000)
    loc = c.access.put(data, codemode=cmode.CodeMode.EC4P4L2)
    assert c.access.get(loc) == data
    vol = c.cm.get_volume(loc.slices[0].vid)
    assert len(vol.units) == 10  # 4 data + 4 global + 2 local parity
    bid = loc.slices[0].min_bid
    for u in vol.units[8:]:
        shard, _ = c.node_of(u.node_addr).get_shard(u.disk_id, u.chunk_id, bid)
        assert len(shard) > 0
    u = vol.units[0]
    c.node_of(u.node_addr).break_disk(u.disk_id)
    local0 = metrics.reconstruct_reads.value(path="local")
    assert c.access.get(loc) == data
    assert metrics.reconstruct_reads.value(path="local") > local0  # solved in its AZ
    c.sched.mark_disk_broken(u.disk_id)
    c.drain_worker()
    assert c.access.get(loc) == data


@pytest.mark.parametrize("engine", ENGINES)
def test_scheduler_task_persistence_and_recordlog(tmp_path, rng, engine):
    sdir = str(tmp_path / "sched")
    c = Cluster(PORT, tmp_path, engine=engine)
    mk = dict(repair_queue=c.repair_q, delete_queue=c.delete_q, node_pool=c.pool,
              data_dir=sdir, device="cpu", engine=engine)
    sched1 = scheduler.Scheduler(c.cm, **mk)
    data = payload(rng, 30_000)
    loc = c.access.put(data, codemode=cmode.CodeMode.EC6P3)
    victim = c.cm.get_volume(loc.slices[0].vid).units[1]
    c.node_of(victim.node_addr).break_disk(victim.disk_id)
    assert sched1.mark_disk_broken(victim.disk_id) >= 1
    sched2 = scheduler.Scheduler(c.cm, **mk)  # "crash" before any worker ran
    assert any(t["state"] == "pending" for t in sched2.tasks.values())
    w = worker.RepairWorker(rpc.Client(sched2), c.cm_client, c.pool, engine=engine,
                            device="cpu")
    for _ in range(50):
        if not w.run_once():
            break
    assert c.access.get(loc) == data
    events = [json.loads(line)["event"] for line in open(f"{sdir}/records.jsonl") if line.strip()]
    assert {"queued", "leased", "done"} <= set(events)


def test_compaction_sweep_reclaims(cluster, rng):
    loc = cluster.access.put(payload(rng, 60_000), codemode=cmode.CodeMode.EC6P3)
    cluster.access.put(payload(rng, 30_000), codemode=cmode.CodeMode.EC6P3)
    cluster.access._delete_now(loc)
    rep = cluster.sched.compact_chunks()
    assert rep["compacted"] > 0 and rep["reclaimed"] > 0


def _corrupt_survivor_and_break(cluster, rng):
    loc = cluster.access.put(payload(rng, 25_000), codemode=cmode.CodeMode.EC6P3)
    vol = cluster.cm.get_volume(loc.slices[0].vid)
    u = vol.units[3]
    node = cluster.node_of(u.node_addr)
    good, _ = node.get_shard(u.disk_id, u.chunk_id, loc.slices[0].min_bid)
    node.put_shard(u.disk_id, u.chunk_id, loc.slices[0].min_bid, bytes(b ^ 0xFF for b in good))
    victim = vol.units[0]
    cluster.node_of(victim.node_addr).break_disk(victim.disk_id)
    cluster.sched.mark_disk_broken(victim.disk_id)


def test_worker_refuses_writeback_on_corrupt_survivor(cluster, rng):
    _corrupt_survivor_and_break(cluster, rng)
    assert cluster.worker.run_once() and cluster.worker.failed >= 1
    task = next(iter(cluster.sched.tasks.values()))
    assert "disagrees" in task.get("last_error", "")


def test_repeated_failures_park_the_task(cluster, rng):
    _corrupt_survivor_and_break(cluster, rng)
    for _ in range(cluster.sched.MAX_ATTEMPTS + 2):
        if not cluster.worker.run_once():
            break
    assert next(iter(cluster.sched.tasks.values()))["state"] == "parked"
    assert cluster.worker.run_once() is False  # nothing left to lease


def test_mq_compacts_acked_prefix(tmp_path):
    q = mq.MessageQueue(str(tmp_path / "q"), topic="t")
    q.COMPACT_THRESHOLD = 100
    for i in range(250):
        q.put({"i": i})
    batch1 = q.poll(64)
    batch2 = q.poll(130)[64:130]
    for off, _ in batch1 + batch2:
        q.ack(off)  # crosses the threshold mid-way
    assert q.backlog() == 250 - 130
    assert [m["i"] for _, m in q.poll(5)] == [130, 131, 132, 133, 134]
    assert len(q._mem) < 250
    q2 = mq.MessageQueue(str(tmp_path / "q"), topic="t")
    assert q2.backlog() == 120
    assert [m["i"] for _, m in q2.poll(3)] == [130, 131, 132]
    os.unlink(str(tmp_path / "q" / "t.offset"))
    got = [m["i"] for _, m in mq.MessageQueue(str(tmp_path / "q"), topic="t").poll(500)]
    assert got[0] <= 130 and got[-1] == 249  # replay, never loss


def test_scheduler_checkpoints_into_cm_kv(tmp_path):
    cm = clustermgr.ClusterMgr(data_dir=str(tmp_path / "cm"), allow_colocated_units=True)
    s1 = scheduler.Scheduler(cm, device="cpu")
    with s1._lock:
        s1.tasks["t1"] = {"task_id": "t1", "kind": "repair", "state": "leased", "disk_id": 1}
        s1.tasks["t2"] = {"task_id": "t2", "kind": "repair", "state": "pending", "disk_id": 2}
    s1._kv_flush_now()
    assert cm.kv_get("sched/tasks")
    s2 = scheduler.Scheduler(cm, device="cpu")
    assert set(s2.tasks) == {"t1", "t2"} and s2.tasks["t1"]["state"] == "pending"
    s_empty = scheduler.Scheduler(cm, device="cpu")
    with s_empty._lock:
        s_empty.tasks.pop("t1", None)
        s_empty.tasks.pop("t2", None)
        s_empty._kv_synced = False
        s_empty.tasks["t3"] = {"task_id": "t3", "kind": "repair", "state": "pending",
                               "disk_id": 3}
    s_empty._kv_flush_now()
    assert set(json.loads(cm.kv_get("sched/tasks"))) == {"t1", "t2", "t3"}
    cm.snapshot()
    cm2 = clustermgr.ClusterMgr(data_dir=str(tmp_path / "cm"), allow_colocated_units=True)
    assert set(scheduler.Scheduler(cm2, device="cpu").tasks) == {"t1", "t2", "t3"}
    for s in (s1, s2, s_empty):
        s.stop()


def test_put_admits_encode_before_alloc(cluster, rng):
    data = payload(rng, 200_000)
    loc = cluster.access.put(data, codemode=cmode.CodeMode.EC6P3)
    tl = cluster.access.last_put_timeline
    assert tl["encode_admitted"] <= tl["alloc_done"] <= tl["encode_done"] <= tl["quorum_done"]
    assert "encode_resolved_before_wait" in tl
    assert cluster.access.get(loc) == data


def test_disk_drain_planned_in_codec_steps(cluster, rng, monkeypatch):
    for _ in range(6):
        cluster.access.put(payload(rng, 60_000), codemode=cmode.CodeMode.EC6P3)
    disk_id = max(cluster.cm.disks, key=lambda d: len(cluster.cm.volumes_on_disk(d)))
    n = cluster.sched.mark_disk_broken(disk_id)
    tasks = [t for t in cluster.sched.tasks.values() if t.get("src_disk") == disk_id]
    assert n == len(tasks) >= 2
    per = [t["drain_bytes"] for t in tasks]
    assert all(b > 0 for b in per)
    total = sum(per)
    assert cluster.sched.last_drain_plan["steps"] == 1
    step_bytes = 2 * max(per)
    monkeypatch.setenv("CUBEFS_CODEC_STEP_BYTES", str(step_bytes))
    plan = cluster.sched.plan_disk_drain(disk_id)
    steps = len({t["drain_step"] for t in tasks})
    want = math.ceil(total / step_bytes)
    assert plan["steps"] == steps and want <= steps <= want + 1
    assert plan["total_bytes"] == total


def test_repair_records_the_served_leg(cluster, rng):
    """Every repair decode bumps ``repair_codec_leg`` with the leg that
    served it: ``cuda`` under ``cuda`` (staged), the table's leg under
    ``auto`` (a small stack: ``cpp``)."""
    loc = cluster.access.put(payload(rng, 40_000), codemode=cmode.CodeMode.EC6P3)
    victim = cluster.cm.get_volume(loc.slices[0].vid).units[1]
    legs0 = dict(metrics.repair_codec_leg.samples())
    cluster.node_of(victim.node_addr).break_disk(victim.disk_id)
    cluster.sched.mark_disk_broken(victim.disk_id)
    cluster.drain_worker()
    legs = {k[0]: v - legs0.get(k, 0) for k, v in metrics.repair_codec_leg.samples()}
    want = "cuda" if cluster.access.cfg.engine == "cuda" else "cpp"
    assert legs.get(want, 0) >= 1 and sum(legs.values()) == legs[want]


def test_chunk_store_is_the_ports_own(tmp_path):
    """The blobnode's stores load the port's library, built from its own
    copies of the native sources."""
    node = blobnode.BlobNode(0, [], None, device="cpu")
    node.attach_local(7, str(tmp_path / "d"))
    assert node.stores[7]._lib is chunkstore.load()
    assert os.path.basename(chunkstore.lib_path()).startswith("libchunkstore-")
    assert all(p.startswith(os.path.join(os.path.dirname(os.path.dirname(
        chunkstore.__file__)), "csrc")) for p in chunkstore.SOURCES)
    node.stop()


# ---------------- repairs: catalog records, shard tasks, the default engine ----------------

def _catalog(cm) -> dict:
    """The clustermgr state the catalog records write, plus the rest."""
    return json.loads(json.dumps(cm._state_dict()))


@pytest.mark.parametrize("port_snapshots", [False, True], ids=["port_wal", "port_snapshot"])
def test_catalog_records_open_in_both_packages(ref, tmp_path, port_snapshots):
    """The reference creates a space, splits it and repoints it after its
    last snapshot, so its WAL holds every shardnode-catalog record; the
    port opens that directory to the same state. The port then writes a
    catalog record of its own (and, in one case, snapshots), and the
    reference opens the result to the port's state."""
    d = str(tmp_path / "cm")
    w = ref.clustermgr.ClusterMgr(data_dir=d)
    w.create_space("s0", 2, ["sn0", "sn1", "sn2"])
    w.snapshot()
    w.create_space("s1", 3, ["sn1", "sn2", "sn3"])
    child = w.alloc_shard_id()
    w.register_split("s0", 1, child, "4000")
    w.update_shard_addrs("s1", 4, ["sn0", "sn2", "sn3"])
    w.register_split("s0", 1, child, "4000")  # a retried split: idempotent
    want = _catalog(w)
    w.fsm_stop()

    got = clustermgr.ClusterMgr(data_dir=d)
    assert _catalog(got) == want
    got.update_shard_addrs("s0", child, ["sn3", "sn1", "sn2"])
    if port_snapshots:
        got.snapshot()
    mine = _catalog(got)
    assert mine["spaces"]["s0"][1] == {"shard_id": child, "start": "4000", "end": "8000",
                                       "addrs": ["sn3", "sn1", "sn2"]}
    got.fsm_stop()
    assert _catalog(ref.clustermgr.ClusterMgr(data_dir=d)) == mine


class _StubShardnode:
    """A shardnode's two routes a shard swap calls, logged in order."""

    def __init__(self, addr: str, log: list):
        self.addr, self.log = addr, log

    def rpc_create_shard(self, args, body):
        self.log.append((self.addr, "create_shard", args))
        return {}

    def rpc_update_shard_peers(self, args, body):
        self.log.append((self.addr, "update_shard_peers", args))
        return {}


def test_reference_shard_task_runs_on_the_port(ref, tmp_path):
    """A shard_migrate task the reference's scheduler persisted is leased
    by the port's scheduler, run by the port's worker as the reference's
    replica swap (RPCs to the shardnodes only: the same calls in the same
    order as the reference's worker makes from the same state), and
    completed into the catalog; no volume unit is touched."""
    import shutil

    base = tmp_path / "ref"
    cm_r = ref.clustermgr.ClusterMgr(data_dir=str(base / "cm"))
    cm_r.create_space("s", 2, ["sn0", "sn1", "sn2"])
    cm_r.register_service("shardnode", "sn3")
    s_r = ref.scheduler.Scheduler(cm_r, data_dir=str(base / "sched"))
    tid = s_r.shard_migrate("s", 2, "sn1", "sn3")
    s_r.stop()
    cm_r.fsm_stop()
    shutil.copytree(base, tmp_path / "port")

    def run(pkg, root, **dev):
        cm_ = pkg.clustermgr.ClusterMgr(data_dir=str(root / "cm"))
        touched = []
        cm_.update_volume_unit = lambda *a, **k: touched.append(a)
        sched = pkg.scheduler.Scheduler(cm_, data_dir=str(root / "sched"), **dev)
        log, pool = [], pkg.rpc.NodePool()
        for i in range(4):
            pool.bind(f"sn{i}", _StubShardnode(f"sn{i}", log))
        wk = pkg.worker.RepairWorker(pkg.rpc.Client(sched), pkg.rpc.Client(cm_), pool,
                                     engine="numpy" if not dev else "cpp", **dev)
        assert wk.run_once() and not wk.run_once()
        out = (log, sched.tasks[tid]["state"], wk.completed, wk.failed, touched,
               _catalog(cm_)["spaces"])
        sched.stop()
        cm_.fsm_stop()
        return out

    got = run(PORT, tmp_path / "port", device="cpu")
    want = run(ref, base)
    assert got == want
    log, state, completed, failed, touched, spaces = got
    assert state == "done" and (completed, failed) == (1, 0) and touched == []
    assert [(a, m) for a, m, _ in log] == [("sn3", "create_shard"), ("sn3", "update_shard_peers"),
                                           ("sn0", "update_shard_peers"),
                                           ("sn2", "update_shard_peers"),
                                           ("sn1", "update_shard_peers")]
    assert spaces["s"][1]["addrs"] == ["sn0", "sn3", "sn2"]


def _port_engine(codec) -> str:
    """The engine name under a port engine or encoder, staged or not."""
    eng = (getattr(codec, "_eng", None) or getattr(codec, "_enc", None) or codec).engine
    return eng if isinstance(eng, str) else eng.engine


@pytest.mark.parametrize("port_env,ref_env", [(None, None), ("cuda", "tpu"), ("cpp", "cpp")],
                         ids=["unset", "cuda", "cpp"])
def test_engine_none_follows_the_environment(ref, monkeypatch, port_env, ref_env):
    """``engine=None`` on the access and the worker is the reference's
    default: ``CUBEFS_TPU_EC_ENGINE``, else the device (the reference's
    ``tpu`` is the port's ``cuda``)."""
    names = {}
    for pkg, env in ((PORT, port_env), (ref, ref_env)):
        if env is None:
            monkeypatch.delenv("CUBEFS_TPU_EC_ENGINE", raising=False)
        else:
            monkeypatch.setenv("CUBEFS_TPU_EC_ENGINE", env)
        dev = {"device": "cpu"} if pkg is PORT else {}
        cm = pkg.clustermgr.ClusterMgr()
        acc = pkg.access.AccessHandler(pkg.rpc.Client(cm), pkg.rpc.NodePool(),
                                       pkg.access.AccessConfig(engine=None, **dev))
        wk = pkg.worker.RepairWorker(pkg.rpc.Client(cm), pkg.rpc.Client(cm),
                                     pkg.rpc.NodePool(), engine=None, **dev)
        enc = acc._encoder(int(cmode.CodeMode.EC6P3))
        if pkg is PORT:
            names["port"] = (_port_engine(enc), _port_engine(wk.codec))
        else:
            names["ref"] = (enc.engine.name, wk.codec.name)
    alias = {"tpu": "cuda"}
    assert names["port"] == tuple(alias.get(n, n) for n in names["ref"])
    assert names["port"] == (port_env or "cuda",) * 2
