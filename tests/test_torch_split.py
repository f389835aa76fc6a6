"""The port's elastic metadata plane (``cubefs_tpu_torch/fs/split.py``, the
master's split ledger and the metanodes' range migration) held against the
reference's on the CPU.

- every scenario of the reference's ``tests/test_split.py`` runs on the
  port (``port_copy``), the phase-boundary chaos drill at every stage
  included, and so does every scenario of ``tests/test_topology.py``
  (zones, nodesets, selectors, and the append split of a full partition
  under racing creates);
- a master split ledger written by either package (a committed split,
  then a PREPARE left in flight) recovers in the other with the same
  range table, ``mp_version``, ledger and next pid, and the two packages
  drive the same operator split to the same table and namespace;
- ``CUBEFS_META_SPLIT`` flipped: the automatic sweep of both packages is
  inert when it is off and splits the same partition when it is on;
- the port metanode's ``mp_digest`` route answers the split tests' digest
  on every replica, and a client table that still names a partition a
  merge dropped answers 404 in both packages (a limit they share);
- over sockets, the master's per-replica calls (a split's target create,
  a merge's donor drop, the quota sweep's flags) reach the replica they
  name after its pool learned a partition's leader for a follower's
  address (the reference sends them to that leader instead);
- a client holding the map from before a split reads the moved inodes
  through the donor's native read plane, which redirects (453) where the
  reference's answers ENOENT.

Tolerance: exact equality. Every wait is a condition polled against a
deadline.
"""

import json
import time
import types

import pytest

from cubefs_tpu_torch.fs import master as port_master
from cubefs_tpu_torch.fs import metanode as port_metanode
from cubefs_tpu_torch.fs import split as port_split
from test_torch_raft import cases, port_copy, run_scenario

SPLIT = port_copy("test_split")
TOPOLOGY = port_copy("test_topology")


@pytest.mark.parametrize("name,params", cases(SPLIT))
def test_reference_split_scenario_on_the_port(name, params, request):
    run_scenario(SPLIT, name, request, params)


@pytest.mark.parametrize("name,params", cases(TOPOLOGY))
def test_reference_topology_scenario_on_the_port(name, params, request):
    run_scenario(TOPOLOGY, name, request, params)


cluster = SPLIT.cluster


# ---------------- the two packages, side by side ----------------

@pytest.fixture(scope="module")
def pkgs():
    import test_split as ref_split
    from cubefs_tpu.fs import master as ref_master
    from cubefs_tpu.fs import metanode as ref_metanode
    from cubefs_tpu.fs import split as ref_split_mod

    return {
        "ref": types.SimpleNamespace(tests=ref_split, master=ref_master,
                                     metanode=ref_metanode, split=ref_split_mod),
        "port": types.SimpleNamespace(tests=SPLIT, master=port_master,
                                      metanode=port_metanode, split=port_split),
    }


def _populate(c, n=40):
    """The same namespace in either package: a directory of ``n`` files
    with fixed ``ts`` (every record a replica applies is deterministic)."""
    fs = c.fs
    fs.mkdir("/t")
    for i in range(n):
        fs.write_file(f"/t/f{i:03d}", bytes([i]) * (100 + i))


def _digests(c) -> dict:
    """{pid: the partition's state digest} read off the first replica,
    after every replica agrees (``test_split.py``'s own digest)."""
    c.tests._assert_replicas_identical(c.cluster)
    out = {}
    for mp in c.cluster.master.client_view("vol1")["mps"]:
        addr = (mp.get("addrs") or [mp["addr"]])[0]
        out[mp["pid"]] = c.tests._mp_digest(c.cluster.meta_by_addr(addr), mp["pid"])
    return out


def _table(master) -> dict:
    view = master.client_view("vol1")
    return {"mp_version": view.get("mp_version", 0),
            "mps": [(p["pid"], p["start"], p["end"]) for p in
                    sorted(view["mps"], key=lambda p: p["start"])],
            "splits": json.loads(json.dumps(master.splits, sort_keys=True))}


def _names(fs) -> list[str]:
    return sorted(fs.readdir("/t"))


def test_same_split_gives_the_same_table_and_names(pkgs, tmp_path):
    """One operator split at a pinned point in each package: the same
    result keys and moved-inode count, the same range table and
    ``mp_version``, every file still readable through a stale client."""
    got = {}
    for side, pkg in pkgs.items():
        c = pkg.tests.SplitCluster(tmp_path / side)
        try:
            _populate(c)
            stale = c.fs
            mp = c.master.client_view("vol1")["mps"][0]
            res = c.master.split_engine().split("vol1", pid=mp["pid"],
                                                split_ino=mp["start"] + 20)
            got[side] = {
                "copied": res["copied_inodes"], "split_ino": res["split_ino"],
                "table": _table(c.master), "names": _names(stale),
                "reads": [stale.read_file(f"/t/f{i:03d}") for i in range(40)],
                "status": c.master.split_engine().status("vol1"),
            }
        finally:
            c.stop()
    assert got["port"] == got["ref"]
    assert got["port"]["table"]["mp_version"] == 1 and got["port"]["copied"] > 0


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_split_ledger_recovers_in_the_other_package(pkgs, tmp_path, writer):
    """A master data directory left by one package, with one split
    committed and a second one PREPAREd (the fault hook stops the drive
    there, as a crash would), opens in the other: the same range table,
    ``mp_version``, in-flight ledger and next pid; the reader's
    ``recover`` aborts the prepared split as the writer's would."""
    reader = "port" if writer == "ref" else "ref"
    c = pkgs[writer].tests.SplitCluster(tmp_path / "c")
    try:
        _populate(c)
        eng = c.master.split_engine()
        eng.split("vol1")

        def stop_at(stage, sid):
            if stage == "prepared":
                raise RuntimeError("crash")

        eng.fault_hook = stop_at
        with pytest.raises(RuntimeError, match="crash"):
            eng.split("vol1")
        before = _table(c.master)
        next_pid = c.master._next_pid
    finally:
        c.stop()
    assert before["mp_version"] == 1 and len(before["splits"]) == 1
    m = pkgs[reader].master.Master(c.pool, data_dir=str(tmp_path / "c" / "master"))
    assert _table(m) == before and m._next_pid == next_pid
    assert m.split_engine().recover() == sorted(before["splits"])
    assert m.splits == {} and _table(m)["mps"] == before["mps"]


def test_switch_meta_split_flipped_in_both_packages(pkgs, tmp_path, monkeypatch):
    """``CUBEFS_META_SPLIT`` gates only the automatic sweep: off, both
    packages' ``balance(auto=True)`` skip and leave every digest as it
    was; on, both split the same full partition, to the same table."""
    got = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("CUBEFS_META_SPLIT", flag)
        for side, pkg in pkgs.items():
            c = pkg.tests.SplitCluster(tmp_path / f"{side}{flag}")
            try:
                _populate(c)
                c.master.MP_SPLIT_THRESHOLD = 0.0
                monkeypatch.setattr(pkg.split, "MIN_SPLIT_SPAN", 1)
                before = _digests(types.SimpleNamespace(tests=pkg.tests, cluster=c))
                res = c.master.split_engine().balance(max_moves=1, auto=True)
                after = _digests(types.SimpleNamespace(tests=pkg.tests, cluster=c))
                got[(side, flag)] = {
                    "door": pkg.split.door_open(), "skipped": "skipped" in res,
                    "moves": [(a["kind"], a["pid"]) for a in res.get("actions", [])],
                    "table": _table(c.master), "same": before == after,
                    "names": _names(c.fresh_fs())}
            finally:
                c.stop()
    for flag in ("0", "1"):
        assert got[("port", flag)] == got[("ref", flag)]
    assert got[("port", "0")]["skipped"] and got[("port", "0")]["same"]
    assert got[("port", "1")]["moves"] and not got[("port", "1")]["skipped"]


def test_mp_digest_route_is_the_split_tests_digest(cluster):
    """The port metanode's ``mp_digest`` route answers, on every replica
    of every partition after a split, the digest ``tests/test_split.py``
    computes in process, and the replicas agree."""
    cluster.fs.mkdir("/d")
    for j in range(24):
        cluster.fs.create(f"/d/f{j}")
    cluster.master.split_engine().split("vol1")
    SPLIT._assert_replicas_identical(cluster)
    views = cluster.master.client_view("vol1")["mps"]
    assert len(views) == 2
    for mp in views:
        got = set()
        for a in mp.get("addrs") or [mp["addr"]]:
            node = cluster.meta_by_addr(a)
            out = node.rpc_mp_digest({"pid": mp["pid"]}, b"")
            assert out["digest"] == SPLIT._mp_digest(node, mp["pid"])
            assert out["apply_id"] == node.partitions[mp["pid"]].apply_id
            got.add(out["digest"])
        assert len(got) == 1


def test_a_table_naming_a_merged_away_partition_answers_404_in_both(pkgs, tmp_path):
    """The limit both packages share: a client that adopted the split's
    table asks the partition a later merge dropped for an inode of the
    moved range and gets 404; once it re-reads its view it stats the
    inode again, in both packages alike."""
    got = {}
    for side, pkg in pkgs.items():
        c = pkg.tests.SplitCluster(tmp_path / side)
        try:
            fs = c.fs
            fs.mkdir("/m")
            for j in range(20):
                fs.create(f"/m/f{j}")
            eng = c.master.split_engine()
            res = eng.split("vol1")
            assert fs.meta.refresh_view(force=True)
            ino = fs.stat("/m/f19")["ino"]
            assert ino >= res["split_ino"]
            eng.merge("vol1", donor_pid=res["target_pid"])
            with pytest.raises(Exception) as e:
                fs.meta.inode_get(ino)
            fs.meta.refresh_view(force=True)
            got[side] = (getattr(e.value, "code", None), "not on node" in str(e.value),
                         fs.meta.inode_get(ino)["ino"] == ino)
        finally:
            c.stop()
    assert got["port"] == got["ref"] == (404, True, True)


# ---------------- the master's per-replica calls over sockets ----------------

class HttpFs:
    """The port's master, 3 metanodes and 3 datanodes, each behind its own
    HTTP server (and the metanodes' packet planes) on 127.0.0.1: the
    master's pool holds HTTP clients, each with the leader it learned
    from a partition's 421 redirect, as in a launched cluster."""

    def __init__(self, root):
        from cubefs_tpu_torch.fs.datanode import DataNode
        from cubefs_tpu_torch.fs.metanode import MetaNode
        from cubefs_tpu_torch.utils import rpc

        self.servers, self.metas, self.datas, self.clients = [], [], [], []
        self.pool = rpc.NodePool()
        self.master = port_master.Master(self.pool, replicas=3)
        self.master_addr = self._serve(self.master)
        for i in range(3):
            node = MetaNode(i, data_dir=str(root / f"meta{i}"), node_pool=self.pool)
            node.addr = self._serve(node)
            psrv = node.serve_packets()
            self.servers.append(psrv)
            self.master.register_metanode(node.addr, packet_addr=psrv.addr)
            self.metas.append(node)
        for i in range(3):
            node = DataNode(i, str(root / f"data{i}"), "pending", self.pool)
            node.addr = self._serve(node)
            self.master.register_datanode(node.addr)
            self.datas.append(node)
        self.view = self.master.create_volume("vol1", mp_count=1, dp_count=1)

    def _serve(self, svc) -> str:
        from cubefs_tpu_torch.utils import rpc

        srv = rpc.RpcServer(svc).start()
        self.servers.append(srv)
        return srv.addr

    def node(self, addr: str):
        return next(m for m in self.metas if m.addr == addr)

    def leader(self, pid: int) -> str:
        """The partition's leader, once its replicas have elected one."""
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            lead = [m.addr for m in self.metas
                    if pid in m.rafts and m.rafts[pid].status()["role"] == "leader"]
            if lead:
                return lead[0]
            time.sleep(0.05)
        raise AssertionError(f"no leader for mp {pid}")

    def learn_leaders(self, pid: int) -> None:
        """What the master's own leader-following calls do (its quota
        sweep's usage pull, the split engine's fill read): each
        follower's address in its pool now points at the leader."""
        from cubefs_tpu_torch.utils import rpc

        lead = self.leader(pid)
        for m in self.metas:
            rpc.call_replicas(self.pool, [m.addr], "usage_report", {"pid": pid})
            assert self.pool.get(m.addr)._leader in (None, lead)
        assert any(self.pool.get(m.addr)._leader == lead
                   for m in self.metas if m.addr != lead)

    def client(self):
        """A client of the volume, once its partition serves a mkdir."""
        from cubefs_tpu_torch.fs.client import FileSystem
        from cubefs_tpu_torch.utils import rpc

        fs = FileSystem(self.view, rpc.NodePool(), master_addr=self.master_addr)
        self.clients.append(fs)
        deadline = time.monotonic() + 20
        while True:
            try:
                fs.mkdir("/d")
                return fs
            except Exception:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.1)

    def stop(self):
        for fs in self.clients:
            for cl in (*fs.meta._packet_clients.values(),
                       *fs.data._packet_clients.values()):
                cl.close()
        for n in (*self.metas, *self.datas):
            n.stop()
        for s in self.servers:
            s.stop()


@pytest.fixture
def http_fs(tmp_path):
    c = HttpFs(tmp_path)
    yield c
    c.stop()


def test_quota_flags_reach_every_replica_over_sockets(http_fs):
    """The quota sweep pushes its flags to every replica of a partition,
    each replica addressed itself, after the master's pool learned the
    partition's leader for a follower's address."""
    c = http_fs
    c.client().write_file("/d/f", b"x" * 4096)
    pid = c.view["mps"][0]["pid"]
    c.learn_leaders(pid)
    c.master.set_vol_capacity("vol1", 1)
    c.master.enforce_quotas()
    flags = {m.addr: m.partitions[pid].enforce["vol_full"] for m in c.metas}
    assert flags == {m.addr: True for m in c.metas}


def test_split_target_lands_on_every_replica_over_sockets(http_fs):
    """A split's target partition is created on every replica its table
    row names, and a merge drops the donor from every one, after the
    master's pool learned the donor's leader for a follower's address;
    the replicas' digests then agree through the ``mp_digest`` route."""
    from cubefs_tpu_torch.utils import rpc

    c = http_fs
    fs = c.client()
    for j in range(24):
        fs.create(f"/d/f{j}")
    donor = c.view["mps"][0]["pid"]
    c.learn_leaders(donor)
    res = c.master.split_engine().split("vol1")
    row = next(m for m in c.master.client_view("vol1")["mps"]
               if m["pid"] == res["target_pid"])
    assert sorted(row["addrs"]) == sorted(m.addr for m in c.metas)
    assert all(res["target_pid"] in c.node(a).partitions for a in row["addrs"])
    deadline = time.monotonic() + 20
    while True:
        digests = {rpc.call(a, "mp_digest", {"pid": res["target_pid"]})[0]["digest"]
                   for a in row["addrs"]}
        if len(digests) == 1 or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert len(digests) == 1
    c.learn_leaders(res["target_pid"])
    c.master.split_engine().merge("vol1", donor_pid=res["target_pid"])
    assert not any(res["target_pid"] in m.partitions for m in c.metas)
    fs.meta.refresh_view(force=True)
    assert sorted(fs.readdir("/d")) == sorted(f"f{j}" for j in range(24))


def _native_fs_cluster(pkg, root):
    """A master, 3 metanodes (each with its packet and native read
    planes) and 3 datanodes of one package, each behind its own HTTP
    server on 127.0.0.1; returns (master, metanodes, view, closers)."""
    import importlib

    mods = {m: importlib.import_module(f"{pkg}.{m}") for m in
            ("fs.master", "fs.metanode", "fs.datanode", "utils.rpc")}
    rpc = mods["utils.rpc"]
    closers, metas = [], []
    pool = rpc.NodePool()
    master = mods["fs.master"].Master(pool, replicas=3)

    def serve(svc):
        srv = rpc.RpcServer(svc).start()
        closers.append(srv.stop)
        return srv.addr

    master_addr = serve(master)
    for i in range(3):
        node = mods["fs.metanode"].MetaNode(i, data_dir=str(root / f"meta{i}"), node_pool=pool)
        node.addr = serve(node)
        psrv = node.serve_packets()
        closers.append(psrv.stop)
        master.register_metanode(node.addr, packet_addr=psrv.addr, read_addr=node.serve_native())
        metas.append(node)
        closers.insert(0, node.stop)
    for i in range(3):
        node = mods["fs.datanode"].DataNode(i, str(root / f"data{i}"), "pending", pool)
        node.addr = serve(node)
        master.register_datanode(node.addr)
        closers.insert(0, node.stop)
    return master, master_addr, metas, master.create_volume("vol1", mp_count=1, dp_count=1), closers


@pytest.mark.parametrize("pkg", ["cubefs_tpu_torch", "cubefs_tpu"])
def test_a_pre_split_map_reads_moved_inodes_through_the_native_plane(pkg, tmp_path):
    """A client that still holds the partition map from before a split
    asks the donor's native read plane for inodes the split moved. The
    port's plane redirects (453, the target pid) as the Python read
    fence does, and the client follows to the target; the reference's
    answers ENOENT from the trees the donor dropped (a fault the port
    repairs, so the reference's answer is pinned beside it)."""
    import importlib

    fsmod = importlib.import_module(f"{pkg}.fs.client")
    rpc = importlib.import_module(f"{pkg}.utils.rpc")
    master, master_addr, metas, view, closers = _native_fs_cluster(pkg, tmp_path)
    clients = []
    try:
        assert view["meta_read_addrs"]
        fs = fsmod.FileSystem(view, rpc.NodePool(), master_addr=master_addr)
        clients.append(fs)
        deadline = time.monotonic() + 30
        while True:
            try:
                fs.mkdir("/d")
                break
            except Exception:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.1)
        for j in range(24):
            fs.write_file(f"/d/f{j}", bytes([j]) * 100)
        inos = [fs.resolve(f"/d/f{j}") for j in range(24)]
        res = master.split_engine().split("vol1")
        moved = [i for i in inos if i >= res["split_ino"]]
        assert moved and res["donor_dropped"]
        stale = fsmod.FileSystem(view, rpc.NodePool(), master_addr=master_addr)
        clients.append(stale)
        native0 = sum(m._native_lib.ms_op_count(m._native_h) for m in metas)
        answers = {}
        for ino in moved:
            try:
                answers[ino] = stale.meta.inode_get(ino)["ino"]
            except fsmod.FsError as e:
                answers[ino] = e.errno
        assert sum(m._native_lib.ms_op_count(m._native_h) for m in metas) > native0
        if pkg == "cubefs_tpu_torch":
            assert answers == {i: i for i in moved}
            assert [stale.read_file(f"/d/f{j}") for j in range(24)] == [
                bytes([j]) * 100 for j in range(24)]
        else:
            assert answers == {i: 2 for i in moved}  # ENOENT
    finally:
        for c in clients:
            for cl in (*c.meta._packet_clients.values(), *c.data._packet_clients.values()):
                cl.close()
        for close in closers:
            close()
