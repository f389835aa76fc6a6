"""The port's file-system plane (``cubefs_tpu_torch/fs``, ``utils/packet.py``
and the native extent store and read planes of ``csrc/host``) held
against the reference's on the CPU.

- every scenario of the reference's ``test_fs_e2e``, ``test_extent_store``,
  ``test_packet``, ``test_packet_mux``, ``test_native_data``,
  ``test_native_meta``, ``test_datanode_raft``, ``test_master_segments``,
  ``test_fs_topology``, ``test_meta_batch``, ``test_meta_tx``, ``test_quota``
  and ``test_disk_manager`` runs on
  the port (``port_copy``), none skipped. ``test_extent_store``'s
  ``test_block_crcs_match_tpu_kernel`` holds the store's block CRCs
  against the port's plain ``crc32_blocks``; ``test_packet_mux``'s wire
  view is the port's ``cli._wire_view`` reading the port's ``/metrics``
  text (``tests/test_torch_operators.py`` holds each view against the
  reference's on the same text);
- mixed clusters over real sockets: the port's ``FileSystem`` against the
  reference's master, metanodes and datanodes, and the reverse, over the
  packet plane and both native read planes; a write in one package and
  a read in the other are byte-identical;
- the on-disk formats open in both packages: extent files, a metanode's
  snapshot and oplog, the master's segment store and WAL;
- each switch the slice reads, flipped, gives the reference's result;
- the three doors that waited for later modules (the split engine, the
  flash read cache, the geo hooks) now serve as the reference's do.

Tolerance: exact equality. Every wait is a condition polled against a
deadline.
"""

import errno
import inspect
import json
import subprocess
import time
import types
import warnings

import numpy as np
import pytest
import torch

from cubefs_tpu_torch.ops import crc32_kernel
from cubefs_tpu_torch.parallel import raft
from cubefs_tpu_torch.utils import metrics, qos, rpc
from test_torch_raft import QUIET_ELECTION, port_copy, scenarios


class _Still:
    def snapshot(self):
        return {}


@pytest.fixture(autouse=True)
def _port_qos_still(monkeypatch):
    """The port's QoS gate pinned burn-free, as the repo's conftest pins
    the reference's."""
    monkeypatch.setattr(qos.DEFAULT, "_tracker", _Still())
    monkeypatch.setattr(qos.DEFAULT, "_levels", {})
    monkeypatch.setattr(qos.DEFAULT, "_last_refresh", float("-inf"))


FS_E2E = port_copy("test_fs_e2e")
MODULES = {
    "test_fs_e2e": FS_E2E,
    # the port's CRC takes a tensor and answers int64 (ROADMAP.md §3)
    "test_extent_store": port_copy("test_extent_store", crc32_kernel=types.SimpleNamespace(
        crc32_blocks=lambda a: crc32_kernel.crc32_blocks(torch.from_numpy(a)).numpy())),
    "test_packet": port_copy("test_packet"),
    "test_packet_mux": port_copy("test_packet_mux"),
    "test_native_data": port_copy("test_native_data", FsCluster=FS_E2E.FsCluster),
    "test_native_meta": port_copy("test_native_meta"),
    "test_datanode_raft": port_copy("test_datanode_raft"),
    "test_master_segments": port_copy("test_master_segments"),
    "test_fs_topology": port_copy("test_fs_topology"),
    "test_meta_batch": port_copy("test_meta_batch"),
    "test_meta_tx": port_copy("test_meta_tx"),
    "test_quota": port_copy("test_quota"),
    "test_disk_manager": port_copy("test_disk_manager"),
}
CASES = [(m, n) for m, mod in MODULES.items() for n in scenarios(mod)]


def run_in(mod, name, request):
    """Run scenario ``name`` of ``mod``: a fixture the module defines is
    built from the module's own definition (two modules define
    ``cluster`` differently), every other one comes from pytest."""
    made = {}

    def value(arg):
        if arg in made:
            return made[arg]
        fix = getattr(mod, arg, None)
        if not hasattr(fix, "_get_wrapped_function"):
            made[arg] = request.getfixturevalue(arg)
            return made[arg]
        fn = fix._get_wrapped_function()
        out = fn(**{a: value(a) for a in inspect.signature(fn).parameters})
        if inspect.isgenerator(out):
            gen, out = out, next(out)
            request.addfinalizer(lambda: next(gen, None))
        made[arg] = out
        return out

    fn = getattr(mod, name)
    fn(**{a: value(a) for a in inspect.signature(fn).parameters})


# Scenarios that check a raft group under its first leader: the master
# table replicated and a follower's redirect; group commit's entries and
# fsyncs over one leader's rounds. A follower starved of heartbeats past
# the default 0.15-0.30 s (a loaded host) elects a new leader mid-scenario,
# which is not what they check. Each node takes the long timeout once it
# knows a leader, so the first election (and a split vote's retry) runs on
# the default.
KEEP_LEADER = {("test_fs_e2e", "test_master_raft_replication"),
               ("test_meta_batch", "test_concurrent_creates_batch_entries_and_fsyncs")}


def keep_first_leader(monkeypatch) -> None:
    notify = raft.RaftNode._notify_role

    def quiet_once_led(self):
        notify(self)
        if self.leader is not None and self.ELECTION_MIN != QUIET_ELECTION[0]:
            self.ELECTION_MIN, self.ELECTION_MAX = QUIET_ELECTION
            self._election_due = self._rand_timeout()

    monkeypatch.setattr(raft.RaftNode, "_notify_role", quiet_once_led)


@pytest.mark.parametrize("module,name", CASES)
def test_reference_fs_scenario_on_the_port(module, name, request, monkeypatch):
    if (module, name) in KEEP_LEADER:
        keep_first_leader(monkeypatch)
    run_in(MODULES[module], name, request)


def test_keep_first_leader_pins_the_timeout_once_a_leader_is_known(monkeypatch):
    """The harness of ``KEEP_LEADER``: a 3-node group elects on the default
    timeout; once it has a leader every member holds the long timeout, and
    a member that hears no heartbeat for a second (its leader stopped)
    starts no election."""
    keep_first_leader(monkeypatch)
    pool = rpc.NodePool()
    addrs = ["k0", "k1", "k2"]
    nodes = {a: raft.RaftNode("k", a, addrs, lambda e: None, pool) for a in addrs}
    for a, n in nodes.items():
        host = types.SimpleNamespace(extra_routes={})
        raft.register_routes(host.extra_routes, n)
        pool.bind(a, host)
    assert all(n.ELECTION_MAX == raft.RaftNode.ELECTION_MAX for n in nodes.values())
    t0 = time.monotonic()
    for n in nodes.values():
        n.start()
    try:
        lead = wait_for(lambda: next((n for n in nodes.values() if n.status()["role"] == "leader"),
                                     None), 5.0, "a leader")
        assert time.monotonic() - t0 < QUIET_ELECTION[0]  # elected on the default
        wait_for(lambda: all(n.ELECTION_MIN == QUIET_ELECTION[0] for n in nodes.values()),
                 5.0, "every member pinned")
        term = lead.status()["term"]
        lead.stop()
        time.sleep(1.0)
        assert all(n.status()["term"] == term for n in nodes.values() if n is not lead)
    finally:
        for n in nodes.values():
            n.stop()


# ---------------- the two packages, side by side ----------------

# OSErrors met while loading the reference's native runtime (see load_ref_native)
REF_LOAD_ERRORS: list[str] = []


def load_ref_native(deadline_s: float = 120.0):
    """The reference's native runtime (``cubefs_tpu/runtime/build.py``),
    loaded in this process before any of its MetaNodes or DataNodes is
    built: ``load()`` keeps the library for the process, so they all find
    it. A reference test in another worker may be rebuilding it (its g++
    writes straight onto the library), and a load that meets the file
    half written fails (``OSError: ... file too short``; the reference's
    MetaNode would then serve on without its native plane). Such a load
    is recorded in ``REF_LOAD_ERRORS``, warned of, and retried until the
    rebuild is done."""
    from cubefs_tpu.runtime import build as ref_build

    end = time.monotonic() + deadline_s
    while True:
        try:
            return ref_build.load()
        except (OSError, subprocess.CalledProcessError) as e:
            REF_LOAD_ERRORS.append(repr(e))
            warnings.warn(f"the reference's native runtime did not load ({e!r}); retrying")
            if time.monotonic() > end:
                raise
            time.sleep(0.5)


@pytest.fixture(scope="module")
def ref():
    load_ref_native()
    from cubefs_tpu.fs.client import FileSystem as RefFileSystem
    from cubefs_tpu.fs.datanode import DataNode as RefDataNode
    from cubefs_tpu.fs.extent_store import ExtentStore as RefExtentStore
    from cubefs_tpu.fs.master import Master as RefMaster
    from cubefs_tpu.fs.metanode import MetaNode as RefMetaNode
    from cubefs_tpu.fs.metanode import MetaPartition as RefMetaPartition
    from cubefs_tpu.utils import faultinject as ref_fi
    from cubefs_tpu.utils import metrics as ref_metrics
    from cubefs_tpu.utils import packet as ref_packet
    from cubefs_tpu.utils import rpc as ref_rpc
    from test_fs_e2e import FsCluster as RefFsCluster

    return types.SimpleNamespace(
        name="ref", FileSystem=RefFileSystem, DataNode=RefDataNode, ExtentStore=RefExtentStore,
        Master=RefMaster, MetaNode=RefMetaNode, MetaPartition=RefMetaPartition,
        faultinject=ref_fi, metrics=ref_metrics, packet=ref_packet, rpc=ref_rpc,
        FsCluster=RefFsCluster)


def test_a_reference_load_during_its_rebuild_is_retried(monkeypatch):
    """``load_ref_native``: a load that meets the reference's library half
    rewritten by another worker's g++ (``OSError: file too short``) is
    recorded, warned of and retried; the next load's library is kept."""
    from cubefs_tpu.runtime import build as ref_build

    real, calls = ref_build.load, []
    torn = OSError("libcubefs_rt.so: file too short")

    def load():
        calls.append(1)
        if len(calls) == 1:
            raise torn
        return real()

    monkeypatch.setattr(ref_build, "load", load)
    n0 = len(REF_LOAD_ERRORS)
    with pytest.warns(UserWarning, match="did not load"):
        lib = load_ref_native()
    assert lib is real() and len(calls) == 2
    assert REF_LOAD_ERRORS[n0:] == [repr(torn)]


def _port():
    from cubefs_tpu_torch.fs.client import FileSystem
    from cubefs_tpu_torch.fs.datanode import DataNode
    from cubefs_tpu_torch.fs.extent_store import ExtentStore
    from cubefs_tpu_torch.fs.master import Master
    from cubefs_tpu_torch.fs.metanode import MetaNode, MetaPartition
    from cubefs_tpu_torch.utils import faultinject, packet, rpc

    return types.SimpleNamespace(
        name="port", FileSystem=FileSystem, DataNode=DataNode, ExtentStore=ExtentStore,
        Master=Master, MetaNode=MetaNode, MetaPartition=MetaPartition,
        faultinject=faultinject, metrics=metrics, packet=packet, rpc=rpc,
        FsCluster=FS_E2E.FsCluster)


PORT = _port()


def both(ref):
    return {"port": PORT, "ref": ref}


def wait_for(cond, timeout=20.0, what="condition"):
    deadline = time.monotonic() + timeout
    while True:
        try:
            got = cond()
        except Exception as e:  # a partition still electing its leader
            got, err = None, e
        else:
            err = None
        if got:
            return got
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}: {err}")
        time.sleep(0.05)


def first_mkdir(fs, path, timeout=20.0):
    """The first ``fs.mkdir(path)`` of a fresh volume, tried again while
    its partitions elect their leaders (``wait_for``). A try that raised
    may still have landed: a commit whose reply was lost or timed out.
    The next try is a new operation and answers EEXIST, so after a failed
    try EEXIST is that try's directory."""
    failed = []

    def attempt():
        try:
            fs.mkdir(path)
        except Exception as e:
            if failed and getattr(e, "errno", None) == errno.EEXIST:
                return True
            failed.append(e)
            raise
        return True
    return wait_for(attempt, timeout, what=f"the first mkdir of {path}")


def payloads(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in sizes]


# ---------------- mixed clusters over real sockets ----------------

class WireFs:
    """A master, metanodes and datanodes of one package, each behind its
    own HTTP server, binary packet plane and native read plane on
    127.0.0.1. Nothing is bound in process: every call between them, and
    every client call, crosses a socket."""

    def __init__(self, pkg, root, n_meta=2, n_data=3):
        self.pool = pkg.rpc.NodePool()
        self.servers, self.nodes = [], []
        self.master = pkg.Master(self.pool)
        self.master_addr = self._serve(pkg, self.master)
        self.metas, self.datas = [], []
        for i in range(n_meta):
            node = pkg.MetaNode(i, data_dir=str(root / f"{pkg.name}-meta{i}"),
                                node_pool=self.pool)
            node.addr = self._serve(pkg, node)
            psrv = node.serve_packets()
            self.servers.append(psrv)
            self.master.register_metanode(node.addr, packet_addr=psrv.addr,
                                          read_addr=node.serve_native())
            self.metas.append(node)
        for i in range(n_data):
            node = pkg.DataNode(i, str(root / f"{pkg.name}-data{i}"), "pending", self.pool)
            node.addr = self._serve(pkg, node)
            psrv = node.serve_packets()
            self.master.register_datanode(node.addr, packet_addr=psrv.addr,
                                          read_addr=node.serve_native())
            self.datas.append(node)
        self.view = self.master.create_volume("mix", mp_count=2, dp_count=2)
        assert all(m._native_h is not None for m in self.metas)
        assert all(d._native_h is not None for d in self.datas)

    def _serve(self, pkg, svc) -> str:
        srv = pkg.rpc.RpcServer(svc).start()
        self.servers.append(srv)
        return srv.addr

    def native_reads(self) -> tuple[int, int]:
        return (sum(d._native_lib.ds_op_count(d._native_h) for d in self.datas),
                sum(m._native_lib.ms_op_count(m._native_h) for m in self.metas))

    def stop(self):
        for n in (*self.metas, *self.datas):
            n.stop()
        for s in self.servers:
            s.stop()


def _close(fs):
    for cl in (*fs.meta._packet_clients.values(), *fs.data._packet_clients.values()):
        cl.close()


@pytest.mark.parametrize("cluster_pkg", ["ref", "port"])
def test_mixed_cluster_reads_the_other_package_writes(cluster_pkg, ref, tmp_path):
    """One package's master, metanodes and datanodes over real sockets, a
    client of each package on it: what one client writes (over the packet
    plane, chained to every replica) the other reads byte for byte, both
    through the native read planes (their op counters move) and, with the
    native addresses dropped from its view, over the packet plane."""
    pkgs = both(ref)
    other = "port" if cluster_pkg == "ref" else "ref"
    c = WireFs(pkgs[cluster_pkg], tmp_path)
    clients = {}
    try:
        for name in ("port", "ref"):
            clients[name] = pkgs[name].FileSystem(c.view, pkgs[name].rpc.NodePool())
        first_mkdir(clients[cluster_pkg], "/mix")
        data = dict(zip(("a", "b"), payloads(7, [(1 << 20) + 12_345, 70_001])))
        clients[other].write_file("/mix/from_other", data["a"])
        clients[cluster_pkg].write_file("/mix/from_cluster", data["b"])
        clients[other].rename("/mix/from_other", "/mix/renamed")
        d0, m0 = c.native_reads()
        assert clients[cluster_pkg].read_file("/mix/renamed") == data["a"]
        assert clients[other].read_file("/mix/from_cluster") == data["b"]
        assert clients[cluster_pkg].read_file("/mix/renamed", offset=4097, length=300_000) \
            == data["a"][4097:304_097]
        d1, m1 = c.native_reads()
        assert d1 > d0 and m1 > m0
        packet_view = dict(c.view, data_read_addrs={}, meta_read_addrs={})
        for name in ("port", "ref"):
            fs = pkgs[name].FileSystem(packet_view, pkgs[name].rpc.NodePool())
            try:
                assert fs.read_file("/mix/renamed") == data["a"]
                assert fs.read_file("/mix/from_cluster") == data["b"]
                assert sorted(fs.readdir("/mix")) == ["from_cluster", "renamed"]
            finally:
                _close(fs)
        assert c.native_reads()[0] == d1  # those reads took the packet plane
    finally:
        for fs in clients.values():
            _close(fs)
        c.stop()


# ---------------- the on-disk formats open in both packages ----------------

def _tree_bytes(root) -> dict:
    import os

    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _extent_ops(es, data):
    es.create(1)
    es.write(1, 0, data[0])
    es.write(1, 131_000, data[1])  # across a block boundary
    es.create(2)
    es.write(2, 5 * 131_072 + 17, data[2])  # sparse
    es.create(3)
    es.write(3, 0, data[0][:1000])
    es.delete(3)


def _extent_answers(es) -> dict:
    return {e: (es.size(e), bytes(es.read(e, 0, es.size(e))), list(es.block_crcs(e)),
                es.extent_crc(e)) for e in (1, 2)}


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_extent_files_open_in_both_packages(writer, ref, tmp_path):
    """The same writes give the same extent and CRC files in both
    packages; a store one package wrote opens in the other with the same
    sizes, bytes, block CRCs and extent CRC."""
    pkgs = both(ref)
    data = payloads(11, [300_000, 200_000, 77_777])
    for name, pkg in pkgs.items():
        with pkg.ExtentStore(str(tmp_path / name)) as es:
            _extent_ops(es, data)
    assert _tree_bytes(tmp_path / "port") == _tree_bytes(tmp_path / "ref")
    reader = "port" if writer == "ref" else "ref"
    with pkgs[writer].ExtentStore(str(tmp_path / writer)) as es:
        want = _extent_answers(es)
    with pkgs[reader].ExtentStore(str(tmp_path / writer)) as es:
        assert _extent_answers(es) == want
        es.write(2, 0, b"x" * 10)  # and writes on in the other's format
        assert bytes(es.read(2, 0, 10)) == b"x" * 10


def _meta_records(n):
    from cubefs_tpu_torch.fs import metanode as mn

    recs = [{"op": "mknod", "parent": mn.ROOT_INO, "name": "d", "type": mn.DIR,
             "mode": 0o755, "ts": 1.0, "op_id": "m-d"}]
    for i in range(n):
        recs.append({"op": "mknod", "parent": 2, "name": f"f{i}", "type": mn.FILE,
                     "mode": 0o644, "ts": 2.0 + i, "op_id": f"m-{i}"})
    recs += [{"op": "set_xattr", "ino": 3, "key": "user.k", "value": "v", "ts": 50.0},
             {"op": "append_extents", "ino": 4, "size": 4096, "ts": 51.0,
              "extents": [{"dp_id": 1, "extent_id": 9, "file_offset": 0, "ext_offset": 0,
                           "size": 4096}]},
             {"op": "rename_local", "src_parent": 2, "src_name": "f0", "dst_parent": 2,
              "dst_name": "g0", "ts": 52.0, "op_id": "m-r"},
             {"op": "unlink2", "parent": 2, "name": "f1", "ts": 53.0, "op_id": "m-u"}]
    return recs


def _meta_answers(mp) -> dict:
    return {"inodes": mp.inodes, "dentries": mp.dentries, "apply_id": mp.apply_id,
            "freelist": mp.freelist}


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_metanode_snapshot_and_oplog_open_in_both_packages(writer, ref, tmp_path):
    """A metapartition's checkpoint (its segment files and watermark) and
    the oplog tail after it: the same records give the same files in both
    packages, and a directory one wrote opens in the other with the same
    trees, apply id and freelist, and takes further records."""
    pkgs = both(ref)
    recs = _meta_records(40)
    for name, pkg in pkgs.items():
        mp = pkg.MetaPartition(1, 1, 1 << 20, data_dir=str(tmp_path / name))
        for r in recs[:20]:
            mp.submit(dict(r))
        mp.snapshot()
        for r in recs[20:]:
            mp.submit(dict(r))  # the tail lives only in the oplog
        mp._oplog.close()
    assert _tree_bytes(tmp_path / "port") == _tree_bytes(tmp_path / "ref")
    reader = "port" if writer == "ref" else "ref"
    want = _meta_answers(pkgs[writer].MetaPartition(1, 1, 1 << 20,
                                                    data_dir=str(tmp_path / writer)))
    mp = pkgs[reader].MetaPartition(1, 1, 1 << 20, data_dir=str(tmp_path / writer))
    assert json.loads(json.dumps(_meta_answers(mp))) == json.loads(json.dumps(want))
    mp.submit({"op": "set_xattr", "ino": 5, "key": "user.after", "value": "1", "ts": 60.0})
    assert mp.inodes[5]["xattr"]["user.after"] == "1"


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_master_segment_store_opens_in_both_packages(writer, ref, tmp_path):
    """The master's segmented snapshot (the native KV segment store) and
    its op WAL tail: what one package wrote, the other opens with the
    same volumes and allocators, and its next snapshot writes only the
    segments the replayed tail dirtied."""
    pkgs = both(ref)
    for name, pkg in pkgs.items():
        m = pkg.Master(pkg.rpc.NodePool(), data_dir=str(tmp_path / name),
                       allow_single_node=True)
        for i in range(30):
            m._commit({"op": "put_volume", "name": f"v{i:03d}",
                       "vol": {"name": f"v{i:03d}", "mps": [{"pid": 2 * i + 1}],
                               "dps": [{"dp_id": 2 * i + 1}]}})
        assert m.snapshot() >= 31
        m._commit({"op": "set_vol_capacity", "name": "v007", "capacity": 4242})
        m.fsm_stop()
    reader = "port" if writer == "ref" else "ref"
    m1 = pkgs[writer].Master(pkgs[writer].rpc.NodePool(), data_dir=str(tmp_path / writer),
                             allow_single_node=True)
    want = (json.loads(json.dumps(m1.volumes)), m1._next_pid, m1._next_dp)
    m1.fsm_stop()
    m2 = pkgs[reader].Master(pkgs[reader].rpc.NodePool(), data_dir=str(tmp_path / writer),
                             allow_single_node=True)
    try:
        assert (json.loads(json.dumps(m2.volumes)), m2._next_pid, m2._next_dp) == want
        assert m2.volumes["v007"]["capacity"] == 4242
        assert 1 <= m2.snapshot() <= 4
    finally:
        m2.fsm_stop()


# ---------------- every switch the slice reads, flipped ----------------

SWITCHES = {
    "CUBEFS_NATIVE_DATA": "0", "CUBEFS_NATIVE_META": "0", "CUBEFS_META_COALESCE": "0",
    "CUBEFS_META_FANOUT": "0", "CUBEFS_PKT_MUX": "0", "CUBEFS_PKT_CHUNK": "65536",
    "CUBEFS_PKT_WINDOW": "1", "CUBEFS_PKT_SRV_WORKERS": "2", "CUBEFS_VERIFY_READS": "0",
}


def drive(pkg, root) -> dict:
    """One client's deterministic workload on a package's in-process
    cluster (the reference's ``FsCluster``, packet and native planes on
    real sockets), and what each switch decides."""
    c = pkg.FsCluster(root)
    try:
        fs = c.fs
        first_mkdir(fs, "/w")
        data = payloads(5, [0, 1, 4096, 300_001, (1 << 20) + 3])
        reads = lambda: sum(d._native_lib.ds_op_count(d._native_h)  # noqa: E731
                            for d in c.datas if d._native_h is not None)
        for i, d in enumerate(data):
            fs.write_file(f"/w/f{i}", d)
        r0 = reads()
        back = [fs.read_file(f"/w/f{i}") for i in range(len(data))]
        fs.rename("/w/f1", "/w/g1")
        fs.unlink("/w/f2")
        listing = fs.readdir("/w")
        out = {
            "equal": back == data,
            "listing": sorted(listing),
            "sizes": {n: fs.stat(f"/w/{n}")["size"] for n in sorted(listing)},
            "echo_frames": echo_frames(pkg, data[3]),
            "native_data": [d._native_h is not None for d in c.datas],
            "native_reads": reads() > r0,
            "native_meta": [m._native_h is not None for m in c.metas],
            "coalesce": [m._coalesce for m in c.metas],
            "fanout": fs.meta.fanout.k if fs.meta.fanout is not None else 0,
            "mux": sorted({cl.mux for cl in (*fs.meta._packet_clients.values(),
                                             *fs.data._packet_clients.values())}),
            "window": pkg.packet.window_size(),
            "chunk": pkg.packet.chunk_size(),
            "srv_workers": [s._pool._max_workers for s in c.meta_packet_srvs],
        }
        _close(fs)
        return out
    finally:
        c.stop()


def echo_frames(pkg, payload) -> list:
    """The client's frames out and in for one echo of ``payload`` over a
    packet server of its own (``CUBEFS_PKT_CHUNK`` cuts it into a chunk
    train)."""
    srv = pkg.packet.PacketServer({pkg.packet.OP_PING: lambda h, a, p: ({}, bytes(p))},
                                  service="echo").start()
    cli = pkg.packet.PacketClient(srv.addr, timeout=10.0)
    try:
        frames = lambda d: pkg.metrics.pkt_frames.value(dir=d, side="client")  # noqa: E731
        f0 = (frames("tx"), frames("rx"))
        _, back = cli.call(pkg.packet.OP_PING, payload=payload)
        assert bytes(back) == payload
        return [frames("tx") - f0[0], frames("rx") - f0[1]]
    finally:
        cli.close()
        srv.stop()


def verify_reads(pkg, root, monkeypatch) -> dict:
    """A bit flipped in the leader's replica (the Python read plane): the
    read's bytes, the rot left and the healed count."""
    monkeypatch.setenv("CUBEFS_NATIVE_DATA", "0")
    c = pkg.FsCluster(root)
    try:
        first_mkdir(c.fs, "/v")
        payload = payloads(9, [120_000])[0]
        c.fs.write_file("/v/rot.bin", payload)
        ek = c.fs.meta.inode_get(c.fs.resolve("/v/rot.bin"))["extents"][0]
        dp = next(d for d in c.view["dps"] if d["dp_id"] == ek["dp_id"])
        plan = pkg.faultinject.FaultPlan(seed=11)
        pkg.faultinject.install(plan)
        try:
            node = c.data_node(dp["leader"])
            plan.plant_rot(dp["leader"], node._disk_index(ek["dp_id"]),
                           f"dp{ek['dp_id']}:e{ek['extent_id']}", "bitflip")
            healed = lambda: pkg.metrics.integrity_corruptions_healed.value(  # noqa: E731
                plane="fs", source="read")
            h0 = healed()
            fs = pkg.FileSystem(c.view, c.pool)
            got = fs.read_file("/v/rot.bin")
            fps = {c.data_node(a).extent_fingerprint(ek["dp_id"], ek["extent_id"])
                   for a in dp["replicas"]}
            return {"equal": got == payload, "rot_left": plan.rot_remaining(),
                    "healed": healed() - h0, "replicas_agree": len(fps) == 1}
        finally:
            pkg.faultinject.uninstall()
    finally:
        c.stop()


@pytest.mark.parametrize("var", sorted(SWITCHES))
def test_switch_flipped_gives_the_reference_result(var, ref, tmp_path, monkeypatch):
    """Each switch, flipped: the port's workload gives the reference's
    bytes, listing and sizes, and the switch decides the same thing in
    both (the flipped value differs from the default's)."""
    for v in SWITCHES:
        monkeypatch.delenv(v, raising=False)
    run = verify_reads if var == "CUBEFS_VERIFY_READS" else drive

    def results(tag):
        out = {}
        for name, pkg in both(ref).items():
            args = (pkg, tmp_path / f"{tag}-{name}")
            out[name] = run(*args, monkeypatch) if run is verify_reads else run(*args)
        return out

    default = results("default")
    monkeypatch.setenv(var, SWITCHES[var])
    flipped = results("flipped")
    assert flipped["port"] == flipped["ref"]
    assert default["port"] == default["ref"]
    assert flipped["port"] != default["port"]
    assert flipped["port"]["equal"] and default["port"]["equal"]


# ---------------- the doors of modules that came later ----------------

def test_unported_doors_raise_and_name_their_roadmap_item(tmp_path, monkeypatch):
    """The three doors that raised ``NotImplementedError`` until their
    modules were ported now serve as the reference's do: the master's
    lazy split engine and its ``meta_split``, ``meta_merge``,
    ``meta_balance`` and ``meta_status`` routes, the client's flash-tier
    read cache under ``CUBEFS_READ_CACHE`` with a flash group manager
    (``CUBEFS_READ_HOT`` its admission bar), and a partition's geo tap
    and follower mode, plain attributes. At their defaults nothing
    reaches them."""
    from cubefs_tpu_torch.fs.client import FileSystem
    from cubefs_tpu_torch.fs.master import Master
    from cubefs_tpu_torch.fs.metanode import MetaPartition
    from cubefs_tpu_torch.fs.remotecache import CachedReader, FlashGroupManager
    from cubefs_tpu_torch.fs.split import SplitEngine

    m = Master(rpc.NodePool(), allow_single_node=True)
    eng = m.split_engine()
    assert isinstance(eng, SplitEngine) and m.split_engine() is eng
    assert m.rpc_meta_status({}, b"") == {"door": False, "in_flight": {}, "volumes": {},
                                          "imbalance": 0}
    assert m.rpc_meta_balance({"auto": True}, b"")["skipped"]
    for route in ("meta_split", "meta_merge"):
        with pytest.raises(rpc.RpcError) as e:
            getattr(m, f"rpc_{route}")({"name": "v"}, b"")
        assert e.value.code == 404
    c = FS_E2E.FsCluster(tmp_path)
    try:
        monkeypatch.setenv("CUBEFS_READ_CACHE", "1")
        monkeypatch.setenv("CUBEFS_READ_HOT", "3")
        rc = FileSystem(c.view, c.pool, flash_fgm=FlashGroupManager()).read_cache
        assert isinstance(rc, CachedReader) and rc.hotness_threshold == 3
        assert FileSystem(c.view, c.pool).read_cache is None  # no flash group manager
    finally:
        c.stop()
    mp = MetaPartition(1, 1, 1 << 10)
    assert mp.geo_mode is None and mp.geo_tap is None
    tapped = []
    mp.geo_tap = tapped.append
    assert mp.submit({"op": "mknod", "parent": 1, "name": "x", "type": "file",
                      "mode": 0o644, "ts": 1.0})["ino"] == 2
    assert [r["name"] for r in tapped] == ["x"]
    mp.geo_mode, mp.geo_primary = "follower", "mn-r1"
    with pytest.raises(rpc.RpcError) as e:
        mp.submit({"op": "mknod", "parent": 1, "name": "y", "type": "file",
                   "mode": 0o644, "ts": 1.0})
    assert e.value.code == rpc.GEO_REDIRECT and "primary=mn-r1" in e.value.message
