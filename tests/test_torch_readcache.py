"""The port's flash read tier (``cubefs_tpu_torch/fs/remotecache.py``,
``fs/blockcache.py`` and the ``flashnode``/``flashgroupmanager`` roles)
held against the reference's on the CPU.

- every scenario of the reference's ``tests/test_readcache.py`` and
  ``tests/test_satellites.py`` runs on the port (``port_copy``); the
  satellites' blob plane is the port's on ``device="cpu"``. The two
  FlashNode scenarios of ``tests/test_tiering.py`` run with the rest of
  that file in ``tests/test_torch_tiering.py``, and the flashnode-death
  drill of ``tests/test_chaos.py`` in ``tests/test_torch_chaos.py``;
- a ``FlashGroupManager`` state blob (and WAL directory) written by
  either package loads in the other with the same groups, epoch and
  election of every key;
- the same reads through both packages' ``CachedReader``, each on its own
  cluster, give the same bytes, hits, misses and flash contents;
- ``CUBEFS_READ_CACHE`` and ``CUBEFS_READ_HOT`` flipped give the
  reference's outcome in both packages;
- the ``flashnode`` and ``flashgroupmanager`` roles of
  ``python -m cubefs_tpu_torch.cmd`` serve, heartbeat, and exit 0 on
  SIGTERM.

Tolerance: exact equality. Every wait is a condition polled against a
deadline.
"""

import functools
import json
import os
import signal
import subprocess
import sys
import types

import pytest

from cubefs_tpu_torch.blob import access, blobnode
from cubefs_tpu_torch.fs import remotecache as port_rc
from cubefs_tpu_torch.utils import rpc
from test_torch_raft import cases, port_copy, run_scenario, wait_for
from test_torch_tiering import _port_qos_still  # noqa: F401  (autouse: the port's QoS burn-free)

READCACHE = port_copy("test_readcache")
SATELLITES = port_copy(
    "test_satellites",
    AccessConfig=functools.partial(access.AccessConfig, device="cpu"),
    AccessHandler=access.AccessHandler,
    BlobNode=functools.partial(blobnode.BlobNode, device="cpu"))


@pytest.mark.parametrize("name,params", cases(READCACHE))
def test_reference_readcache_scenario_on_the_port(name, params, request):
    run_scenario(READCACHE, name, request, params)


@pytest.mark.parametrize("name,params", cases(SATELLITES))
def test_reference_satellites_scenario_on_the_port(name, params, request):
    run_scenario(SATELLITES, name, request, params)


cluster = READCACHE.cluster
fscluster = SATELLITES.fscluster


@pytest.fixture(autouse=True)
def _doors(monkeypatch):
    monkeypatch.delenv("CUBEFS_READ_CACHE", raising=False)
    monkeypatch.delenv("CUBEFS_READ_HOT", raising=False)


def _pkg(name):
    """The modules one package's read-tier scenarios use."""
    import importlib

    mods = ("fs.client", "fs.datanode", "fs.master", "fs.metanode", "fs.remotecache",
            "utils.rpc")
    return types.SimpleNamespace(**{m.split(".")[1]: importlib.import_module(f"{name}.{m}")
                                    for m in mods})


@pytest.fixture(scope="module")
def pkgs():
    return {"ref": _pkg("cubefs_tpu"), "port": _pkg("cubefs_tpu_torch")}


class RcCluster:
    """``test_readcache.py``'s cluster in either package: a master, 2
    metanodes, 3 datanodes and one flash group per AZ (``az1``, ``az2``),
    each of one flashnode of ``capacity`` bytes."""

    def __init__(self, pkg, tmp, capacity=256 << 20):
        self.pkg = pkg
        self.pool = pkg.rpc.NodePool()
        master = pkg.master.Master(self.pool)
        self.pool.bind("master", master)
        self.nodes = []
        for i in range(2):
            node = pkg.metanode.MetaNode(i, addr=f"meta{i}", node_pool=self.pool)
            self.pool.bind(f"meta{i}", node)
            master.register_metanode(f"meta{i}")
            self.nodes.append(node)
        for i in range(3):
            node = pkg.datanode.DataNode(i, str(tmp / f"d{i}"), f"data{i}", self.pool)
            self.pool.bind(f"data{i}", node)
            master.register_datanode(f"data{i}")
            self.nodes.append(node)
        self.view = master.create_volume("rcvol", mp_count=1, dp_count=2)
        self.fgm = pkg.remotecache.FlashGroupManager()
        self.flashes = {}
        for gid, az in ((1, "az1"), (2, "az2")):
            fn = pkg.remotecache.FlashNode(capacity_bytes=capacity)
            self.pool.bind(f"flash-{az}", fn)
            self.fgm.register_group(gid, [f"flash-{az}"], az=az)
            self.flashes[az] = fn

    def fs(self, **kw):
        return self.pkg.client.FileSystem(self.view, self.pool, **kw)

    def keys(self) -> dict:
        return {az: sorted(f._lru) for az, f in self.flashes.items()}

    def stop(self):
        for n in self.nodes:
            n.stop()


@pytest.fixture
def twins(pkgs, tmp_path):
    made = []

    def make(**kw):
        out = {side: RcCluster(pkg, tmp_path / f"{side}{len(made)}", **kw)
               for side, pkg in pkgs.items()}
        made.extend(out.values())
        return out

    yield make
    for c in made:
        c.stop()


# ---------------- the two packages, side by side ----------------

GROUPS = ((1, ["f-a0", "f-a1"], "az-a"), (2, ["f-b0"], "az-b"), (3, ["f-c0"], None))
KEYS = [f"{dp}/{ext}/{b}" for dp in (1, 2) for ext in (1, 7) for b in range(16)]


def _fgm_view(fgm) -> dict:
    return {"state": json.loads(fgm._state_bytes()), "ring": fgm.ring_info(),
            "elect": [fgm.elect_group(k, az) for k in KEYS for az in (None, "az-a", "az-b")]}


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_fgm_state_and_wal_load_in_the_other_package(pkgs, tmp_path, writer):
    """Group registrations, a status flip and a removal committed by one
    package's WAL-backed ``FlashGroupManager`` load in the other's from
    the same directory and from the state blob, with the same groups,
    epoch and election of every key from every AZ."""
    reader = "port" if writer == "ref" else "ref"
    w = pkgs[writer].remotecache.FlashGroupManager(data_dir=str(tmp_path / "fgm"))
    for gid, addrs, az in GROUPS:
        w.register_group(gid, addrs, az=az)
    w.register_group(4, ["f-x"], az="az-a")
    w.set_group_status(2, "inactive")
    w.set_group_status(2, "active")
    w.remove_group(4)
    want = _fgm_view(w)
    blob = w._state_bytes()
    r = pkgs[reader].remotecache.FlashGroupManager(data_dir=str(tmp_path / "fgm"))
    assert _fgm_view(r) == want and r.epoch == w.epoch == 7
    fresh = pkgs[reader].remotecache.FlashGroupManager()
    fresh._restore_bytes(blob)
    assert _fgm_view(fresh) == want


def test_slot_ring_and_election_are_the_reference_s(pkgs):
    """The same group registry routes every key to the same members and
    scope in both packages, before and after a group goes inactive."""
    views = []
    for pkg in pkgs.values():
        fgm = pkg.remotecache.FlashGroupManager()
        for gid, addrs, az in GROUPS:
            fgm.register_group(gid, addrs, az=az)
        one = _fgm_view(fgm)
        fgm.set_group_status(1, "inactive")
        views.append((one, _fgm_view(fgm), [fgm.slot_of(k) for k in KEYS]))
    assert views[0] == views[1]


def _files(n=8):
    return [(f"/rc/f{i}", READCACHE._payload(40_000 * (i + 1) + i, seed=i)) for i in range(n)]


@pytest.mark.parametrize("hot", [1, 2])
def test_cached_reads_match_the_reference_reader(twins, hot):
    """The same files read three rounds (the third over the last two)
    through each package's ``CachedReader`` on its own cluster, 768 KiB
    per flashnode so the rounds evict: the same bytes, the same running
    hit and miss counts, and the same keys left in each AZ's flashnode,
    at either hotness bar."""
    got = {}
    for side, c in twins(capacity=768 << 10).items():
        fs = c.fs()
        fs.mkdir("/rc")
        for path, data in _files():
            fs.write_file(path, data)
        rc = c.pkg.remotecache.CachedReader(fs.data, c.fgm, c.pool, client_az="az1",
                                            hotness_threshold=hot)
        reads = []
        for rnd in range(3):
            for path, data in _files()[6 if rnd == 2 else 0:]:
                inode = fs.stat(path)
                assert rc.read(inode, 0, inode["size"]) == data
                reads.append((rnd, path, rc.hits, rc.misses))
        got[side] = {"reads": reads, "keys": c.keys(),
                     "used": {az: f.stats() for az, f in c.flashes.items()}}
    assert got["port"] == got["ref"]
    assert got["port"]["reads"][-1][2] > 0  # the flash tier served


@pytest.mark.parametrize("flags", [{}, {"CUBEFS_READ_CACHE": "1"},
                                   {"CUBEFS_READ_CACHE": "1", "CUBEFS_READ_HOT": "1"},
                                   {"CUBEFS_READ_CACHE": "1", "CUBEFS_READ_HOT": "x"},
                                   {"CUBEFS_READ_CACHE": "0", "CUBEFS_READ_HOT": "5"}],
                         ids=["default", "cache", "cache_hot1", "cache_hot_bad", "off_hot5"])
def test_switch_read_cache_and_read_hot_flipped(twins, monkeypatch, flags):
    """Each setting of ``CUBEFS_READ_CACHE``/``CUBEFS_READ_HOT``: both
    packages' ``FileSystem`` build a read cache or not alike, with the
    same hotness bar; two reads of a file and an overwrite leave the same
    flash keys, and every read is exact."""
    for k, v in flags.items():
        monkeypatch.setenv(k, v)
    data = READCACHE._payload(300_000, seed=3)
    got = {}
    for side, c in twins().items():
        fs = c.fs(flash_fgm=c.fgm, client_az="az1")
        fs.write_file("/sw", data)
        rc = fs.read_cache
        reads = [fs.read_file("/sw") == data for _ in range(2)]
        keys = c.keys()
        fs.write_file("/sw", data[::-1])
        got[side] = {"cache": rc is not None, "hot": rc and rc.hotness_threshold,
                     "reads": reads, "keys": keys, "after_overwrite": c.keys(),
                     "read_back": fs.read_file("/sw") == data[::-1]}
    assert got["port"] == got["ref"]


# ---------------- the flash roles ----------------

def _role(tmp_path, cfg):
    path = tmp_path / f"{cfg['role']}-{len(os.listdir(tmp_path))}.json"
    path.write_text(json.dumps(dict(cfg, listen_port=0)))
    p = subprocess.Popen([sys.executable, "-m", "cubefs_tpu_torch.cmd", "-c", str(path)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    line = p.stdout.readline()
    assert f"[{cfg['role']}] listening on" in line, line
    return p, line.strip().rsplit(" ", 1)[-1]


def test_flash_roles_serve_heartbeat_and_exit_0(tmp_path):
    """A ``flashgroupmanager`` and a ``flashnode`` started by
    ``python -m cubefs_tpu_torch.cmd``: the node's capacity defaults to
    256 MiB, a group registered over RPC routes keys to it, it serves
    puts, gets and (idempotent) deletes, and both exit 0 on SIGTERM."""
    fgm_p, fgm = _role(tmp_path, {"role": "flashgroupmanager",
                                  "data_dir": str(tmp_path / "fgm")})
    procs = [fgm_p]
    try:
        fn_p, fn = _role(tmp_path, {"role": "flashnode", "fgm_addr": fgm})
        procs.append(fn_p)
        c, f = rpc.Client(fgm), rpc.Client(fn)
        assert f.call("stats")[0] == {"items": 0, "bytes": 0, "capacity": 256 << 20}
        c.call("register_group", {"group_id": 1, "addrs": [fn], "az": "az-a"})
        assert c.call("ring")[0]["groups"] == {"1": [fn]}
        f.call("cache_put", {"key": "1/2/3", "path": "fs.read"}, b"abc")
        assert f.call("cache_get", {"key": "1/2/3"})[1] == b"abc"
        assert f.call("cache_delete", {"key": "1/2/3"})[0] == {"deleted": True}
        assert f.call("cache_delete", {"key": "1/2/3"})[0] == {"deleted": False}
    finally:
        codes = []
        for p in reversed(procs):
            p.send_signal(signal.SIGTERM)
            codes.append(p.wait(timeout=30))
            p.stdout.close()
    assert codes == [0] * len(procs)


def test_flashnode_heartbeats_reach_its_manager(tmp_path, monkeypatch):
    """The flashnode role's heartbeat loop marks its address alive in the
    manager it names; a member that stops heartbeating drops out of the
    ring once its window passes (the reference's ``_member_alive``)."""
    fgm_obj = port_rc.FlashGroupManager()
    from cubefs_tpu_torch.utils.rpc import RpcServer

    srv = RpcServer(fgm_obj).start()
    try:
        fn_p, fn = _role(tmp_path, {"role": "flashnode", "fgm_addr": srv.addr,
                                    "capacity_bytes": 1 << 20})
        try:
            wait_for(lambda: fn in fgm_obj._hb, 20.0, "the flashnode's first heartbeat")
            assert rpc.Client(fn).call("stats")[0]["capacity"] == 1 << 20
            fgm_obj.register_group(1, [fn, "never-heartbeats"])
            assert fgm_obj.ring() == {1: [fn, "never-heartbeats"]}
            monkeypatch.setattr(fgm_obj, "HEARTBEAT_TIMEOUT", -1.0)
            assert fgm_obj.ring() == {1: ["never-heartbeats"]}
        finally:
            fn_p.send_signal(signal.SIGTERM)
            assert fn_p.wait(timeout=30) == 0
            fn_p.stdout.close()
    finally:
        srv.stop()
