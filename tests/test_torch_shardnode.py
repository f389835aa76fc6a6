"""The port's shardnode (``cubefs_tpu_torch/blob/shardnode.py``), the
clustermgr's space catalog and the scheduler's shard tasks held against
the reference's on the CPU.

- every scenario of ``tests/test_shardnode.py`` and the two shardnode
  scenarios of ``tests/test_tools.py`` run on the port (``port_copy``,
  with the port twins of ``test_tools``' helpers; the scheduler and the
  repair worker on ``device="cpu"``);
- shard groups mixing nodes of both packages, each node behind its own
  package's ``RpcServer`` on 127.0.0.1, take puts, a split and the loss
  of a leader, and end with equal items on every replica; the child
  group's term stays flat after the split (its routes were mounted on a
  running server and its heartbeats ride the node's one batched route);
- a node directory (``shards.json``, the shard KV stores, the shard raft
  logs) written by either package opens in the other;
- the catalog answers (``create_space``, ``alloc_shard_id``,
  ``register_split``, ``route_key``, ``get_space``, ``snapshot_spaces``)
  equal the reference's, and each package's clustermgr opens the other's
  WAL and snapshot with spaces in them.

Every lock of the port's nodes in this module is witnessed
(``lockwitness``). Every wait is a condition polled against a deadline.
"""

import functools
import socket
import time
import types

import numpy as np
import pytest

from cubefs_tpu_torch.blob import clustermgr, scheduler, shardnode, worker
from cubefs_tpu_torch.parallel import raft as raftlib
from cubefs_tpu_torch.utils import lockwitness, rpc
from test_torch_raft import free_ports, port_copy, run_scenario, scenarios, wait_for

PORT = types.SimpleNamespace(shardnode=shardnode, clustermgr=clustermgr, rpc=rpc)
TOOLS = port_copy("test_tools")
SN = port_copy("test_shardnode", _kv_call=TOOLS._kv_call, make_sn_cluster=TOOLS.make_sn_cluster,
               Scheduler=functools.partial(scheduler.Scheduler, device="cpu"),
               RepairWorker=functools.partial(worker.RepairWorker, device="cpu"))


@pytest.fixture(scope="module", autouse=True)
def witness():
    """Every lock the port's shardnodes, raft groups and clustermgrs take
    here is witnessed: a lock-order inversion or a lock held across an
    RPC raises where it happens."""
    with lockwitness.installed() as w:
        yield w
    assert w.stats()["acquisitions"] > 0


@pytest.fixture(scope="module")
def ref():
    from cubefs_tpu.blob import clustermgr as ref_cm
    from cubefs_tpu.blob import shardnode as ref_sn
    from cubefs_tpu.parallel import raft as ref_raft
    from cubefs_tpu.utils import rpc as ref_rpc

    return types.SimpleNamespace(shardnode=ref_sn, clustermgr=ref_cm, rpc=ref_rpc, raft=ref_raft)


@pytest.mark.parametrize("name", scenarios(SN))
def test_reference_shardnode_scenario_on_the_port(name, request):
    run_scenario(SN, name, request)


@pytest.mark.parametrize("name", ["test_shardnode_replicated_kv",
                                  "test_shardnode_leader_failover", "test_catalog_routing"])
def test_reference_tools_shardnode_scenario_on_the_port(name, request):
    run_scenario(TOOLS, name, request)


# ---------------- mixed shard groups over HTTP ----------------

class Node:
    """A shardnode of either package behind its own package's RpcServer
    at a static address, with a data directory. ``stop`` is a process's
    death: it also closes the connections the server accepted, whose
    handler threads would otherwise go on serving the stopped node to
    peers that keep them alive."""

    def __init__(self, pkg, i, addr, d):
        self.pkg, self.i, self.addr, self.d = pkg, i, addr, d
        self.start()

    def start(self):
        self.sn = self.pkg.shardnode.ShardNode(self.i, addr=self.addr,
                                               node_pool=self.pkg.rpc.NodePool(), data_dir=self.d)
        port = int(self.addr.rsplit(":", 1)[1])
        self.srv = self.pkg.rpc.RpcServer(self.sn, port=port, service="shardnode")
        self.conns = []
        accept = self.srv._httpd.process_request

        def tracked(request, client_address):
            self.conns.append(request)
            accept(request, client_address)

        self.srv._httpd.process_request = tracked
        self.srv.start()

    def stop(self):
        self.srv.stop()
        for c in self.conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass  # already closed by its peer
        self.sn.stop()

    def items(self, sid) -> list:
        sh = self.sn.shards.get(sid)
        return sh.items_in("", "") if sh is not None else None

    def role(self, sid) -> str | None:
        r = self.sn.rafts.get(sid)
        return r.status()["role"] if r is not None else None


def kv_call(nodes, method, args, body=b"", timeout=15.0):
    """A leader-following client over HTTP: 421 names the leader, a dead
    or not-yet-elected member moves on to the next."""
    deadline = time.monotonic() + timeout
    addrs = [n.addr for n in nodes]
    i = 0
    while time.monotonic() < deadline:
        addr = addrs[i % len(addrs)]
        i += 1
        try:
            return rpc.Client(addr, follow_redirects=False).call(method, args, body, timeout=3.0)
        except rpc.RpcError as e:
            if e.code not in (421, 404, 503):
                raise
            leader = e.message.removeprefix("leader=").strip() if e.code == 421 else ""
            if leader in addrs:
                i = addrs.index(leader)
        except OSError:
            pass
        time.sleep(0.05)
    raise TimeoutError(method)


def leader_of(nodes, sid):
    leaders = [n for n in nodes if n.role(sid) == "leader"]
    return leaders[0] if len(leaders) == 1 else None


@pytest.mark.parametrize("mix", ["ref_ref_port", "ref_port_port"])
def test_mixed_shard_group_over_http_puts_splits_and_fails_over(ref, tmp_path, monkeypatch, mix):
    # election timeouts of 0.6-1.2 s in both packages: a follower starved
    # of its heartbeats by a loaded host past the default 0.15-0.30 s
    # would re-elect, which the flat-term check must not confuse with
    # heartbeats that never arrive (those still re-elect within 3 s)
    for raft in (raftlib, ref.raft):
        monkeypatch.setattr(raft.RaftNode, "ELECTION_MIN", 0.6)
        monkeypatch.setattr(raft.RaftNode, "ELECTION_MAX", 1.2)
    pkgs = [{"ref": ref, "port": PORT}[p] for p in mix.split("_")]
    addrs = [f"127.0.0.1:{p}" for p in free_ports(3)]
    nodes = [Node(pkg, i, a, str(tmp_path / f"sn{i}")) for i, (pkg, a) in enumerate(zip(pkgs,
                                                                                        addrs))]
    rng = np.random.default_rng(13)
    want = {}
    try:
        for n in nodes:
            n.sn.create_shard(1, "", "", peers=addrs)
        for i in range(40):
            key, val = f"k{i:03d}", rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
            kv_call(nodes, "kv_put", {"shard_id": 1, "key": key}, val)
            want[key] = val
        meta = kv_call(nodes, "shard_split", {"shard_id": 1, "child_id": 2})[0]
        assert meta == {"child_id": 2, "split_key": "k020"}
        wait_for(lambda: all(n.sn.shards[1].end == "k020" and 2 in n.sn.shards for n in nodes),
                 what="the split on every replica")
        # the child group elects over routes mounted after its server started
        wait_for(lambda: leader_of(nodes, 2), timeout=10, what="a leader of the child")
        terms = [n.sn.rafts[2].status()["term"] for n in nodes]
        time.sleep(3.0)
        assert [n.sn.rafts[2].status()["term"] for n in nodes] == terms  # no re-election

        lost = wait_for(lambda: leader_of(nodes, 1), what="the parent's leader")
        lost.stop()  # the leader is lost; the other two elect and commit
        rest = [n for n in nodes if n is not lost]
        for i in range(40, 60):
            key = f"k{i:03d}" if i % 2 else f"a{i:03d}"  # both halves
            val = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
            kv_call(rest, "kv_put", {"shard_id": 1 if key < "k020" else 2, "key": key}, val)
            want[key] = val
        kv_call(rest, "kv_delete", {"shard_id": 1, "key": "k003"})
        del want["k003"]
        lost.start()  # back from its directory: replays, then catches up
        lower = sorted((k, v) for k, v in want.items() if k < "k020")
        upper = sorted((k, v) for k, v in want.items() if k >= "k020")
        wait_for(lambda: all(n.items(1) == lower and n.items(2) == upper for n in nodes),
                 timeout=20, what="equal items on every replica")
        got = kv_call(nodes, "kv_list", {"shard_id": 2, "prefix": "k05"})[0]["keys"]
        assert got == [k for k, _ in upper if k.startswith("k05")]
    finally:
        for n in nodes:
            n.stop()


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_node_directory_opens_in_both_packages(ref, tmp_path, direction):
    """A lone node's shards, split and items, written by one package and
    reopened by the other (solo shards: no raft group)."""
    writer, reader = (ref, PORT) if direction == "ref_to_port" else (PORT, ref)
    d = str(tmp_path / "sn")
    sn = writer.shardnode.ShardNode(0, addr="sn0", data_dir=d)
    sn.create_shard(1, "", "")
    sn.create_shard(7, "x", "")
    for i in range(30):
        sn.rpc_kv_put({"shard_id": 1, "key": f"k{i:02d}"}, bytes([i]) * (i + 1))
    sn.rpc_kv_delete({"shard_id": 1, "key": "k05"}, b"")
    assert sn.split_shard(1, 2) == {"child_id": 2, "split_key": "k15"}
    sn.rpc_kv_put({"shard_id": 7, "key": "xylo"}, b"phone")
    want = sn.rpc_list_shards({}, b""), {s: sh.items_in("", "") for s, sh in sn.shards.items()}
    manifest = open(f"{d}/shards.json", "rb").read()
    sn.stop()
    other = reader.shardnode.ShardNode(0, addr="sn0", data_dir=d)
    try:
        assert (other.rpc_list_shards({}, b""),
                {s: sh.items_in("", "") for s, sh in other.shards.items()}) == want
        assert other.rpc_kv_get({"shard_id": 2, "key": "k20"}, b"")[1] == bytes([20]) * 21
        other.rpc_kv_put({"shard_id": 2, "key": "k99"}, b"again")
    finally:
        other.stop()
    assert open(f"{d}/shards.json", "rb").read() == manifest  # the same inventory, unchanged


def _ref_tools():
    import test_tools

    return test_tools


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_replicated_node_directories_open_in_both_packages(ref, tmp_path, direction):
    """Three nodes of one package, each shard a raft group (its raft log
    in ``sn_<id>``), take puts and a split; the other package's nodes
    restart from those directories, elect over the logs they find, read
    every item and take more writes."""
    writer, reader = (ref, PORT) if direction == "ref_to_port" else (PORT, ref)
    tools = TOOLS if writer is PORT else _ref_tools()
    pool, nodes = tools.make_sn_cluster(tmp_path)
    want = {}
    try:
        for i in range(12):
            key = f"{'a' if i % 2 else 'p'}{i:02d}"
            tools._kv_call(pool, nodes, "kv_put", {"shard_id": 1 if key < "m" else 2,
                                                   "key": key}, bytes([i]) * 9)
            want[key] = bytes([i]) * 9
        assert tools._kv_call(pool, nodes, "shard_split",
                              {"shard_id": 1, "child_id": 3})[0]["child_id"] == 3
        # the child's raft group too: stopping a node while a split's
        # apply still adds that group races the node's stop
        wait_for(lambda: all(3 in sn.shards and 3 in sn.rafts for sn in nodes),
                 what="the split everywhere")
    finally:
        for sn in nodes:
            sn.stop()
    rtools = TOOLS if reader is PORT else _ref_tools()
    pool2 = reader.rpc.NodePool()
    nodes2 = []
    for i in range(3):
        sn = reader.shardnode.ShardNode(i, addr=f"sn{i}", node_pool=pool2,
                                        data_dir=str(tmp_path / f"sn{i}"))
        pool2.bind(f"sn{i}", sn)
        nodes2.append(sn)
    try:
        assert set(nodes2[0].shards) == {1, 2, 3} and set(nodes2[0].rafts) == {1, 2, 3}
        split_key = nodes2[0].shards[1].end
        for key, value in want.items():
            sid = 2 if key >= "m" else (3 if key >= split_key else 1)
            assert rtools._kv_call(pool2, nodes2, "kv_get", {"shard_id": sid, "key": key},
                                   timeout=15.0)[1] == value
        rtools._kv_call(pool2, nodes2, "kv_put", {"shard_id": 3, "key": split_key + "z"}, b"new")
        assert rtools._kv_call(pool2, nodes2, "kv_get",
                               {"shard_id": 3, "key": split_key + "z"})[1] == b"new"
    finally:
        for sn in nodes2:
            sn.stop()


# ---------------- the clustermgr's catalog ----------------

def _catalog(pkg, d, seed=7):
    """A seeded run of catalog calls: spaces, splits at random keys inside
    the routed shard, replica swaps; returns every answer."""
    rng = np.random.default_rng(seed)
    cm = pkg.clustermgr.ClusterMgr(data_dir=d)
    out = [cm.create_space("blobs", 4, ["sn0", "sn1", "sn2"]),
           cm.create_space("meta", 3, ["sn3", "sn4", "sn5"])]
    for _ in range(12):
        space = ["blobs", "meta"][int(rng.integers(0, 2))]
        key = format(int(rng.integers(0, 1 << 16)), "04x")
        shard = cm.route_key(space, key)
        child = cm.alloc_shard_id()
        split_key = key + "8"
        cm.register_split(space, shard["shard_id"], child, split_key)
        cm.register_split(space, shard["shard_id"], child, split_key)  # a retry
        cm.update_shard_addrs(space, child, ["sn9", "sn1", "sn2"])
        out.append((shard, child, cm.route_key(space, split_key)))
    try:
        cm.create_space("blobs", 1, ["sn0"])
    except ValueError as e:
        out.append(str(e))
    try:
        cm.register_split("blobs", 1, 99, "")
    except ValueError as e:
        out.append(str(e))
    out += [cm.get_space("blobs"), cm.snapshot_spaces(), cm.alloc_shard_id()]
    state = cm._state_bytes()
    cm.fsm_stop()
    return out, state


def test_catalog_answers_equal_the_reference(ref, tmp_path):
    got, got_state = _catalog(PORT, str(tmp_path / "port"))
    want, want_state = _catalog(ref, str(tmp_path / "ref"))
    assert got == want and got_state == want_state
    assert len(got[-3]) > 4  # the splits landed
    routes = []
    for pkg in (PORT, ref):
        cat = pkg.shardnode.Catalog()
        cat.create_space("s", [dict(x) for x in got[-2]["blobs"]])
        cat.apply_split("s", got[-2]["blobs"][0]["shard_id"], 500, "0001")
        routes.append([cat.route("s", format(k, "04x")) for k in range(0, 1 << 16, 997)])
    assert routes[0] == routes[1] and any(r["shard_id"] == 500 for r in routes[0])


@pytest.mark.parametrize("snapshot", [False, True])
@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_clustermgr_with_spaces_opens_in_both_packages(ref, tmp_path, direction, snapshot):
    writer, reader = (ref, PORT) if direction == "ref_to_port" else (PORT, ref)
    d = str(tmp_path / "cm")
    cm = writer.clustermgr.ClusterMgr(data_dir=d)
    cm.create_space("blobs", 4, ["sn0", "sn1", "sn2"])
    if snapshot:
        cm.snapshot()
    child = cm.alloc_shard_id()
    cm.register_split("blobs", 2, child, "5000")
    cm.update_shard_addrs("blobs", child, ["sn0", "sn3", "sn2"])
    want = cm._state_bytes(), cm.snapshot_spaces()
    cm.fsm_stop()
    other = reader.clustermgr.ClusterMgr(data_dir=d)
    try:
        assert (other._state_bytes(), other.snapshot_spaces()) == want
        assert other.route_key("blobs", "5a")["addrs"] == ["sn0", "sn3", "sn2"]
        assert other.alloc_shard_id() == child + 1
    finally:
        other.fsm_stop()


def test_suspect_dead_shardnodes_uses_the_heartbeat_window(ref, monkeypatch):
    """Liveness as the reference keeps it: only referenced, once-seen
    addresses past ``HEARTBEAT_TIMEOUT``; a short window, no sleeping."""
    out = []
    for pkg in (PORT, ref):
        cm = pkg.clustermgr.ClusterMgr()
        monkeypatch.setattr(cm, "HEARTBEAT_TIMEOUT", 0.5)
        cm.create_space("s", 2, ["sn0", "sn1", "sn2"])
        for a in ("sn0", "sn1", "sn9"):
            cm.shardnode_heartbeat(a)
        cm._sn_heartbeat["sn1"] -= 1.0
        cm._sn_heartbeat["sn9"] -= 1.0  # not referenced by any space
        out.append((cm.suspect_dead_shardnodes(), cm.shardnode_last_seen("sn2")))
    assert out[0] == out[1] == (["sn1"], None)


# ---------------- a replica swap after a split ----------------

def test_spare_of_a_split_child_gets_its_items_after_the_parent_compacts(tmp_path, monkeypatch):
    """A shard born of a split holds items that its own raft log never
    carried: the parent's split entry moved them in. Once the parent's
    log is compacted past that entry, a spare that replaces a member
    learns the parent from a snapshot taken after the split, so only the
    child's group can give it the child's items: the leader of a group
    begun with state ships a snapshot, not the log from index 1, to a
    member that needs the log from its start."""
    monkeypatch.setattr(raftlib.RaftNode, "COMPACT_THRESHOLD", 1 << 30)  # compacted below
    pool = rpc.NodePool()
    addrs = [f"sn{i}" for i in range(4)]
    replicas, spare = addrs[:3], addrs[3]
    nodes = {}
    for i, a in enumerate(addrs):
        nodes[a] = shardnode.ShardNode(i, addr=a, node_pool=pool, data_dir=str(tmp_path / a))
        pool.bind(a, nodes[a])
    try:
        for a in replicas:
            nodes[a].create_shard(1, "", "", peers=replicas)
        live = [nodes[a] for a in replicas]
        want = {f"k{i:02d}": bytes([i]) * 7 for i in range(40)}
        for key, value in want.items():
            TOOLS._kv_call(pool, live, "kv_put", {"shard_id": 1, "key": key}, value)
        split = TOOLS._kv_call(pool, live, "shard_split", {"shard_id": 1, "child_id": 5})[0]
        index = wait_for(lambda: leader_raft(live, 1) and leader_raft(live, 1).last_applied,
                         what="the split applied")
        wait_for(lambda: all(sn.rafts[1].last_applied >= index and 5 in sn.rafts for sn in live),
                 what="the split on every replica")
        for sn in live:
            sn.rafts[1].take_snapshot()  # the parent's log now begins after the split
            assert sn.rafts[1].log_base >= index
        victim = replicas[1]
        nodes[victim].stop()
        pool.bind(victim, object())  # a dead member: every call to it fails
        new = [spare if a == victim else a for a in replicas]
        for sid, start, end in ((1, "", split["split_key"]), (5, split["split_key"], "")):
            nodes[spare].create_shard(sid, start, end, peers=new)  # the repair worker's swap
            for a in new:
                nodes[a].update_shard_peers(sid, new)
        members = [nodes[a] for a in new]
        wait_for(lambda: sum(nodes[spare].shards[s].count() for s in (1, 5)) == len(want),
                 timeout=20.0, what="the spare to hold every item")
        for sid in (1, 5):
            assert dict(nodes[spare].shards[sid].items_in("", "")) == dict(
                members[0].shards[sid].items_in("", ""))
        for key, value in want.items():
            sid = 5 if key >= split["split_key"] else 1
            assert TOOLS._kv_call(pool, members, "kv_get", {"shard_id": sid, "key": key},
                                  timeout=15.0)[1] == value
    finally:
        for a, sn in nodes.items():
            if a != replicas[1]:
                sn.stop()


def leader_raft(nodes, sid):
    rafts = [sn.rafts[sid] for sn in nodes if sid in sn.rafts
             and sn.rafts[sid].status()["role"] == "leader"]
    return rafts[0] if len(rafts) == 1 else None
