"""The port's replicated blob control plane held against the reference's
on the CPU: the raft-replicated clustermgr (``utils/fsm.py`` over
``parallel/raft.py``) and the replicated repair/delete bus
(``blob/mq.py``'s ``ReplicatedQueue`` and ``QueueProducer``).

- ``test_clustermgr_raft_replication`` of ``tests/test_blob_e2e.py`` and
  the scenarios of ``tests/test_replicated_mq.py`` run on the port
  (``port_copy``: their source with each ``cubefs_tpu`` import pointed at
  the port);
- a port group and a reference group get the same operations over the
  RPC surface (a follower refuses them with 421 and the leader's
  address) and converge to the same ``_state_bytes`` on every member,
  also after a member restarts from its directory;
- a ``QueueProducer`` of either package fills the other's bus.

Every wait is a condition polled against a deadline.
"""

import json
import types

import pytest

from cubefs_tpu_torch.blob import clustermgr, mq
from cubefs_tpu_torch.utils import rpc
from test_torch_raft import port_copy, run_scenario, scenarios, wait_for

PORT = types.SimpleNamespace(clustermgr=clustermgr, mq=mq, rpc=rpc)
E2E = port_copy("test_blob_e2e")
MQ = port_copy("test_replicated_mq")
bus = MQ.bus  # the scenarios' fixture, over the port's ReplicatedQueue


@pytest.fixture(scope="module")
def ref():
    from cubefs_tpu.blob import clustermgr as ref_cm
    from cubefs_tpu.blob import mq as ref_mq
    from cubefs_tpu.utils import rpc as ref_rpc

    return types.SimpleNamespace(clustermgr=ref_cm, mq=ref_mq, rpc=ref_rpc)


def test_reference_clustermgr_raft_replication_on_the_port(tmp_path):
    E2E.test_clustermgr_raft_replication(tmp_path)


@pytest.mark.parametrize("name", scenarios(MQ))
def test_reference_mq_scenario_on_the_port(name, request):
    run_scenario(MQ, name, request)


NAMES = ["cma", "cmb", "cmc"]
OPS = ([("register_disk", {"node_addr": f"n{i // 3}", "path": f"/d{i}", "az": f"z{i % 2}",
                           "op_id": f"d{i}"}) for i in range(9)]
       + [("alloc_volume", {"codemode": 13, "op_id": "v1"}),
          ("alloc_bids", {"count": 16, "op_id": "b1"}),
          ("alloc_bids", {"count": 16, "op_id": "b1"}),  # a retry: replayed, not minted
          ("alloc_scope", {"name": "s", "count": 4}),
          ("set_config", {"key": "k", "value": "v"}),
          ("kv_set", {"key": "sched/tasks", "value": "{}"}),
          ("register_service", {"name": "proxy", "addr": "p0"}),
          ("set_disk_status", {"disk_id": 4, "status": 2}),
          ("alloc_volume", {"codemode": 13, "op_id": "v2"})])


def _group(pkg, root):
    pool = pkg.rpc.NodePool()
    cms = {n: pkg.clustermgr.ClusterMgr(data_dir=str(root / n), me=n, peers=NAMES,
                                        node_pool=pool, allow_colocated_units=True)
           for n in NAMES}
    for n, c in cms.items():
        pool.bind(n, c)
    return pool, cms


def _converged(cms) -> bytes:
    states = [c._state_bytes() for c in cms.values()]
    return states[0] if all(s == states[0] for s in states) else b""


def _canon(state: bytes) -> dict:
    """The state without the wall clock each registration stamps."""
    st = json.loads(state)
    for disk in st["disks"].values():
        assert disk.pop("last_heartbeat") > 0
    return st


def _drive(pkg, root) -> tuple[list, dict]:
    pool, cms = _group(pkg, root)
    try:
        leader = wait_for(lambda: next((c for c in cms.values() if c.is_leader()), None),
                          what="a clustermgr leader")
        wait_for(lambda: all(c.leader_addr() == leader.raft.me for c in cms.values()),
                 what="every member to name the leader")
        follower = next(c for c in cms.values() if c is not leader)
        assert follower.rpc_raft_status({}, b"")["role"] == "follower"
        with pytest.raises(pkg.rpc.RpcError) as ei:  # follower mutations redirect
            follower.rpc_alloc_bids({"count": 1}, b"")
        assert ei.value.code == 421 and ei.value.message == f"leader={leader.raft.me}"
        replies = [pool.get(leader.raft.me).call(m, a)[0] for m, a in OPS]
        state = wait_for(lambda: _converged(cms), what="the members' states to converge")
        name = follower.raft.me
        follower.fsm_stop()  # restart one member: the raft wal replays the FSM
        back = pkg.clustermgr.ClusterMgr(data_dir=str(root / name), me=name, peers=NAMES,
                                         node_pool=pool, allow_colocated_units=True)
        pool.bind(name, back)
        cms[name] = back
        wait_for(lambda: _converged(cms), what="the restarted member to catch up")
        assert back._state_bytes() == state
        return replies, _canon(state)
    finally:
        for c in cms.values():
            c.fsm_stop()


def test_replicated_clustermgr_converges_to_the_reference_state(ref, tmp_path):
    got = _drive(PORT, tmp_path / "port")
    want = _drive(ref, tmp_path / "ref")
    assert got == want
    replies, state = got
    assert replies[10] == replies[11]  # the retried alloc_bids
    assert len(state["volumes"]) == 2 and len(state["disks"]) == 9


@pytest.mark.parametrize("producer", ["port", "ref"])
def test_queue_producer_of_either_package_fills_the_bus(ref, tmp_path, producer):
    members = [{"port": PORT, "ref": ref}[p] for p in ("port", "ref", "port")]
    hosts, servers, queues = [], [], []
    for pkg in members:
        hosts.append(types.SimpleNamespace(extra_routes={}))
        servers.append(pkg.rpc.RpcServer(hosts[-1]).start())
    addrs = [s.addr for s in servers]
    try:
        for pkg, host, addr in zip(members, hosts, addrs):
            queues.append(pkg.mq.ReplicatedQueue("repair", addr, addrs, pkg.rpc.NodePool(),
                                                 data_dir=str(tmp_path / addr.replace(":", "_"))))
            host.extra_routes.update(queues[-1].extra_routes)
        wait_for(lambda: all(sum(q.rafts[p].status()["role"] == "leader" for q in queues) == 1
                             for p in range(2)), timeout=15, what="both partitions to elect")
        pkg = PORT if producer == "port" else ref
        prod = pkg.mq.QueueProducer("repair", addrs, pkg.rpc.NodePool())
        for i in range(8):
            prod.put({"vid": i})
        for q in queues:  # every member's poll sees every event
            got = wait_for(lambda: (lambda m: m if len(m) == 8 else None)(
                sorted(msg["vid"] for _, msg in q.poll(64))), what="the events")
            assert got == list(range(8))
        wait_for(lambda: {q.backlog() for q in queues} == {8}, what="replicated backlogs")
    finally:
        for q in queues:
            q.stop()
        for s in servers:
            s.stop()
