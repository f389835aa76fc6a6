"""The port's blob roles over HTTP (``cubefs_tpu_torch/cmd.py``,
``deploy/cluster.py``) and the server half they need (``utils/auditlog.py``,
``RpcServer``'s ``/spans`` and ``/traces``, the slow-trace log), held
against the reference's (``cubefs_tpu``) on the CPU.

Each comparison runs the same calls through both packages: the audit
records, the slow-trace capture and renderings under a ``FakeClock`` and
seeded ids, a server of each package over one route table, each role's
route set, the launcher's cluster against the reference's in-process
cluster (byte for byte), the HTTP-stitched PUT and repair traces, and
the port's access role writing through the reference's clustermgr and
blobnode processes. Two clusters of processes are spawned, each with a
timeout.
"""

import ctypes
import hashlib
import http.client
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest

from cubefs_tpu_torch import cmd
from cubefs_tpu_torch.blob import access, blobnode, clustermgr, mq, proxy, scheduler, worker
from cubefs_tpu_torch.codec import codemode as cmode
from cubefs_tpu_torch.deploy import cluster as deploy
from cubefs_tpu_torch.fs import s3auth
from cubefs_tpu_torch.utils import auditlog, qos, rpc
from cubefs_tpu_torch.utils import trace as tracelib
from cubefs_tpu_torch.utils.retry import MONOTONIC, FakeClock
from test_torch_raft import free_ports
from test_torch_s3_mixed import OWNER, STRANGER

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = types.SimpleNamespace(auditlog=auditlog, trace=tracelib, rpc=rpc, FakeClock=FakeClock,
                             MONOTONIC=MONOTONIC, clustermgr=clustermgr, proxy=proxy)
BLOB = 64 << 10

@pytest.fixture(scope="module")
def ref():
    from cubefs_tpu import cmd as ref_cmd
    from cubefs_tpu.blob import clustermgr as ref_cm
    from cubefs_tpu.blob import proxy as ref_proxy
    from cubefs_tpu.utils import auditlog as ref_audit
    from cubefs_tpu.utils import rpc as ref_rpc
    from cubefs_tpu.utils import trace as ref_trace
    from cubefs_tpu.utils.retry import MONOTONIC as ref_mono
    from cubefs_tpu.utils.retry import FakeClock as RefFakeClock

    return types.SimpleNamespace(auditlog=ref_audit, trace=ref_trace, rpc=ref_rpc,
                                 FakeClock=RefFakeClock, MONOTONIC=ref_mono, cmd=ref_cmd,
                                 clustermgr=ref_cm, proxy=ref_proxy)


@pytest.fixture
def traces(ref, monkeypatch):
    """Both packages' collectors empty, their clocks real and their
    slow-trace logs closed before and after (the state is process-wide);
    the trace doors at their defaults."""
    for var in ("CUBEFS_TRACE", "CUBEFS_TRACE_SAMPLE", "CUBEFS_SLOW_MS"):
        monkeypatch.delenv(var, raising=False)

    def reset():
        for pkg in (PORT, ref):
            pkg.trace.reset_collector()
            pkg.trace.set_clock(pkg.MONOTONIC)
            log, pkg.trace._slow_log = pkg.trace._slow_log, None
            if log is not None:
                log.close()

    reset()
    yield
    reset()


@pytest.fixture
def still_qos(monkeypatch):
    """The port's QoS gate pinned burn-free, as the repo's conftest pins
    the reference's."""
    class _Still:
        def snapshot(self):
            return {}

    monkeypatch.setattr(qos.DEFAULT, "_tracker", _Still())
    monkeypatch.setattr(qos.DEFAULT, "_levels", {})
    monkeypatch.setattr(qos.DEFAULT, "_last_refresh", float("-inf"))


def payload(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def http_get(addr: str, path: str):
    host, port = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def http_post(addr: str, method: str, args: dict, body: bytes = b"", headers=None):
    host, port = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    try:
        conn.request("POST", f"/{method}", body=body,
                     headers={"X-Rpc-Args": json.dumps(args), **(headers or {})})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.headers.get("X-Rpc-Resp") or "{}"), resp.read()
    finally:
        conn.close()


def records(path, drop=()) -> list[dict]:
    """A jsonl file's records, without the keys in ``drop``."""
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k not in drop} for line in f]


def audit_records(path, n: int, drop=(), timeout: float = 10.0) -> list[dict]:
    """The audit log's records once it holds ``n`` (a server writes a
    call's record after its reply), sorted: calls close in any order."""
    deadline = time.time() + timeout
    while True:
        recs = records(path, drop) if os.path.exists(path) else []
        if len(recs) >= n or time.time() > deadline:
            return sorted(recs, key=lambda r: json.dumps(r, sort_keys=True))
        time.sleep(0.01)


# ---------------- audit log ----------------

def _audit_rotation(pkg, d):
    log = pkg.auditlog.AuditLogger(str(d / "audit.log"), max_bytes=500, keep=3)
    for i in range(40):
        log.record("svc", "op", 200, 0.001, detail=f"req {i}")
    log.close()
    return sorted(os.listdir(d)), [records(d / f, ("ts",)) for f in sorted(os.listdir(d))]


def _audit_tenant(pkg, d):
    log = pkg.auditlog.AuditLogger(str(d / "audit.log"))
    log.record("access", "put", 200, 0.01, tenant="acme", trace_id="t1", detail="x" * 300)
    log.record("access", "get", 500, 0.0123456)  # anonymous: field omitted
    log.close()
    return records(d / "audit.log", ("ts",))


@pytest.mark.parametrize("case", [_audit_rotation, _audit_tenant], ids=["rotation", "tenant"])
def test_audit_log_equals_the_reference(ref, tmp_path, case):
    """The same records through each package's logger: the same files and
    the same records, wall-clock stamps aside."""
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    got, want = case(PORT, tmp_path / "port"), case(ref, tmp_path / "ref")
    assert got == want and got


# ---------------- slow traces ----------------

def _slow_scenario(pkg, path):
    t = pkg.trace
    t.configure_slow_log(path)
    clock = pkg.FakeClock(5.0)
    t.set_clock(clock)
    t.seed_ids(0x5107)
    with t.path_span("blob.get", "access.get") as sp:
        sp.set_tag("svc", "access")
        slow = sp.trace_id
        with t.stage("read"):
            clock.advance(0.2)
        with t.stage("decode"):
            clock.advance(0.03)
    with t.path_span("blob.put", "access.put", tenant="acme"):
        clock.advance(0.001)  # fast
    try:
        with t.path_span("blob.put", "access.put"):
            with t.stage("quorum_write"):
                clock.advance(0.09)
                raise RuntimeError("lost quorum")
    except RuntimeError:
        pass
    remote = t.from_header("blobnode.put_shard", f"{slow}:abcd:1:blob.get")
    with remote:
        clock.advance(0.5)  # a hop with a remote parent is never a root
    ids = t.known_trace_ids()
    return {"ids": ids, "slow": t.slow_traces(top=5), "slow_1": t.slow_traces(top=1),
            "summary": {i: t.stage_summary(i) for i in ids},
            "render": {i: t.render_tree(t.trace_tree(i)) for i in ids},
            "log_path": os.path.basename(t.slow_log_path()), "file": records(path)}


@pytest.mark.parametrize("slow_ms", [None, "50", "100"], ids=["unset", "50ms", "100ms"])
def test_slow_traces_equal_the_reference(ref, traces, tmp_path, monkeypatch, slow_ms):
    if slow_ms is not None:
        monkeypatch.setenv("CUBEFS_SLOW_MS", slow_ms)
    got = _slow_scenario(PORT, str(tmp_path / "port" / "slowtrace.jsonl"))
    want = _slow_scenario(ref, str(tmp_path / "ref" / "slowtrace.jsonl"))
    assert got == want
    n = {None: 0, "50": 2, "100": 1}[slow_ms]  # roots of 230, 1 and 90 ms
    assert len(got["slow"]) == len(got["file"]) == n
    assert {r["trace_id"] for r in got["file"]} == {r["trace_id"] for r in got["slow"]}
    assert "read=200.0ms decode=30.0ms" in got["summary"].values()


# ---------------- RpcServer: /spans, /traces and the audit records ----------------

def _routes(pkg, clock):
    t = pkg.trace

    def ok(args, body):
        with t.path_span("blob.put", "access.put") as sp:
            sp.set_tag("svc", "access")
            with t.stage("quorum_write"):
                clock.advance(0.04)
        return {"n": len(body)}, body[::-1]

    def missing(args, body):
        raise pkg.rpc.RpcError(404, "no such blob")

    def boom(args, body):
        with t.stage("decode"):
            clock.advance(0.002)
        raise RuntimeError("decode failed")

    return {"ok": ok, "missing": missing, "boom": boom}


def _serve_and_call(pkg, d, tenant_header):
    pkg.trace.seed_ids(0x5E7)
    clock = pkg.FakeClock(50.0)
    pkg.trace.set_clock(clock)
    audit = pkg.auditlog.AuditLogger(str(d / "access.audit.log"))
    srv = pkg.rpc.RpcServer(_routes(pkg, clock), service="access", audit=audit).start()
    try:
        replies = [http_post(srv.addr, "ok", {}, b"abc"),
                   http_post(srv.addr, "missing", {}),
                   http_post(srv.addr, "boom", {}),
                   http_post(srv.addr, "nope", {}),  # not a route: no record
                   http_post(srv.addr, "ok", {}, b"xy", {"X-Trace": tenant_header})]
        spans = json.loads(http_get(srv.addr, "/spans")[1])
        tid = spans[0]["trace_id"]
        one = json.loads(http_get(srv.addr, f"/spans?trace_id={tid}")[1])
        tree = json.loads(http_get(srv.addr, f"/traces?trace_id={tid}")[1])
        listing = json.loads(http_get(srv.addr, "/traces?top=3")[1])
        other = http_get(srv.addr, "/nothing")
        recs = audit_records(d / "access.audit.log", 4, ("ts", "lat_ms"))
    finally:
        srv.stop()
        audit.close()
    return {"replies": replies, "spans": spans, "one": one, "tree": tree, "listing": listing,
            "other": other, "audit": recs, "slowtrace": records(d / "slowtrace.jsonl")}


@pytest.mark.parametrize("slow_ms", [None, "0.001"], ids=["fast", "slow"])
def test_rpc_server_spans_traces_and_audit_equal_the_reference(ref, traces, tmp_path,
                                                                monkeypatch, slow_ms):
    if slow_ms is not None:
        monkeypatch.setenv("CUBEFS_SLOW_MS", slow_ms)
    hdr = "00000000000000aa:00000000000000bb:1:blob.put:acme"
    got, want = ({}, {})
    for pkg, out in ((PORT, got), (ref, want)):
        d = tmp_path / ("port" if pkg is PORT else "ref")
        d.mkdir()
        out.update(_serve_and_call(pkg, d, hdr))
    assert got == want
    assert [r[0] for r in got["replies"]] == [200, 404, 500, 404, 200]
    assert sorted((r["op"], r["code"]) for r in got["audit"]) == [
        ("boom", 500), ("missing", 404), ("ok", 200), ("ok", 200)]
    assert [r.get("tenant") for r in got["audit"] if r["trace"] == "00000000000000aa"] == ["acme"]
    assert "access.put" in got["tree"]["render"] and got["other"][0] == 404
    details = {(r["op"], r.get("detail")) for r in got["audit"]}
    if slow_ms:
        assert details == {("ok", "quorum_write=40.0ms"), ("missing", None),
                           ("boom", "decode=2.0ms")}
        # the clock stands still in "missing": 0 ms is under the threshold
        assert [r["root_op"] for r in got["slowtrace"]] == ["access.ok", "access.boom"]
    else:
        assert {d for _, d in details} == {None} and got["slowtrace"] == []


# ---------------- the roles: route sets, raft configs, shutdown ----------------

def _served(srv) -> set:
    routes = set(srv.routes)
    if srv._target is not None:
        routes |= {n[len("rpc_"):] for n in dir(srv._target) if n.startswith("rpc_")}
        routes |= set(getattr(srv._target, "extra_routes", {}) or {})
    return routes


def _ref_close(srv, svc):
    for name in ("stop", "fsm_stop"):
        fn = getattr(svc, name, None)
        if callable(fn):
            fn()
    srv.stop()


ROLES = ["clustermgr", "blobnode", "proxy", "access", "scheduler", "codec"]


@pytest.fixture(scope="module")
def role_cm(tmp_path_factory):
    """A port clustermgr role in this process: the upstream of the roles
    under test (the reference's roles register with it over HTTP)."""
    d = tmp_path_factory.mktemp("role_cm")
    srv, svc = cmd.run_role({"role": "clustermgr", "data_dir": str(d / "cm"),
                             "allow_colocated_units": True, "device": "cpu"})
    yield srv.addr
    assert cmd.shutdown(srv, svc) == 0


@pytest.mark.parametrize("role", ROLES)
def test_role_route_set_equals_the_reference(ref, traces, still_qos, role_cm, tmp_path,
                                             monkeypatch, role):
    monkeypatch.setenv("CUBEFS_TPU_EC_ENGINE", "numpy")  # the reference's codec role

    def run(pkg_cmd, tag, **dev):
        d = tmp_path / tag
        cfg = {"role": role, "listen_port": 0, "clustermgr_addr": role_cm,
               "audit_dir": str(d / "audit"), "data_dirs": [str(d / "bn0")],
               "data_dir": str(d / role), **dev}
        srv, svc = pkg_cmd.run_role(cfg)
        try:
            return _served(srv), http_post(srv.addr, "no_such_route", {})[0]
        finally:
            if pkg_cmd is cmd:
                assert cmd.shutdown(srv, svc) == 0
            else:
                _ref_close(srv, svc)

    got, code = run(cmd, "port", device="cpu")
    want, ref_code = run(ref.cmd, "ref")
    assert got == want and code == ref_code == 404
    assert os.path.exists(tmp_path / "port" / "audit" / f"{role}.audit.log")


def _space_and_scrub_calls(addr: str, prefix: str) -> list:
    """The catalog's routes (under ``prefix``) and, on a scheduler, its
    scrub routes, with refusals among them: every reply's code and JSON."""
    def call(method, args, prefix=prefix):
        code, meta, _ = http_post(addr, prefix + method, args)
        return method, code, meta

    out = [call("create_space", {"name": "meta", "shard_count": 4,
                                 "addrs": ["sn0", "sn1", "sn2"]}),
           call("create_space", {"name": "meta", "shard_count": 2, "addrs": ["sn0"]}),
           call("create_space", {"name": "big", "shard_count": 5000, "addrs": ["sn0"]}),
           call("route_key", {"space": "meta", "key": "a-key"}),
           call("alloc_shard_id", {}),
           call("register_split", {"space": "meta", "parent_id": 3, "child_id": 5,
                                   "split_key": "a0"}),
           call("route_key", {"space": "meta", "key": "a1"}),
           call("shardnode_heartbeat", {"addr": "sn0"}),
           call("update_shard_addrs", {"space": "meta", "shard_id": 5,
                                       "addrs": ["sn0", "sn3", "sn2"]}),
           call("get_space", {"name": "meta"}),
           call("get_space", {"name": "nope"}),
           call("route_key", {"space": "nope", "key": "x"})]
    if prefix:  # a scheduler: its scrubber over a catalog with no volumes
        out += [call(m, a, prefix="") for m, a in (
            ("scrub_status", {}), ("scrub_run", {"max_units": 2}), ("scrub_run", {"full": True}),
            ("scrub_status", {}))]
    return out


@pytest.mark.parametrize("role", ["clustermgr", "scheduler"])
def test_space_and_scrub_routes_answer_as_the_reference(ref, traces, still_qos, tmp_path,
                                                        role):
    def run(pkg_cmd, tag, **dev):
        d = tmp_path / tag
        srv, svc = pkg_cmd.run_role({"role": role, "listen_port": 0, "data_dir": str(d / "cm"),
                                     "task_dir": str(d / "tasks"), **dev})
        try:
            return _space_and_scrub_calls(srv.addr, "cm_" if role == "scheduler" else "")
        finally:
            if pkg_cmd is cmd:
                assert cmd.shutdown(srv, svc) == 0
            else:
                _ref_close(srv, svc)

    got, want = run(cmd, "port", device="cpu"), run(ref.cmd, "ref")
    assert got == want
    codes = [c for _, c, _ in got]
    assert codes[:3] == [200, 409, 409] and codes[10:12] == [404, 404]
    assert got[6][2]["shard"]["shard_id"] == 5 and len(got[9][2]["shards"]) == 5
    if role == "scheduler":
        assert got[12][2] == {"scrub": None}
        assert got[14][2]["result"]["plane"] == "blob" and got[15][2]["scrub"]["cursor"] is None


def _free_addr() -> str:
    return f"127.0.0.1:{free_ports(1)[0]}"


def _raft_cfg(case: str, role_cm: str, d) -> dict:
    """A replicated config with static addresses: a lone member of a
    3-member clustermgr group, access producing into a bus, or a
    one-member bus hosted by a scheduler."""
    me = _free_addr()
    port = int(me.rsplit(":", 1)[1])
    if case == "clustermgr_peers":
        return {"role": "clustermgr", "listen_port": port, "me": me, "data_dir": str(d / "cm"),
                "peers": [me, _free_addr(), _free_addr()]}
    if case == "access_mq_members":
        return {"role": "access", "listen_port": 0, "clustermgr_addr": role_cm,
                "mq_members": [_free_addr(), _free_addr()], "blob_size": BLOB}
    return {"role": "scheduler", "listen_port": port, "mq_me": me, "mq_peers": [me],
            "mq_dir": str(d / "mq"), "data_dir": str(d / "cm")}


def _raft_roles(srv, svc, case) -> dict:
    """What the role's raft half answers: its raft_status, the bus's
    partitions once each has elected, or the producers' topics."""
    if case == "clustermgr_peers":
        return {"raft": http_post(srv.addr, "raft_status", {})[1]["role"]}
    if case == "access_mq_members":
        return {q.topic: (type(q).__name__, q.n) for q in (svc.repair_queue, svc.delete_queue)}
    deadline = time.time() + 15
    while True:
        st = http_post(srv.addr, "mq_status", {})[1]
        roles = {t: [p["role"] for p in st[t]["partitions"]] for t in ("repair", "delete")}
        if roles == {"repair": ["leader"] * 2, "delete": ["leader"] * 2} or time.time() > deadline:
            return roles


@pytest.mark.parametrize("case", ["clustermgr_peers", "access_mq_members", "scheduler_mq_peers"])
def test_raft_config_serves_the_reference_routes(ref, traces, still_qos, role_cm, tmp_path,
                                                case):
    def run(pkg_cmd, tag, **dev):
        srv, svc = pkg_cmd.run_role(dict(_raft_cfg(case, role_cm, tmp_path / tag), **dev))
        try:
            return _served(srv), _raft_roles(srv, svc, case)
        finally:
            if pkg_cmd is cmd:
                assert cmd.shutdown(srv, svc) == 0
            else:
                _ref_close(srv, svc)
                for n in ("repair_queue", "delete_queue"):
                    getattr(getattr(svc, n, None), "stop", lambda: None)()

    got, got_raft = run(cmd, "port", device="cpu")
    want, want_raft = run(ref.cmd, "ref")
    role = case.split("_")[0]
    assert got == want
    if case == "clustermgr_peers":  # a lone member of three: it cannot win an election
        assert {got_raft["raft"], want_raft["raft"]} <= {"follower", "candidate"}
    else:
        assert got_raft == want_raft == {
            "access_mq_members": {"repair": ("QueueProducer", 2),
                                  "delete": ("QueueProducer", 2)},
            "scheduler_mq_peers": {"repair": ["leader"] * 2, "delete": ["leader"] * 2}}[case]
    if case == "scheduler_mq_peers":
        assert {r for r in got if r.startswith("raft_")} == {"raft_hb_batch"} | {
            f"raft_mq_{t}_p{p}_{k}" for t in ("repair", "delete") for p in (0, 1)
            for k in ("vote", "append", "snapshot")}


def test_scheduler_bus_heartbeats_every_topic(tmp_path):
    """Both topics' groups share the scheduler's one batched-heartbeat
    route, so no follower of either topic misses its leader's
    heartbeats (a merge of the two queues' tables would drop the first
    topic's groups from it)."""
    me = _free_addr()
    srv, svc = cmd.run_role({"role": "scheduler", "listen_port": int(me.rsplit(":", 1)[1]),
                             "mq_me": me, "mq_peers": [me], "mq_dir": str(tmp_path / "mq"),
                             "data_dir": str(tmp_path / "cm"), "device": "cpu"})
    try:
        groups = srv.routes["__raft_groups__"]
        assert sorted(groups) == [f"mq_{t}_p{p}" for t in ("delete", "repair") for p in (0, 1)]
        # a heartbeat of a later term to every group: a group the route's
        # registry misses answers {"ok": False, "term": 0}
        items = [[gid, {"term": 99, "leader": "x", "prev_index": 0, "prev_term": 0,
                        "entries": [], "commit": 0}] for gid in sorted(groups)]
        replies = dict(srv.routes["raft_hb_batch"]({"items": items}, b"")["replies"])
        assert {gid: (r["ok"], r["term"]) for gid, r in replies.items()} == \
            {gid: (True, 99) for gid in groups}
    finally:
        assert cmd.shutdown(srv, svc) == 0


class _Closer:
    def __init__(self, log, fail=()):
        self.log, self.fail = log, fail

    def __getattr__(self, name):
        if name not in ("stop", "fsm_stop"):
            raise AttributeError(name)

        def step():
            self.log.append(name)
            if name in self.fail:
                raise OSError(f"{name} failed")
        return step


@pytest.mark.parametrize("fail,rc", [((), 0), (("stop",), 1), (("fsm_stop", "srv"), 1)],
                         ids=["clean", "stop_fails", "fsm_and_server_fail"])
def test_shutdown_runs_every_step_and_exits_1_on_an_error(capsys, fail, rc):
    log = []
    srv = types.SimpleNamespace(stop=_Closer(log, ("stop",) if "srv" in fail else ()).stop)
    assert cmd.shutdown(srv, _Closer(log, fail)) == rc
    assert log == ["stop", "fsm_stop", "stop"]
    err = capsys.readouterr().err
    assert all(f"{n} failed" in err for n in fail if n != "srv") and (rc == 0) == (err == "")


def test_proxy_allocator_equals_the_reference(ref):
    """The proxy's volume and bid leases over twin clustermgrs, through
    its routes (``alloc``, ``invalidate``)."""
    out = []
    for pkg in (PORT, ref):
        cm = pkg.clustermgr.ClusterMgr(allow_colocated_units=True)
        for i in range(12):
            cm.register_disk(f"node{i % 4}", f"/d{i}")
        p = pkg.proxy.ProxyAllocator(pkg.rpc.Client(cm))
        p.BID_BATCH = 16
        p.VOLUME_REUSE = 3
        calls = [p.rpc_alloc({"codemode": int(cmode.CodeMode.EC6P3), "count": c}, b"")
                 for c in (1, 2, 1, 20, 3)]
        p.rpc_invalidate({"codemode": int(cmode.CodeMode.EC6P3)}, b"")
        calls.append(p.rpc_alloc({"codemode": int(cmode.CodeMode.EC6P3), "count": 1}, b""))
        out.append([(c["volume"]["vid"], c["min_bid"]) for c in calls])
    assert out[0] == out[1]
    assert len({vid for vid, _ in out[0]}) > 2  # the volume rotated and was invalidated


# ---------------- wire compatibility: the port's access on the reference's roles ----------------

def test_port_access_writes_through_the_reference_roles(ref, tmp_path, rng, monkeypatch):
    """The reference's clustermgr and four blobnodes (``python -m
    cubefs_tpu.cmd``, on the CPU) behind the port's access role; the
    reference's ``rpc.call`` PUTs and GETs through it, and the data rows
    on the reference's blobnodes are the payload."""
    from cubefs_tpu.deploy import cluster as ref_deploy

    monkeypatch.setenv("JAX_PLATFORMS", "cpu")  # the reference's processes inherit it
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    procs = []

    def spawn(pkg_proc, role, cfg):
        cfg["role"] = role
        procs.append(pkg_proc(role, cfg, str(tmp_path)))
        return procs[-1]

    try:
        cm = spawn(ref_deploy.Proc, "clustermgr", {"data_dir": str(tmp_path / "cm")})
        cm_addr = cm.wait_addr(timeout=120.0)
        nodes = [spawn(ref_deploy.Proc, "blobnode", {
            "name": f"blobnode{i}", "node_id": i, "clustermgr_addr": cm_addr,
            "data_dirs": [str(tmp_path / f"bn{i}d{d}") for d in range(3)]}) for i in range(4)]
        for n in nodes:
            n.wait_addr(timeout=120.0)
        acc = spawn(deploy.Proc, "access", {"clustermgr_addr": cm_addr, "blob_size": BLOB,
                                            "device": "cpu"})
        acc_addr = acc.wait_addr(timeout=120.0)
        deadline = time.time() + 60
        while len(ref.rpc.call(cm_addr, "list_disks")[0]["disks"]) < 12:
            assert time.time() < deadline, "the blobnodes did not register"
            time.sleep(0.2)
        data = payload(rng, 2 * BLOB + 777)
        meta, _ = ref.rpc.call(acc_addr, "put", {"codemode": int(cmode.CodeMode.EC6P3)}, data)
        _, got = ref.rpc.call(acc_addr, "get", {"location": meta["location"]})
        assert got == data
        sl = meta["location"]["slices"][0]
        vol = ref.rpc.call(cm_addr, "get_volume", {"vid": sl["vid"]})[0]["volume"]
        t = cmode.tactic(cmode.CodeMode.EC6P3)
        rows = [ref.rpc.call(u["node_addr"], "get_shard", {
            "disk_id": u["disk_id"], "chunk_id": u["chunk_id"], "bid": sl["min_bid"]})[1]
            for u in vol["units"][: t.n]]
        assert b"".join(rows)[:BLOB] == data[:BLOB]
    finally:
        for p in procs:
            p.p.terminate()
        for p in procs:
            try:
                p.p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.p.kill()
                p.p.wait()


# ---------------- the launcher's cluster against the reference's ----------------

class RefCluster:
    """The reference's in-process blob cluster (its test pattern)."""

    def __init__(self, root, n_nodes=4, disks=3):
        from cubefs_tpu.blob import access as ra, blobnode as rb, clustermgr as rc
        from cubefs_tpu.utils import rpc as rr

        self.cm = rc.ClusterMgr()
        cmc, pool = rr.Client(self.cm), rr.NodePool()
        self.nodes = []
        for n in range(n_nodes):
            node = rb.BlobNode(n, [os.path.join(str(root), f"n{n}d{d}") for d in range(disks)],
                               cmc, addr=f"node{n}")
            node.register()
            node.send_heartbeat()
            pool.bind(node.addr, node)
            self.nodes.append(node)
        self.access = ra.AccessHandler(cmc, pool, ra.AccessConfig(blob_size=BLOB,
                                                                  engine="numpy"))

    def stop(self):
        self.access._pool.shutdown(wait=True)  # hedged reads outlive a GET
        for n in self.nodes:
            n.stop()


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The launcher's cluster on the CPU: clustermgr, 4 blobnodes x 3
    disks, access (64 KiB blobs, its default ``auto``) and a scheduler,
    each a process of its own, with audit logs."""
    wd = tmp_path_factory.mktemp("launched")
    c = deploy.Cluster({"blobnodes": 4, "disks_per_blobnode": 3, "blob_size": BLOB,
                        "scheduler": True, "device": "cpu", "audit_dir": str(wd / "audit")},
                       str(wd), timeout=120.0)
    try:
        state = c.up()
        yield c, state, wd
    finally:
        codes = c.down()
    assert all(rc == 0 for rc in codes.values()), codes


def test_launched_cluster_equals_the_reference_cluster(ref, launched, still_qos, tmp_path, rng):
    """PUT and GET over HTTP through the launcher's processes give the
    Locations, the GETs and the shard bytes of the reference's in-process
    cluster; the state file names every role."""
    c, state, wd = launched
    with open(wd / "cluster.json") as f:
        assert json.load(f) == state
    assert {r: len(a) for r, a in state["roles"].items()} == {
        "clustermgr": 1, "blobnode": 4, "access": 1, "scheduler": 1}
    acc = state["roles"]["access"][0]
    twin = RefCluster(tmp_path)
    try:
        for n in (150_000, 1_000, 3 * BLOB):
            data = payload(rng, n)
            code, meta, _ = http_post(acc, "put", {"codemode": int(cmode.CodeMode.EC6P3)}, data)
            assert code == 200
            want = twin.access.put(data, codemode=cmode.CodeMode.EC6P3)
            assert meta["location"] == want.to_dict()
            code, _, got = http_post(acc, "get", {"location": meta["location"]})
            assert code == 200 and got == data == twin.access.get(want)
            for sl in want.slices:
                vol = rpc.call(state["roles"]["clustermgr"][0], "get_volume",
                               {"vid": sl.vid})[0]["volume"]
                twin_vol = twin.cm.get_volume(sl.vid)
                for u, tu in zip(vol["units"], twin_vol.units):
                    for bid in range(sl.min_bid, sl.min_bid + sl.count):
                        _, shard = rpc.call(u["node_addr"], "get_shard", {
                            "disk_id": u["disk_id"], "chunk_id": u["chunk_id"], "bid": bid})
                        tnode = twin.nodes[int(tu.node_addr.removeprefix("node"))]
                        assert shard == tnode.get_shard(tu.disk_id, tu.chunk_id, bid)[0]
    finally:
        twin.stop()


def test_launched_cluster_stitches_traces_and_audits_every_call(launched, rng):
    """One PUT's trace spans the access and blobnode processes (``/spans``
    of each, ``/traces`` renders it); the access role's audit log holds
    one record per call; the scheduler role answers ``role`` and ``stats``."""
    c, state, wd = launched
    acc = state["roles"]["access"][0]
    audit = wd / "audit" / "access.audit.log"
    old = records(audit) if audit.exists() else []
    before = len(old)
    data = payload(rng, 200_000)
    tid = "00000000000c0ffe"
    _, meta, _ = http_post(acc, "put", {"codemode": int(cmode.CodeMode.EC6P3)}, data,
                           {"X-Trace": f"{tid}:0000000000000001:1:"})
    http_post(acc, "get", {"location": meta["location"]})
    ops = {s["op"] for s in json.loads(http_get(acc, f"/spans?trace_id={tid}")[1])}
    assert {"access.put", "stage:bid_alloc", "stage:quorum_write"} <= ops
    node_ops = set()
    for bn in state["roles"]["blobnode"]:
        node_ops |= {s["op"] for s in json.loads(http_get(bn, f"/spans?trace_id={tid}")[1])}
    assert "blobnode.put_shard" in node_ops
    tree = json.loads(http_get(acc, f"/traces?trace_id={tid}")[1])
    assert tree["trace_id"] == tid and "access.put" in tree["render"]
    assert tid in json.loads(http_get(acc, "/traces")[1])["trace_ids"]
    recs = [r for r in audit_records(audit, before + 2) if r not in old]
    assert sorted((r["svc"], r["op"], r["code"]) for r in recs) == [("access", "get", 200),
                                                                    ("access", "put", 200)]
    assert [r["op"] for r in recs if r["trace"] == tid] == ["put"]
    sched = state["roles"]["scheduler"][0]
    assert rpc.call(sched, "role")[0] == {"role": "scheduler"}
    assert http_post(sched, "stats", {})[0] == 200


FS_ROLES = ["master", "metanode", "datanode"]
# routes the port serves beside the reference's: a metanode's mp_digest (a
# replica's own state digest, which holds replicas equal across processes)
PORT_ONLY_ROUTES = {"metanode": {"mp_digest"}}


@pytest.mark.parametrize("role", FS_ROLES)
def test_fs_role_route_set_equals_the_reference(ref, traces, still_qos, tmp_path, role):
    """The file-system roles serve the reference's route sets (a metanode's
    and a datanode's register with a port master role over HTTP), with
    ``PORT_ONLY_ROUTES`` beside them, and a packet plane and a native read
    plane beside HTTP; the port's role stops them and exits 0."""
    msrv, master = cmd.run_role({"role": "master", "allow_single_node": True,
                                 "data_dir": str(tmp_path / "upstream")})

    def run(pkg_cmd, tag):
        d = tmp_path / tag
        srv, svc = pkg_cmd.run_role({"role": role, "listen_port": 0, "master_addr": msrv.addr,
                                     "data_dir": str(d / role), "allow_single_node": True})
        try:
            planes = role == "master" or (svc._native_h is not None
                                          and svc.native_addr is not None)
            return _served(srv), http_post(srv.addr, "no_such_route", {})[0], planes
        finally:
            if pkg_cmd is cmd:
                assert cmd.shutdown(srv, svc) == 0
            else:
                _ref_close(srv, svc)

    try:
        got, want = run(cmd, "port"), run(ref.cmd, "ref")
        extra = PORT_ONLY_ROUTES.get(role, set())
        assert extra <= got[0] and not extra & want[0]
        got = (got[0] - extra, *got[1:])
        assert got == want and got[1] == 404 and got[2]
        if role != "master":
            kind = "metanodes" if role == "metanode" else "datanodes"
            assert rpc.call(msrv.addr, "stat")[0][kind] == 2
    finally:
        assert cmd.shutdown(msrv, master) == 0


S3_USERS = [{"access_key": OWNER["access_key"], "secret_key": OWNER["secret_key"],
             "grants": {"fsvol": "rw"}},
            {"access_key": STRANGER["access_key"], "secret_key": STRANGER["secret_key"]}]


# a fuseclient role mounts through the kernel: it needs /dev/fuse and root
FUSE_OK = os.path.exists("/dev/fuse") and os.geteuid() == 0


def _mounts_under(root) -> list[str]:
    with open("/proc/mounts") as f:
        return [ln.split()[1] for ln in f if ln.split()[1].startswith(os.path.abspath(root))]


def _detach(mountpoints) -> None:
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    for mnt in mountpoints:
        libc.umount2(mnt.encode(), 2)  # MNT_DETACH


@pytest.fixture(scope="module")
def launched_fs(tmp_path_factory):
    """The launcher's file-system plane with its cold tier's blob plane on
    the CPU: a master, 3 metanodes, 3 datanodes (replicas 3) and a volume
    of 2 meta and 2 data partitions, a clustermgr and 4 blobnodes x 3
    disks, the objectnode serving the volume as bucket ``bkt`` to an
    owner and a stranger, the fsgateway and the console, each a process of
    its own; and, where the kernel allows, a fuseclient role mounting the
    volume at ``<workdir>/mnt``. No mount under the workdir outlives the
    module: one left after the roles stop is detached, and fails it."""
    wd = tmp_path_factory.mktemp("launched_fs")
    c = deploy.Cluster({"metanodes": 3, "datanodes": 3, "replicas": 3,
                        "volume": {"name": "fsvol", "mp_count": 2, "dp_count": 2},
                        "blobnodes": 4, "disks_per_blobnode": 3, "access": False,
                        "objectnode": True, "bucket": "bkt", "users": S3_USERS,
                        "fsgateway": True, "console": True,
                        "device": "cpu"}, str(wd), timeout=120.0)
    codes = {}
    try:
        state = c.up()
        if FUSE_OK:
            fc = deploy.Proc("fuseclient", {"role": "fuseclient", "master_addr":
                                            state["roles"]["master"][0], "vol": "fsvol",
                                            "mountpoint": str(wd / "mnt")}, str(wd))
            c.procs.append(fc)
            assert fc.wait_addr(timeout=120.0) == str(wd / "mnt")
        yield c, state, wd, codes
    finally:
        codes.update(c.down())
        left = _mounts_under(wd)
        _detach(left)
        assert not left, left


def test_launched_fs_plane_round_trips_tiers_and_exits_0(launched_fs, still_qos, monkeypatch):
    """A file written through a client of the launched plane reads back
    byte for byte; one aged file is tiered into the blob roles by a
    lifecycle scan (kernel A's plain version encodes it in this process)
    and reads back cold; the state file names every role and the volume."""
    from cubefs_tpu_torch.blob.sdk import BlobClient
    from cubefs_tpu_torch.fs.client import FileSystem
    from cubefs_tpu_torch.fs.lcnode import LcNode, LifecycleRule

    c, state, wd, _ = launched_fs
    with open(wd / "cluster.json") as f:
        assert json.load(f) == state
    assert {r: len(a) for r, a in state["roles"].items()} == {
        "master": 1, "metanode": 3, "datanode": 3, "clustermgr": 1, "blobnode": 4,
        "objectnode": 1, "fsgateway": 1, "console": 1}
    assert state["volume"] == "fsvol"
    view = rpc.call(state["roles"]["master"][0], "client_view", {"name": "fsvol"})[0]["volume"]
    assert len(view["mps"]) == 2 and len(view["dps"]) == 2
    pool = rpc.NodePool()
    monkeypatch.setenv("CUBEFS_TIERING", "1")
    fs = FileSystem(view, pool, blob_client=BlobClient(
        state["roles"]["clustermgr"][0], pool,
        access.AccessConfig(blob_size=BLOB, device="cpu")))
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                fs.mkdir("/cold")
                break
            except Exception:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.1)
        rng = np.random.default_rng(31)
        hot, cold = (rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (700_001, 300_007))
        fs.write_file("/hot.bin", hot)
        ino = fs.write_file("/cold/c.bin", cold)
        assert fs.read_file("/hot.bin") == hot
        fs.meta.set_attr(ino, mtime=time.time() - 7200)
        lc = LcNode(fs, engine=fs.tiering)
        lc.set_rules([LifecycleRule("tier", prefix="/cold/", transition_after_s=3600)])
        assert lc.scan_once().transitioned == 1
        inode = fs.meta.inode_get(ino)
        assert not inode["extents"] and inode["xattr"].get("cold.location")
        assert fs.read_file("/cold/c.bin") == cold
    finally:
        for cl in (*fs.meta._packet_clients.values(), *fs.data._packet_clients.values()):
            cl.close()


def test_launched_objectnode_serves_signed_requests_only(launched_fs):
    """The launched ``objectnode`` role: requests SigV4-signed by either
    package's signer as the owner succeed (PUT, GET, HEAD, a listing);
    anonymous and stranger requests and a signature under the wrong
    secret get 403."""
    from test_torch_s3_mixed import call

    from cubefs_tpu.fs import s3auth as ref_s3auth

    _, state, _, _ = launched_fs
    url = f"http://{state['roles']['objectnode'][0]}/bkt"
    body = payload(np.random.default_rng(33), 200_003)
    deadline = time.monotonic() + 60
    while call("PUT", f"{url}/s3/obj.bin", body)[0] != 200:  # per-partition elections
        assert time.monotonic() < deadline
        time.sleep(0.2)
    for signer in (s3auth, ref_s3auth):
        st, got, h = call("GET", f"{url}/s3/obj.bin", signer=signer)
        assert (st, got) == (200, body) and h["ETag"] == f'"{hashlib.md5(body).hexdigest()}"'
        assert call("HEAD", f"{url}/s3/obj.bin", signer=signer)[2]["Content-Length"] == "200003"
        st, listing, _ = call("GET", f"{url}?list-type=2&prefix=s3/", signer=signer)
        assert st == 200 and b"<Key>s3/obj.bin</Key>" in listing
    wrong = dict(OWNER, secret_key="not-the-secret")
    for cred in (None, STRANGER, wrong):
        assert call("PUT", f"{url}/s3/refused", b"x", cred=cred)[0] == 403
        assert call("GET", f"{url}/s3/obj.bin", cred=cred)[0] == 403
    assert call("GET", f"{url}/s3/refused")[0] == 404


def test_tiered_object_through_either_objectnode_role(launched_fs, still_qos, monkeypatch):
    """The limit shared with the reference: the objectnode role's
    ``FileSystem`` has no blob client, so a GET of a tiered object
    answers 200 and the object's size in zero bytes. The port's launched
    role and the reference's (``python -m cubefs_tpu.cmd``, on the same
    master) answer the same status and bytes; a hot object reads back in
    both."""
    from cubefs_tpu.deploy import cluster as ref_deploy
    from cubefs_tpu_torch.blob.sdk import BlobClient
    from cubefs_tpu_torch.fs.client import FileSystem
    from cubefs_tpu_torch.fs.lcnode import LcNode, LifecycleRule
    from test_torch_s3_mixed import call

    _, state, wd, _ = launched_fs
    master = state["roles"]["master"][0]
    view = rpc.call(master, "client_view", {"name": "fsvol"})[0]["volume"]
    pool = rpc.NodePool()
    monkeypatch.setenv("CUBEFS_TIERING", "1")
    fs = FileSystem(view, pool, blob_client=BlobClient(
        state["roles"]["clustermgr"][0], pool, access.AccessConfig(blob_size=BLOB, device="cpu")))
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")  # the reference's role inherits it
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    ref_role = None
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                fs.mkdir("/tiered")
                break
            except Exception:
                assert time.monotonic() < deadline
                time.sleep(0.1)
        hot, cold = (payload(np.random.default_rng(35), n) for n in (70_001, 250_007))
        fs.write_file("/tiered/hot.bin", hot)
        ino = fs.write_file("/tiered/cold.bin", cold)
        fs.meta.set_attr(ino, mtime=time.time() - 7200)
        lc = LcNode(fs, engine=fs.tiering)
        lc.set_rules([LifecycleRule("tier", prefix="/tiered/cold", transition_after_s=3600)])
        assert lc.scan_once().transitioned == 1
        assert fs.read_file("/tiered/cold.bin") == cold  # this client has the blob plane
        ref_role = ref_deploy.Proc("objectnode", {
            "role": "objectnode", "name": "ref-objectnode", "master_addr": master,
            "vols": {"bkt": "fsvol"}, "users": S3_USERS}, str(wd))
        answers = {}
        for name, addr in (("port", state["roles"]["objectnode"][0]),
                           ("ref", ref_role.wait_addr(timeout=120.0))):
            answers[name] = [call("GET", f"http://{addr}/bkt/tiered/{k}")[:2]
                             for k in ("cold.bin", "hot.bin")]
        assert answers["port"] == answers["ref"] == [(200, bytes(len(cold))), (200, hot)]
    finally:
        if ref_role is not None:
            ref_role.p.terminate()
            try:
                ref_role.p.wait(30)
            except subprocess.TimeoutExpired:
                ref_role.p.kill()
                ref_role.p.wait(30)
        for cl in (*fs.meta._packet_clients.values(), *fs.data._packet_clients.values()):
            cl.close()


def test_tiered_file_through_either_fsgateway_and_fuseclient_role(launched_fs, still_qos,
                                                                   monkeypatch):
    """The limit shared with the reference, through the native and kernel
    doors: the fsgateway and fuseclient roles build their ``FileSystem``
    with no blob client, so a tiered file reads as its size in zero bytes,
    and a hot file reads back. The port's launched roles and the
    reference's (``python -m cubefs_tpu.cmd``, on the same master) give the
    same bytes through the C ABI (``cfs_pread``, the port's library) and
    through the kernel (a read in a child process under ``timeout=``)."""
    from cubefs_tpu.deploy import cluster as ref_deploy
    from cubefs_tpu_torch.blob.sdk import BlobClient
    from cubefs_tpu_torch.fs.client import FileSystem
    from cubefs_tpu_torch.fs.lcnode import LcNode, LifecycleRule
    from cubefs_tpu_torch.runtime import nativeclient

    c, state, wd, _ = launched_fs
    master = state["roles"]["master"][0]
    view = rpc.call(master, "client_view", {"name": "fsvol"})[0]["volume"]
    pool = rpc.NodePool()
    monkeypatch.setenv("CUBEFS_TIERING", "1")
    fs = FileSystem(view, pool, blob_client=BlobClient(
        state["roles"]["clustermgr"][0], pool, access.AccessConfig(blob_size=BLOB, device="cpu")))
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")  # the reference's roles inherit it
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    ref_roles = []
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                fs.mkdir("/doors")
                break
            except Exception:
                assert time.monotonic() < deadline
                time.sleep(0.1)
        hot, cold = (payload(np.random.default_rng(37), n) for n in (60_001, 200_003))
        fs.write_file("/doors/hot.bin", hot)
        ino = fs.write_file("/doors/cold.bin", cold)
        fs.meta.set_attr(ino, mtime=time.time() - 7200)
        lc = LcNode(fs, engine=fs.tiering)
        lc.set_rules([LifecycleRule("tier", prefix="/doors/cold", transition_after_s=3600)])
        assert lc.scan_once().transitioned == 1
        assert fs.read_file("/doors/cold.bin") == cold  # this client has the blob plane
        gateways = {"port": state["roles"]["fsgateway"][0]}
        mounts = {"port": str(wd / "mnt")} if FUSE_OK else {}
        ref_roles.append(ref_deploy.Proc("fsgateway", {
            "role": "fsgateway", "name": "ref-fsgateway", "master_addr": master,
            "vol": "fsvol"}, str(wd)))
        if FUSE_OK:
            ref_roles.append(ref_deploy.Proc("fuseclient", {
                "role": "fuseclient", "name": "ref-fuseclient", "master_addr": master,
                "vol": "fsvol", "mountpoint": str(wd / "ref-mnt")}, str(wd)))
            mounts["ref"] = str(wd / "ref-mnt")
        gateways["ref"] = ref_roles[0].wait_addr(timeout=120.0)
        lib = nativeclient.load()
        answers = {}
        for name, addr in gateways.items():
            host, p = addr.rsplit(":", 1)
            h = lib.cfs_mount(host.encode(), int(p))
            assert h, lib.cfs_last_error()
            try:
                got = []
                for path, n in ((b"/doors/cold.bin", len(cold)), (b"/doors/hot.bin", len(hot))):
                    fd = lib.cfs_open(h, path, 0, 0)
                    buf = ctypes.create_string_buffer(n + 16)
                    n_read = lib.cfs_pread(h, fd, buf, n + 16, 0)
                    got.append(buf.raw[:n_read])
                    lib.cfs_close(h, fd)
                answers["gateway", name] = got
            finally:
                lib.cfs_unmount(h)
        if FUSE_OK:
            # the reference's Proc takes no fuseclient line: read its log
            deadline = time.monotonic() + 120
            while "] fsvol mounted at" not in open(ref_roles[1].log_path).read():
                assert ref_roles[1].p.poll() is None and time.monotonic() < deadline
                time.sleep(0.1)
            for name, mnt in mounts.items():
                run = subprocess.run(
                    [sys.executable, "-c", "import sys; [sys.stdout.write(open(p, 'rb')"
                     ".read().hex() + ' ') for p in sys.argv[1:]]",
                     f"{mnt}/doors/cold.bin", f"{mnt}/doors/hot.bin"],
                    capture_output=True, text=True, timeout=60)
                assert run.returncode == 0, run.stderr
                answers["mount", name] = [bytes.fromhex(x) for x in run.stdout.split()]
        want = [bytes(len(cold)), hot]
        assert answers and all(v == want for v in answers.values()), \
            {k: [len(x) for x in v] for k, v in answers.items()}
        assert len(answers) == (4 if FUSE_OK else 2)
    finally:
        for role in ref_roles:
            role.p.terminate()
        for role in ref_roles:
            try:
                assert role.p.wait(30) == 0  # a fuseclient unmounts on SIGTERM
            except subprocess.TimeoutExpired:
                role.p.kill()
                role.p.wait(30)
        for cl in (*fs.meta._packet_clients.values(), *fs.data._packet_clients.values()):
            cl.close()
    assert not _mounts_under(wd / "ref-mnt")


def test_launched_fs_roles_exit_0_on_sigterm(launched_fs):
    """Every role of the launched planes stops on SIGTERM with exit 0, a
    fuseclient after it unmounts."""
    c, _, wd, codes = launched_fs
    codes.update(c.down())
    assert len(codes) == (16 if FUSE_OK else 15) and all(rc == 0 for rc in codes.values()), codes
    assert not _mounts_under(wd)


def test_launcher_refuses_file_system_roles(tmp_path):
    """A gateway of the file-system plane (objectnode, fsgateway) is
    refused before anything starts when the topology has no file-system
    plane to serve; the fsgateway and console start beside one (the
    ``launched_fs`` cluster)."""
    for topo in ({"objectnode": True, "blobnodes": 4}, {"fsgateway": True},
                 {"fsgateway": True, "console": True, "blobnodes": 1}):
        with pytest.raises(ValueError, match="file-system plane"):
            deploy.Cluster(topo, str(tmp_path))
    assert not os.listdir(tmp_path)
    deploy.Cluster({"fsgateway": True, "console": True, "metanodes": 3}, str(tmp_path / "w"))


# ---------------- HTTP-stitched traces (tests/test_trace_obs.py) against the port ----------------

class _HttpBlobCluster:
    """The port's blob plane with blobnodes served over real HTTP: the
    NodePool has no in-process binding for the advertised addrs, so every
    shard RPC dials the wire and the X-Trace header does the stitching."""

    def __init__(self, tmp_path, n_nodes=4, disks_per_node=3):
        self.cm = clustermgr.ClusterMgr()
        self.cm_client = rpc.Client(self.cm)
        self.pool = rpc.NodePool()
        self.nodes, self.srvs = [], []
        for n in range(n_nodes):
            node = blobnode.BlobNode(n, [str(tmp_path / f"hn{n}d{d}")
                                         for d in range(disks_per_node)],
                                     self.cm_client, device="cpu")
            srv = rpc.RpcServer(rpc.expose(node), service="blobnode").start()
            node.addr = srv.addr
            node.register()
            node.send_heartbeat()
            self.nodes.append(node)
            self.srvs.append(srv)
        self.repair_q = mq.MessageQueue()
        self.delete_q = mq.MessageQueue()
        self.access = access.AccessHandler(
            self.cm_client, self.pool, access.AccessConfig(blob_size=BLOB, device="cpu"),
            repair_queue=self.repair_q, delete_queue=self.delete_q)

    def stop(self):
        self.access._pool.shutdown(wait=True)  # hedged reads outlive a GET
        for s in self.srvs:
            s.stop()
        for n in self.nodes:
            n.stop()


def _ops(tid):
    return {s["op"] for s in tracelib.finished_spans(tid)}


def _depth(tree):
    return max((1 + _depth(n["children"]) for n in tree), default=0)


def _root(op):
    roots = [s for s in tracelib.finished_spans() if s["op"] == op and s["parent_id"] is None]
    assert roots
    return roots[0]["trace_id"]


@pytest.mark.parametrize("leg", ["put_get", "repair"])
def test_http_stitched_traces_hold_against_the_port(traces, still_qos, tmp_path, rng, leg):
    c = _HttpBlobCluster(tmp_path)
    try:
        data = payload(rng, 150_000)
        tracelib.reset_collector()
        loc = c.access.put(data, codemode=cmode.CodeMode.EC6P3)
        if leg == "put_get":
            tid = _root("access.put")
            assert {"stage:bid_alloc", "stage:quorum_write", "blobnode.put_shard"} <= _ops(tid)
            assert _depth(tracelib.trace_tree(tid)) >= 3
            tracelib.reset_collector()
            assert c.access.get(loc) == data
            assert {"stage:read", "blobnode.get_shard"} <= _ops(_root("access.get"))
            return
        vol = c.cm.get_volume(loc.slices[0].vid)
        victim = vol.units[1]
        next(n for n in c.nodes if n.addr == victim.node_addr).break_disk(victim.disk_id)
        sched = scheduler.Scheduler(c.cm, repair_queue=c.repair_q, delete_queue=c.delete_q,
                                    node_pool=c.pool, device="cpu")
        wk = worker.RepairWorker(rpc.Client(sched), c.cm_client, c.pool, device="cpu")
        assert sched.mark_disk_broken(victim.disk_id) >= 1
        tracelib.reset_collector()
        for _ in range(100):
            if not wk.run_once():
                break
        tid = _root("worker.repair")
        assert {"stage:survivor_reads", "stage:decode", "stage:writeback",
                "blobnode.get_shard", "blobnode.put_shard"} <= _ops(tid)
        assert _depth(tracelib.trace_tree(tid)) >= 3
        assert "worker.repair" in tracelib.render_tree(tracelib.trace_tree(tid))
        assert c.access.get(loc) == data
        sched.stop()
    finally:
        c.stop()
