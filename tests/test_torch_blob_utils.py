"""The port's copies of the blob plane's utilities held against the
reference's: ``utils/{lockwitness,retry,ratelimit,trace,qos,slo,
diskhealth,fsm}.py`` of ``cubefs_tpu_torch`` and of ``cubefs_tpu`` run
one scenario each on the same inputs and a fake clock, and the scenario's
whole trace (results, errors, sleeps, span trees, gauges, state files)
must be equal. Also the port's ``rpc`` client surface (``Client`` over an
object and over HTTP, ``NodePool``, ``call_replicas``, ``errno_error``,
``X-Trace`` propagation)."""

import json
import os
import threading
import types

import pytest

from cubefs_tpu_torch.utils import (diskhealth, fsm, lockwitness, metrics, qos, ratelimit,
                                    retry, rpc, slo, trace)

PORT = types.SimpleNamespace(diskhealth=diskhealth, fsm=fsm, lockwitness=lockwitness,
                             metrics=metrics, qos=qos, ratelimit=ratelimit, retry=retry,
                             rpc=rpc, slo=slo, trace=trace)


@pytest.fixture(scope="module")
def ref():
    from cubefs_tpu.utils import diskhealth, fsm, lockwitness, metrics, qos, ratelimit, retry
    from cubefs_tpu.utils import rpc, slo, trace

    return types.SimpleNamespace(diskhealth=diskhealth, fsm=fsm, lockwitness=lockwitness,
                                 metrics=metrics, qos=qos, ratelimit=ratelimit, retry=retry,
                                 rpc=rpc, slo=slo, trace=trace)


# ---------------- scenarios: each returns its whole trace ----------------

def s_retry(u, tmp):
    out = []
    for kw in ({"seed": 3}, {"seed": 5, "max_retries": 3}, {"seed": 1, "deadline": 0.3,
                                                             "jitter": 0.0}):
        clock = u.retry.FakeClock()
        r = u.retry.RetryPolicy(base=0.05, cap=0.4, clock=clock, **kw).start(op="t")
        ticks = [r.tick(reason="x") for _ in range(8)]
        out.append([ticks, clock.sleeps, r.remaining(), r.within_deadline()])
    return out


def s_breaker(u, tmp):
    clock = u.retry.FakeClock()
    b = u.retry.CircuitBreaker(threshold=3, cooldown=5.0, clock=clock)
    script = [("fail", "a"), ("fail", "a"), ("allow", "a"), ("fail", "a"), ("allow", "a"),
              ("advance", 4.9), ("allow", "a"), ("advance", 0.2), ("allow", "a"),
              ("allow", "a"), ("fail", "a"), ("allow", "a"), ("advance", 5.1), ("allow", "a"),
              ("ok", "a"), ("allow", "a"), ("allow", "b")]
    out = []
    for op, arg in script:
        if op == "advance":
            clock.advance(arg)
            res = None
        elif op == "fail":
            res = b.record_failure(arg)
        elif op == "ok":
            res = b.record_success(arg)
        else:
            res = b.allow(arg)
        out.append([op, res, b.state("a"), b.state("b")])
    return out


def s_token_bucket(u, tmp):
    clock = u.retry.FakeClock()
    tb = u.ratelimit.TokenBucket(100.0, 50.0, clock=clock, name="t")
    out = [tb.reserve(30), tb.reserve(30), tb.time_to(10), tb.reserve(200),
           tb.reserve(10, max_wait=0.5)]
    clock.advance(1.0)
    out += [tb.reserve(10, max_wait=5.0), tb.acquire(40), tb.acquire(500, timeout=0.1),
            clock.now(), clock.sleeps]
    free = u.ratelimit.TokenBucket(0.0, clock=clock)
    out += [free.reserve(10**9), free.time_to(5)]
    return out


def s_trace(u, tmp):
    tr = u.trace
    clock = u.retry.FakeClock(100.0)
    saved = tr._clock
    tr.set_clock(clock)
    tr.seed_ids(42)
    tr.reset_collector()
    try:
        with tr.path_span("blob.put", "access.put", tenant="t1") as root:
            clock.advance(0.01)
            with tr.stage("bid_alloc"):
                clock.advance(0.002)
            with tr.stage("quorum_write") as st:
                clock.advance(0.004)
                st.span.set_tag("shards", 9)
            ref = tr.capture()
            hdr = root.header()
        with tr.from_header("svc.get_shard", hdr) as hop:
            clock.advance(0.003)
            hop.log("read")
        with tr.start_span("stage:codec_step", links=[ref]) as sp:
            sp.set_tag("stripes", 4)
        tr.observe_stage("codec_step", "blob.put", 0.25)
        tree = tr.trace_tree(root.trace_id)
        return {"spans": tr.finished_spans(), "tree": tree, "header": hdr,
                "orphan": tr.from_header("x", None).parent_id,
                "tenant": tr.current_tenant()}
    finally:
        tr.set_clock(saved)
        tr.reset_collector()
        tr.seed_ids(None)


class _Still:
    def snapshot(self):
        return {}


def s_qos(u, tmp):
    clock = u.retry.FakeClock()
    gate = u.qos.QosGate(tracker=_Still(), clock=clock, max_inflight=4, blocking=False,
                         shaping_timeout=0.25)
    gate.configure("slow", rate=100.0, burst=100.0)
    gate.configure("bulk", priority=u.qos.REPAIR)
    held, out = [], []

    def admit(path, tenant, cost=1.0, priority=None, hold=False):
        try:
            a = gate.admit(path, tenant=tenant, cost=cost, priority=priority, svc="access")
        except u.qos.QosRejected as e:
            out.append(["shed", e.code, e.message, e.reason, e.retry_after])
            return
        out.append(["ok", a.tenant, a.priority, a.throttle_s])
        if hold:
            held.append(a)
        else:
            a.release()

    admit("blob.put", "slow", cost=60)
    admit("blob.put", "slow", cost=60)   # shaped: owes a wait
    admit("blob.put", "slow", cost=80)   # over the shaping timeout: shed
    clock.advance(2.0)
    admit("blob.put", "slow", cost=10)
    for _ in range(5):  # the foreground depth bound
        admit("blob.get", "anon", hold=True)
    admit("blob.get", "bulk")
    for a in held:
        a.release()
    gate.force_level("blob.get", 2)
    admit("blob.get", "bulk")  # repair class browned out
    admit("blob.get", "anon")
    admit("blob.get", "anon", priority=u.qos.SCRUB)
    gate.force_level("blob.get", None)
    out.append(gate.snapshot())
    out.append([gate.level("blob.get"), gate.max_level()])
    return out


def s_slo(u, tmp):
    clock = u.retry.FakeClock()
    hist = u.metrics.Histogram("h", "", ("path", "stage"),
                               buckets=(0.001, 0.01, 0.05, 0.1, 0.5, 1.0))
    tracker = u.slo.SloTracker(hist=hist, targets={}, window_s=10.0, windows=3, clock=clock)
    tracker.register("blob.put", 0.05, objective=0.9)
    out = []
    for step, values in enumerate([[0.002] * 20 + [0.2] * 3, [0.03] * 10, [0.7] * 5, []]):
        for v in values:
            hist.observe(v, path="blob.put", stage="total")
        hist.observe(0.3, path="blob.put", stage="read")  # not a total: ignored
        clock.advance(10.0)
        out.append(tracker.snapshot())
    wh = u.slo.WindowedHistogram((0.1, 1.0), window_s=1.0, windows=2, clock=clock)
    for v in (0.05, 0.5, 2.0, 0.05):
        wh.observe(v)
    out.append([wh.count(), wh.quantiles(), wh.fraction_over(0.1)])
    clock.advance(5.0)
    out.append([wh.count(), u.slo.quantile_label(0.999)])
    return out


def s_diskhealth(u, tmp):
    clock = u.retry.FakeClock()
    t = u.diskhealth.DiskHealthTracker("n0", [1, 2, 3, 4], clock=clock, min_samples=5,
                                       probe_cooldown=10.0, error_window=30.0)
    out = []
    for i in range(8):
        for d in (1, 2, 3, 4):
            t.record_io(d, 0.001 if d != 4 or i < 6 else 0.2)
        clock.advance(1.0)
    out.append([t.quarantined(), t.status()])
    for _ in range(3):
        t.record_io(2, 0.0, ok=False)
        clock.advance(20.0)  # outside the error window: no trip
    out.append(t.quarantined())
    for _ in range(3):
        t.record_io(3, 0.0, ok=False)
    out.append([t.quarantined(), t.probe_due(3), t.is_quarantined(3)])
    clock.advance(10.0)
    out.append([t.probe_due(3), t.probe_due(4)])
    t.probe_result(3, False)
    out.append([t.probe_due(3), t.status()])
    clock.advance(10.0)
    t.probe_result(3, True)
    t.probe_result(1, True)  # not quarantined: ignored
    out.append([t.quarantined(), t.status()])
    return out


def _fsm_host(u):
    class Host(u.fsm.ReplicatedFsm):
        def __init__(self, data_dir):
            self.kv, self.applied = {}, 0
            self._init_fsm("t", data_dir, None, None, None)

        def _state_dict(self):
            return {"kv": self.kv}

        def _load_state_dict(self, state):
            self.kv = dict(state["kv"])

        def _apply(self, rec):
            self.applied += 1
            if rec["op"] == "fail":
                raise ValueError(f"refused {rec['k']}")
            if rec["op"] == "set":
                self.kv[rec["k"]] = rec["v"]
            else:
                self.kv.pop(rec["k"], None)
            return len(self.kv)

    return Host


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


def s_fsm(u, tmp):
    host, d, out = _fsm_host(u), os.path.join(tmp, "fsm"), []
    h = host(d)
    out.append(h._commit({"op": "set", "k": "a", "v": 1, "op_id": "x1"}))
    out.append(h._commit({"op": "set", "k": "a", "v": 2, "op_id": "x1"}))  # replayed
    out.append(h.applied)
    out.append(h._commit_many([{"op": "set", "k": "b", "v": 3},
                               {"op": "fail", "k": "c"}, {"op": "set", "k": "d", "v": 4}]))
    try:
        h._commit({"op": "fail", "k": "e", "op_id": "x2"})
    except ValueError as e:
        out.append(str(e))
    out.append([h.is_leader(), h.leader_addr(), h.snapshot()])
    h._commit({"op": "del", "k": "b"})
    out.append(_files(d))
    h2 = host(d)  # snapshot + wal replay
    out.append([h2.kv, h2._commit({"op": "set", "k": "a", "v": 9, "op_id": "x1"})])
    with open(os.path.join(d, "wal.jsonl"), "ab") as f:
        f.write(b"!0000")  # a torn tail
    out.append([host(d).kv, _files(d)])
    with open(os.path.join(d, "wal.jsonl"), "r+b") as f:
        f.seek(3)
        f.write(b"zz")  # corrupt the first record: valid ones follow it
    try:
        host(d)
    except u.fsm.WalCorruptError as e:
        out.append(["corrupt", type(e).__name__, str(e).replace(tmp, "<tmp>")])
    out.append(u.fsm.parse_records(u.fsm.frame_records([{"a": 1}, {"b": [2]}])))
    return out


def s_lockwitness(u, tmp):
    lw, out = u.lockwitness, []
    with lw.installed() as w:
        a, b = lw.make_lock("T.a"), lw.make_lock("T.b")
        c = lw.make_rlock("T.c", allow_block="serializes the test's commits")
        with a:
            with b:
                pass
        try:
            with b:
                with a:
                    pass
        except lw.WitnessViolation as e:
            out.append(["cycle", str(e).split(":")[0]])
        try:
            with a:
                lw.note_rpc("node0", "put_shard")
        except lw.WitnessViolation as e:
            out.append(["rpc", str(e).split(":")[0]])
        with c:
            with c:
                lw.note_rpc("node0", "put_shard")  # justified: passes
        cond = threading.Condition(lw.make_lock("T.d"))
        with cond:
            cond.wait(0.001)
        st = w.stats()
        out.append({k: st[k] for k in ("enabled", "locks_seen", "acquisitions",
                                       "max_held_depth", "rpc_checks", "instance_overlaps")})
        out.append([(e["src"], e["dst"]) for e in st["edges"]])
        out.append(lw.enabled())
    out.append([lw.enabled(), type(lw.make_lock("T.e")).__name__])
    return out


SCENARIOS = {f.__name__[2:]: f for f in (s_retry, s_breaker, s_token_bucket, s_trace, s_qos,
                                         s_slo, s_diskhealth, s_fsm, s_lockwitness)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_utility_equals_the_reference(ref, tmp_path, name):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    want = SCENARIOS[name](ref, str(tmp_path / "ref"))
    got = SCENARIOS[name](PORT, str(tmp_path / "port"))
    assert json.dumps(got, sort_keys=True, default=repr) == \
        json.dumps(want, sort_keys=True, default=repr)
    assert got  # every scenario records something


def test_fsm_state_written_by_either_package_opens_in_the_other(ref, tmp_path):
    for writer, reader in ((ref, PORT), (PORT, ref)):
        d = str(tmp_path / f"{writer is ref}")
        h = _fsm_host(writer)(d)
        for i in range(5):
            h._commit({"op": "set", "k": f"k{i}", "v": i, "op_id": f"o{i}"})
        h.snapshot()
        h._commit({"op": "del", "k": "k0"})
        r = _fsm_host(reader)(d)
        assert r.kv == h.kv == {f"k{i}": i for i in range(1, 5)}
        assert r._commit({"op": "set", "k": "k1", "v": 7, "op_id": "o1"}) == 4  # replayed


# ---------------- the rpc client surface ----------------

class _Svc:
    def __init__(self):
        self.extra_routes = {"extra": lambda args, body: {"extra": True}}
        self.traces = []

    def rpc_echo(self, args, body):
        sp = trace.current()
        self.traces.append(None if sp is None else (sp.trace_id, sp.parent_id))
        return {"args": args}, body

    def rpc_boom(self, args, body):
        raise KeyError("nope")

    def rpc_errno(self, args, body):
        raise rpc.errno_error(int(args["errno"]), "why")


@pytest.fixture
def served():
    svc = _Svc()
    srv = rpc.RpcServer(svc, service="svc").start()
    yield svc, srv
    srv.stop()


@pytest.mark.parametrize("transport", ["object", "http"])
def test_client_calls_an_object_or_an_address_alike(served, transport):
    svc, srv = served
    c = rpc.Client(svc if transport == "object" else srv.addr)
    assert c.call("echo", {"x": 1}, b"body") == ({"args": {"x": 1}}, b"body")
    assert c.call("extra") == ({"extra": True}, b"")
    with pytest.raises(rpc.RpcError) as e:
        c.call("missing")
    assert (e.value.code, e.value.message) == (404, "no such method 'missing'")
    with pytest.raises(rpc.RpcError) as e:
        c.call("boom")
    assert (e.value.code, e.value.message) == (500, "KeyError: 'nope'")
    with pytest.raises(rpc.RpcError) as e:
        c.call("errno", {"errno": 2})
    assert (e.value.code, e.value.message) == (402, "why")
    with pytest.raises(rpc.RpcError) as e:
        c.call("errno", {"errno": 122})
    assert (e.value.code, e.value.message) == (499, "errno=122: why")


def test_http_calls_carry_the_active_span(served):
    svc, srv = served
    with trace.start_span("caller") as sp:
        rpc.call(srv.addr, "echo")
    rpc.call(srv.addr, "echo")
    assert svc.traces[0] == (sp.trace_id, sp.span_id)  # the server continued it
    assert svc.traces[1][1] is None  # no caller span: a fresh root


def test_node_pool_and_call_replicas_fail_over(served):
    svc, srv = served
    pool = rpc.NodePool()
    pool.bind("live", svc)
    dead = "127.0.0.1:9"  # nothing listens on the discard port
    assert pool.get("live").call("echo", {"i": 1})[0] == {"args": {"i": 1}}
    assert pool.get(dead) is pool.get(dead)
    out = rpc.call_replicas(pool, [dead, "live"], "echo", {"i": 2}, deadline=5.0)
    assert out == ({"args": {"i": 2}}, b"")
    with pytest.raises(rpc.ServiceUnavailable):
        rpc.call_replicas(pool, [dead], "echo", deadline=1.0)
    assert isinstance(pool.breaker, retry.CircuitBreaker)
