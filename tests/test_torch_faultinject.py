"""The port's chaos harness (``cubefs_tpu_torch/utils/faultinject.py``)
and its doors in ``utils/rpc.py`` held against the reference's
(``cubefs_tpu``) on the CPU: the same seed and the same calls give the
same schedule and digest, the HTTP door's ``_corrupt``/``_stale`` knobs
behave against a server of either package, no plan costs one identity
check, and the demo prints what the reference's prints.
"""

import subprocess
import sys
import types

import pytest

from cubefs_tpu_torch.utils import faultinject as fi
from cubefs_tpu_torch.utils import rpc
from cubefs_tpu_torch.utils.retry import FakeClock

PORT = types.SimpleNamespace(fi=fi, rpc=rpc, FakeClock=FakeClock)


@pytest.fixture(scope="module")
def ref():
    from cubefs_tpu.utils import faultinject as ref_fi
    from cubefs_tpu.utils import rpc as ref_rpc
    from cubefs_tpu.utils.retry import FakeClock as RefFakeClock

    return types.SimpleNamespace(fi=ref_fi, rpc=ref_rpc, FakeClock=RefFakeClock)


@pytest.fixture(autouse=True)
def _no_leftover_plan(ref):
    assert rpc._fault is None and ref.rpc._fault is None
    yield
    fi.uninstall()
    ref.fi.uninstall()


class _Svc:
    def __init__(self):
        self.count = 0

    def rpc_ping(self, args, body):
        self.count += 1
        return {"n": self.count}, body


def _drive(pkg, seed: int) -> tuple[list, str, list, list]:
    """One call sequence over every kind of fault the plan schedules:
    transport rules (probabilistic, delayed with jitter, counted,
    every-Nth), partitions by sender, disks, at-rest rot, frames and
    in-process gates."""
    clock = pkg.FakeClock()
    plan = pkg.fi.FaultPlan(seed=seed, clock=clock)
    plan.on("s", "ping", kind="drop_before", prob=0.3)
    plan.on("s", "ping", kind="delay", delay=0.5, jitter=0.25, every=3)
    plan.on("t", "*", kind="error", code=507, after=2, times=3)
    plan.on("t", "ping", kind="duplicate", times=2)
    plan.on("t", "ping", kind="drop_after")
    plan.wan(["w0"], ["w1"], delay=0.01, jitter=0.004)
    pool = pkg.rpc.NodePool()
    for a in ("s", "t", "w1", "p"):
        pool.bind(a, _Svc())
    outcomes = []

    def call(addr, sender=None):
        try:
            with pkg.fi.sender(sender):
                pool.get(addr).call("ping")
            outcomes.append("ok")
        except pkg.rpc.RpcError as e:
            outcomes.append(e.code)

    with pkg.fi.installed(plan):
        for _ in range(30):
            call("s")
        for _ in range(8):
            call("t")
        for _ in range(4):
            call("w1", sender="w0")
        plan.partition(["q"], ["p"])
        plan.partition_oneway(["r"], ["p"])
        call("p", sender="q")
        call("p", sender="r")
        plan.isolate("s")
        call("s")
        plan.heal()
        call("p", sender="q")
        plan.break_disk("n0", 3)
        outcomes.append(plan.disk_broken("n0", 3))
        plan.plant_rot("n0", 1, "c4:b9", kind="torn_write")
        outcomes.append(plan.at_rest_fault("n0", 1, "c4:b9"))
        outcomes.append(plan.heal_rot("n0", 1, "c4:b9"))
        outcomes.append(plan.rot_remaining())
        plan.on("m", "frame_put", kind="corrupt", times=1)
        outcomes.append(plan.wire_frame("m", "put"))
        plan.on("lc", "phase:*", kind="drop_before")
        plan.on("lc", "phase:prepared", kind="drop_before")
        try:
            plan.gate("lc", "phase:prepared")
        except pkg.fi.InjectedCrash:
            outcomes.append("crash")
    return [e[:5] for e in plan.schedule()], plan.schedule_digest(), outcomes, clock.sleeps


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_same_seed_gives_the_reference_schedule_and_digest(ref, seed):
    got = _drive(PORT, seed)
    assert got == _drive(ref, seed)
    assert got[1] != _drive(PORT, seed + 1)[1]
    kinds = {e[1] for e in got[0]}
    assert {"drop_before", "delay", "error", "duplicate", "drop_after", "wan", "partition",
            "partition_oneway", "torn_write", "rot_healed", "corrupt"} <= kinds


@pytest.mark.parametrize("server", ["port", "ref"])
def test_http_door_knobs_against_either_server(ref, server):
    svc = _Svc()
    pkg = PORT if server == "port" else ref
    srv = pkg.rpc.RpcServer(pkg.rpc.expose(svc)).start()
    try:
        addr = srv.addr
        assert rpc.call(addr, "ping")[0]["n"] == 1  # seeds the keep-alive pool
        # _stale half-closes the pooled socket: the retry on a fresh one lands
        assert rpc._http_call(addr, "ping", {}, b"", 5.0, _stale=True)[0]["n"] == 2
        # _corrupt flips a byte under the CRC header: the server refuses it
        with pytest.raises(rpc.RpcError) as ei:
            rpc._http_call(addr, "ping", {}, b"payload", 5.0, _corrupt=True)
        assert ei.value.code == 400 and "crc" in ei.value.message and svc.count == 2
        # the door: an installed plan sees the attempt and serves its fault
        plan = fi.FaultPlan(seed=3).on(addr, "ping", kind="drop_after", times=1)
        with fi.installed(plan):
            with pytest.raises(rpc.ServiceUnavailable, match="drop-after"):
                rpc.call(addr, "ping", body=b"x")
            assert rpc.call(addr, "ping", body=b"y") == ({"n": 4}, b"y")
        assert svc.count == 4 and [e[1:4] for e in plan.schedule()] == \
            [("drop_after", addr, "ping")]
    finally:
        srv.stop()


def test_no_plan_costs_one_identity_check(monkeypatch):
    def trap(*a, **k):
        raise AssertionError("a plan hook ran with no plan installed")

    for name in ("around_http", "around_direct", "disk_broken", "at_rest_fault", "_decide"):
        monkeypatch.setattr(fi.FaultPlan, name, trap)
    svc = _Svc()
    pool = rpc.NodePool()
    pool.bind("a", svc)
    srv = rpc.RpcServer(rpc.expose(svc)).start()
    try:
        assert pool.get("a").call("ping")[0]["n"] == 1
        assert rpc.call(srv.addr, "ping")[0]["n"] == 2
    finally:
        srv.stop()
    fi.gate("lc", "phase:any")
    assert rpc._fault is None and fi.current() is None
    assert fi.sender("a") is fi.sender(None) is fi.sender("b")  # one shared no-op


def test_demo_cli_prints_the_reference_demo(ref):
    outs = [subprocess.run([sys.executable, "-m", f"{pkg}.utils.faultinject", "--demo"],
                           capture_output=True, text=True, timeout=60)
            for pkg in ("cubefs_tpu_torch", "cubefs_tpu")]
    assert [o.returncode for o in outs] == [0, 0], outs[0].stderr + outs[1].stderr
    assert outs[0].stdout == outs[1].stdout
    assert "exactly-once" in outs[0].stdout and "schedule digest:" in outs[0].stdout
    assert fi.main([]) == 0
