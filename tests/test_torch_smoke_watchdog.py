"""The deadlines of ``chip_smoke.py`` (``Watchdog``), on the CPU.

A phase that overruns its budget, or a script that overruns its own,
must name the phase in one JSON line, print every thread's stack, stop
every process the script started (a tool in a session of its own, and
what it forked, included) and end the script with exit code 1. Each
case runs a small script in a process of its own, since the watchdog
ends the process it guards. Every phase ``main`` arms has a budget.
"""

import ast
import json
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

GUARDED = textwrap.dedent("""
    import json, subprocess, sys, time
    sys.path.insert(0, {root!r})
    import chip_smoke
    budgets, total, arms = json.loads(sys.argv[1])
    w = chip_smoke.Watchdog(budgets, total)
    quiet = dict(stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    kids = [subprocess.Popen(["sleep", "60"], **quiet),
            subprocess.Popen(["bash", "-c", "sleep 61 & wait"], start_new_session=True, **quiet)]
    print(json.dumps({{"kids": [k.pid for k in kids]}}), flush=True)
    for name, secs in arms:
        w.arm(name)
        time.sleep(secs)
    w.disarm()
    time.sleep(max(budgets.values()) + 0.5)
    chip_smoke.stop_processes([k.pid for k in kids], grace=2.0)
    print(json.dumps({{"done": True}}), flush=True)
""")


def run_guarded(budgets: dict, total: float, arms: list) -> tuple[int, list, str, list[int]]:
    proc = subprocess.run(
        [sys.executable, "-c", GUARDED.format(root=ROOT), json.dumps([budgets, total, arms])],
        capture_output=True, text=True, timeout=60)
    lines = proc.stdout.splitlines()
    kids = json.loads(lines[0])["kids"]
    records = [json.loads(ln) for ln in lines[1:] if ln.startswith("{")]
    return proc.returncode, records, proc.stdout, kids


def test_a_phase_that_overruns_names_itself_stops_its_processes_and_exits_1():
    rc, records, out, kids = run_guarded({"quick": 5.0, "stuck": 1.0}, 30.0,
                                         [["quick", 0.2], ["stuck", 20.0]])
    assert rc == 1
    (rec,) = records
    assert rec["phase"] == "stuck" and rec["limit"] == "phase" and rec["budget_s"] == 1.0
    assert 1.0 <= rec["overran_s"] < 5.0 and 0.2 <= rec["seconds"]["quick"] < 1.0
    assert "most recent call first" in out and "in _fire" in out  # every thread's stack
    assert not any(chip_smoke.running(pid) for pid in kids)


def test_the_script_deadline_holds_across_re_armed_phases():
    rc, records, _, kids = run_guarded({"a": 10.0, "b": 10.0, "c": 10.0}, 1.5,
                                       [["a", 0.6], ["b", 0.6], ["c", 5.0]])
    assert rc == 1
    (rec,) = records
    assert rec["phase"] == "c" and rec["limit"] == "script"
    assert set(rec["seconds"]) == {"a", "b"} and rec["script_s"] >= 1.5
    assert not any(chip_smoke.running(pid) for pid in kids)


def test_a_disarmed_watchdog_lets_the_script_finish():
    rc, records, _, _ = run_guarded({"a": 1.0}, 2.0, [["a", 0.1]])
    assert rc == 0 and records == [{"done": True}]


def _armed_phases() -> list[str]:
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    return [n.args[0].value for n in ast.walk(main)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr == "arm" and n.args and isinstance(n.args[0], ast.Constant)]


def test_every_phase_main_arms_has_a_budget():
    armed = _armed_phases()
    assert len(armed) == len(set(armed)) == len(chip_smoke.PHASE_BUDGETS)
    assert set(armed) == set(chip_smoke.PHASE_BUDGETS)
    assert armed.index("batcher_dp") == armed.index("batcher") + 1
    assert chip_smoke.PHASE_BUDGETS["batcher_dp"] <= 30


@pytest.mark.parametrize("pid_kind", ["child", "grandchild"])
def test_descendants_finds_every_process_below(pid_kind):
    shell = subprocess.Popen(["bash", "-c", "sleep 30 & echo $!; wait"], stdout=subprocess.PIPE,
                             text=True)
    try:
        grandchild = int(shell.stdout.readline())
        below = chip_smoke.descendants(os.getpid())
        assert (shell.pid if pid_kind == "child" else grandchild) in below
    finally:
        chip_smoke.stop_processes([grandchild, shell.pid], grace=2.0)
        shell.wait(10)
    assert not chip_smoke.running(grandchild)


def test_static_ports_are_below_the_ephemeral_range_and_never_repeat():
    with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
        low = int(f.read().split()[0])
    ports = [chip_smoke.free_port() for _ in range(64)]
    assert len(set(ports)) == len(ports)
    assert all(1024 <= p < min(low, 16000) for p in ports)


def test_a_role_dumps_its_stacks_on_sigusr1_and_serves_on(tmp_path, capsys):
    """``python -m cubefs_tpu_torch.cmd`` writes every thread's stack to
    its log on SIGUSR1 and keeps serving; ``dump_role_stacks`` prints
    that log's tail."""
    from cubefs_tpu_torch.deploy.cluster import Proc
    from cubefs_tpu_torch.utils import rpc

    role = Proc("master", {"role": "master", "listen_port": 0,
                           "data_dir": str(tmp_path / "master")}, str(tmp_path))
    try:
        addr = role.wait_addr(60.0)
        capsys.readouterr()
        chip_smoke.dump_role_stacks([role.p.pid, os.getpid()])
        out = capsys.readouterr().out
        assert f"--- role process {role.p.pid}, {role.log_path}" in out
        assert "most recent call first" in out and "in main" in out
        with pytest.raises(rpc.RpcError, match="404"):  # it serves on
            rpc.call(addr, "client_view", {"name": "none"})
        assert role.p.poll() is None
    finally:
        role.p.terminate()
        assert role.p.wait(30) == 0
