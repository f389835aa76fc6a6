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
import signal
import subprocess
import sys
import textwrap
import threading
import time

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


# -- --phases and --repeat ------------------------------------------------------

def test_no_arguments_run_every_phase_once():
    args = chip_smoke.parse_args([])
    assert args.phases is None and args.repeat == 1


def test_phases_and_repeat_name_what_runs():
    args = chip_smoke.parse_args(["--phases", "s3,fs", "--repeat", "16"])
    assert args.phases == ["s3", "fs"] and args.repeat == 16
    assert chip_smoke.parse_args(["--phases", "s3"]).repeat == 1


@pytest.mark.parametrize("argv", [["--phases", "nope"], ["--phases", "s3,s3"],
                                  ["--phases", "build"], ["--phases", "s3", "--repeat", "0"],
                                  ["--repeat", "2"], ["--phases", "s3", "--repeat", "x"],
                                  ["--bogus"]])
def test_bad_arguments_exit_2_before_the_card_is_asked(argv, monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: pytest.fail("asked for the card"))
    with pytest.raises(SystemExit) as e:
        chip_smoke.main(argv)
    assert e.value.code == 2 and "usage: chip_smoke.py" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [[], ["--phases", "s3", "--repeat", "3"]])
def test_without_a_card_it_exits_2_and_prints_no_result(argv, monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main(argv) == 2
    assert capsys.readouterr().out == ""


def test_every_repeatable_phase_has_its_function_and_a_budget():
    import torch

    fns = chip_smoke.phase_fns("/repo", torch.device("cpu"), "card")
    assert tuple(fns) == chip_smoke.REPEATABLE
    assert set(chip_smoke.REPEATABLE) <= set(chip_smoke.PHASE_BUDGETS) - {"build", "kernels"}
    for name, fn in fns.items():
        assert fn.func.__name__ == f"{name}_phase"
        assert fn.args[-1] == "card" and (fn.args[0] == "/repo") == (name == "engines")


def test_the_repeated_script_s_deadline_is_its_phases_budgets():
    b = chip_smoke.PHASE_BUDGETS
    assert chip_smoke.repeat_budget(["s3"], 16) == b["build"] + 16 * b["s3"]
    assert chip_smoke.repeat_budget(["fs", "s3"], 2) == b["build"] + 2 * (b["fs"] + b["s3"])


REPEATED = textwrap.dedent("""
    import json, sys, time
    sys.path.insert(0, {root!r})
    import chip_smoke
    budgets, repeat, fail_run, b_secs = json.loads(sys.argv[1])
    chip_smoke.PHASE_BUDGETS.update(budgets)
    runs = {{"a": 0, "b": 0}}

    def phase(name, secs):
        def fn():
            runs[name] += 1
            time.sleep(secs)
            ok = not (name == "b" and runs[name] == fail_run)
            return {{"phase": name, "checks": {{"ok": ok}},
                    "cases": {{"list_v2": {{"ms": 12.5}}, "put": {{"ms": 3.0}}}}}}
        return fn

    w = chip_smoke.Watchdog(chip_smoke.PHASE_BUDGETS, 30.0)
    w.arm("build")
    chip_smoke.run_phases(w, {{"a": phase("a", 0.1), "b": phase("b", b_secs)}}, ["a", "b"], repeat)
    w.disarm()
    print(json.dumps({{"done": runs}}), flush=True)
""")


def run_repeated(budgets: dict, repeat: int, fail_run: int = 0,
                 b_secs: float = 0.2) -> tuple[int, list, str]:
    proc = subprocess.run(
        [sys.executable, "-c", REPEATED.format(root=ROOT),
         json.dumps([budgets, repeat, fail_run, b_secs])],
        capture_output=True, text=True, timeout=60)
    return (proc.returncode, [json.loads(ln) for ln in proc.stdout.splitlines()
                              if ln.startswith("{")], proc.stdout + proc.stderr)


def test_repeated_phases_print_each_run_s_seconds_and_listings():
    rc, records, _ = run_repeated({"a": 5.0, "b": 5.0}, 3)
    assert rc == 0
    runs = [r for r in records if "run" in r]
    assert [r["run"] for r in runs] == [0, 1, 2]
    for r in runs:
        assert set(r["phase_seconds"]) == {"a", "b"}
        assert 0.1 <= r["phase_seconds"]["a"] < 1.0 and 0.2 <= r["phase_seconds"]["b"] < 1.0
        assert r["listing_ms"] == {"a.list_v2": 12.5, "b.list_v2": 12.5}
    assert [r["phase"] for r in records if "phase" in r] == ["a", "b"] * 3
    assert records[-1] == {"done": {"a": 3, "b": 3}}


def test_a_failed_run_raises_and_runs_no_more():
    rc, records, out = run_repeated({"a": 5.0, "b": 5.0}, 4, fail_run=2)
    assert rc == 1 and "AssertionError: b checks failed in run 1: ['ok']" in out
    assert [r["run"] for r in records if "run" in r] == [0]
    assert not any("done" in r for r in records)


def test_a_repeated_phase_is_held_to_its_own_budget():
    rc, records, out = run_repeated({"a": 5.0, "b": 0.5}, 2, b_secs=20.0)
    assert rc == 1
    (over,) = [r for r in records if "overran_s" in r]
    assert over["phase"] == "b" and over["budget_s"] == 0.5 and over["limit"] == "phase"
    assert [r["run"] for r in records if "run" in r] == []
    assert "most recent call first" in out


STALLED = textwrap.dedent("""
    import sys, time
    sys.path.insert(0, {root!r})
    import chip_smoke
    with chip_smoke.StallProbe("quick call", 2.0):
        time.sleep(0.1)
    with chip_smoke.StallProbe("slow call", 0.3):
        time.sleep(1.0)
    print("went on", flush=True)
""")


def test_a_stalled_call_prints_its_stacks_once_and_goes_on():
    proc = subprocess.run([sys.executable, "-c", STALLED.format(root=ROOT)],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0
    lines = proc.stdout.splitlines()
    assert [json.loads(ln) for ln in lines if ln.startswith("{")] == [
        {"stall": "slow call", "after_s": 0.3}]
    assert proc.stdout.count("most recent call first") >= 2  # the timer's thread and main's
    assert "time.sleep" in proc.stdout or "<module>" in proc.stdout
    assert lines[-1] == "went on"


def test_a_busy_role_survives_every_sigusr1_and_serves_on(tmp_path):
    """A role writes its stacks on SIGUSR1 while its threads serve calls,
    and neither crashes nor stops serving, however often the signal comes
    (a handler that walks the threads' frames while they run can crash
    the process it reports on)."""
    from cubefs_tpu_torch.deploy.cluster import Proc
    from cubefs_tpu_torch.utils import rpc

    role = Proc("master", {"role": "master", "listen_port": 0,
                           "data_dir": str(tmp_path / "master")}, str(tmp_path))
    stop, errors = threading.Event(), []

    def hammer():
        while not stop.is_set():
            try:
                rpc.call(addr, "stat")
            except Exception as e:  # noqa: BLE001 - recorded, asserted below
                errors.append(repr(e))
                return

    try:
        addr = role.wait_addr(60.0)
        threads = [threading.Thread(target=hammer) for _ in range(6)]
        for t in threads:
            t.start()
        for _ in range(40):
            os.kill(role.p.pid, signal.SIGUSR1)
            time.sleep(0.05)
        time.sleep(1.0)
        stop.set()
        for t in threads:
            t.join(30)
        assert role.p.poll() is None and errors == []
        assert rpc.call(addr, "stat")[0]["metanodes"] == 0
        with open(role.log_path) as f:
            assert "most recent call first" in f.read()
    finally:
        stop.set()
        role.p.terminate()
        assert role.p.wait(30) == 0
