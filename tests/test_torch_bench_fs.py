"""The port's file-system benchmark harness (``cubefs_tpu_torch/tool/bench_fs.py``)
held against the reference's (``cubefs_tpu/tool/bench_fs.py``) on the CPU.

- ``tests/test_aux.py``'s ``test_fs_bench_tool`` runs on the port
  (``port_copy``);
- the mdtest/fio run (``_inprocess_fs`` + ``run``) returns the reference's
  keys, every rate above 0;
- the FSM digests of the fixed tapes are the reference's, bit for bit:
  ``fsm_identity_check`` (pipelined and control write paths),
  ``_obs_digest_leg`` (trace door on and off), ``_split_identity_leg``
  (the elastic door off, a sweep mid-tape) and ``_wire_leg``'s serial
  tape over the packet plane (mux door on and off), with its blob and
  small-file bytes;
- ``merge_artifact`` writes the reference's file;
- ``main`` prints the reference's keys, and ``--wire-ab``, ``--geo-ab``
  and ``--split-ab`` exit with the reference's codes for a passing and a
  failing summary;
- the saturated create over the wire follows a leader change to the
  peer's packet plane, where the reference's worker gives up;
- a leg whose ``getrusage`` reads no CPU time (a kernel that counts it in
  coarse ticks) reports 0 and goes on;
- importing the tool loads neither torch nor jax.

The A/B modes, each in both packages, are ``tests/test_torch_bench_fs_ab.py``.
Tolerance: exact equality.
"""

import json
import multiprocessing
import os
import queue
import subprocess
import sys
import threading
import time
import types

import pytest

from cubefs_tpu_torch.tool import bench_fs
from test_torch_raft import port_copy, run_scenario

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUX = port_copy("test_aux")


@pytest.fixture(scope="module")
def ref():
    from cubefs_tpu.tool import bench_fs as ref_bench

    return ref_bench


def test_reference_fs_bench_scenario_on_the_port(request):
    run_scenario(AUX, "test_fs_bench_tool", request)


def _run(mod, workdir):
    fs, metas = mod._inprocess_fs(workdir)
    try:
        return mod.run(fs, files=12, io_mb=2, threads=4)
    finally:
        for m in metas:
            m.stop()


def test_run_returns_the_references_keys(tmp_path, ref):
    port = _run(bench_fs, str(tmp_path / "port"))
    want = _run(ref, str(tmp_path / "ref"))
    assert list(port) == list(want)
    assert all(v > 0 for v in port.values()), port


# ---------------- the fixed tapes' digests ----------------

def test_fsm_identity_check_digests_are_the_references(tmp_path, ref):
    port = bench_fs.fsm_identity_check(str(tmp_path / "port"), n_parts=2, records_per_part=20)
    want = ref.fsm_identity_check(str(tmp_path / "ref"), n_parts=2, records_per_part=20)
    assert port["bit_identical"] and want["bit_identical"]
    assert port == want


def test_obs_digest_leg_is_the_references_at_both_trace_doors(tmp_path, ref, monkeypatch):
    for door in ("1", "0"):
        monkeypatch.setenv("CUBEFS_TRACE", door)
        port = bench_fs._obs_digest_leg(str(tmp_path / f"port{door}"), records_per_part=20)
        want = ref._obs_digest_leg(str(tmp_path / f"ref{door}"), records_per_part=20)
        assert port == want
        assert all(len(set(per_node.values())) == 1 for per_node in port.values())


def test_split_identity_leg_is_the_references(tmp_path, ref, monkeypatch):
    monkeypatch.delenv("CUBEFS_META_SPLIT", raising=False)
    port = bench_fs._split_identity_leg(str(tmp_path / "port"), records_per_part=20)
    want = ref._split_identity_leg(str(tmp_path / "ref"), records_per_part=20)
    assert port["bit_identical"] and port["sweeps_inert"]
    assert port == want


def _wire_payloads():
    import hashlib

    blob = hashlib.sha256(b"wire-ab-blob").digest()
    blob = (blob * ((2 << 20) // len(blob) + 1))[:(2 << 20) + 5]  # crosses the chunk size
    return blob, hashlib.sha256(b"wire-ab-small").digest() * 128


@pytest.mark.parametrize("door", ["1", "0"], ids=["mux_on", "mux_off"])
def test_wire_leg_tape_and_bytes_are_the_references(door, tmp_path, ref, monkeypatch):
    monkeypatch.setenv("CUBEFS_PKT_MUX", door)
    blob, small = _wire_payloads()
    kw = {"n_objects": 1, "n_meta_writes": 40, "n_small_reads": 16}
    port = bench_fs._wire_leg(str(tmp_path / "port"), blob, small, **kw)
    want = ref._wire_leg(str(tmp_path / "ref"), blob, small, **kw)
    assert list(port) == list(want)
    for k in ("mux", "window", "fsm_digest", "blob_sha", "fs_read_sha"):
        assert port[k] == want[k], k


# ---------------- merge_artifact, main ----------------

def test_merge_artifact_writes_the_references_file(tmp_path, ref):
    for mod, name in ((bench_fs, "port.json"), (ref, "ref.json")):
        path = str(tmp_path / "sub" / name)
        mod.merge_artifact(path, "wire_ab", {"a": 1, "b": [1.5, None]})
        mod.merge_artifact(path, "fs_read", {"c": "x"})
        mod.merge_artifact(path, "wire_ab", {"a": 2})
    with open(tmp_path / "sub" / "port.json") as f:
        port = f.read()
    with open(tmp_path / "sub" / "ref.json") as f:
        assert port == f.read()
    assert json.loads(port) == {"wire_ab": {"a": 2}, "fs_read": {"c": "x"}}


def test_main_prints_the_references_keys(capsys, ref):
    argv = ["--files", "8", "--io-mb", "1", "--threads", "2"]
    bench_fs.main(argv)
    port = json.loads(capsys.readouterr().out)
    ref.main(argv)
    want = json.loads(capsys.readouterr().out)
    assert list(port) == list(want)


# (flag, the function main calls, the summary keys its exit code reads)
EXITS = [("--wire-ab", "wire_ab", ("fsm_digest_identical", "blob_bytes_identical")),
         ("--geo-ab", "geo_ab", ("ok",)),
         ("--split-ab", "split_ab", ("ok",))]


@pytest.mark.parametrize("flag,fn,keys", EXITS, ids=[e[0][2:] for e in EXITS])
@pytest.mark.parametrize("ok", [True, False], ids=["ok", "failing"])
def test_main_exit_codes_are_the_references(flag, fn, keys, ok, ref, monkeypatch, tmp_path,
                                            capsys):
    codes = []
    for mod in (bench_fs, ref):
        monkeypatch.setattr(mod, fn, lambda *a, **kw: {"summary": dict.fromkeys(keys, ok)})
        with pytest.raises(SystemExit) as exc:
            mod.main([flag, "--out", str(tmp_path / f"{mod.__name__}.json")])
        codes.append(exc.value.code)
    capsys.readouterr()
    assert codes == [0 if ok else 1] * 2


# ---------------- the saturated create across a leader change ----------------

def test_a_saturated_create_worker_follows_the_leader_to_its_peer(tmp_path, ref, monkeypatch):
    """The wire A/B's saturated-create server pair serves the packet plane
    on both nodes and names them (``peers``). A worker handed the
    follower's plane, as after an election moved the partition off the
    node whose plane it was given, follows the redirect's leader hint and
    lands every record once. The reference's worker, handed the same
    plane, retries it until it gives up (its sleeps skipped here)."""
    parent, child = multiprocessing.Pipe()
    server = threading.Thread(target=bench_fs._wire_sat_server_main,
                              args=(child, str(tmp_path)), daemon=True)
    server.start()
    hello = parent.recv()
    try:
        assert sorted(hello["peers"]) == ["wsat0", "wsat1"]
        assert hello["addr"] in hello["peers"].values()
        follower = next(a for a in hello["peers"].values() if a != hello["addr"])
        q = queue.Queue()
        bench_fs._wire_sat_worker_main(0, follower, 300, 64, q, hello["peers"])
        got = q.get_nowait()
        assert got["ok"] == 300, got
        monkeypatch.setattr(ref, "time", types.SimpleNamespace(
            perf_counter=time.perf_counter, sleep=lambda s: None))
        with pytest.raises(Exception, match="leader=wsat"):
            ref._wire_sat_worker_main(1, follower, 300, 64, q)
        assert "leader=wsat" in q.get_nowait()["error"]
    finally:
        parent.send("stop")
        assert "cpu_s" in parent.recv()
        server.join(timeout=30)
    assert not server.is_alive()


# ---------------- CPU time read in coarse ticks ----------------

def test_a_leg_that_reads_no_cpu_time_reports_zero(tmp_path, monkeypatch):
    """Every ``getrusage`` reads the same time, as on a kernel that counts
    CPU time in 10 ms ticks over a short leg: the saturated create over the
    wire reports 0 CPU seconds on both sides and finishes (the forked
    server and worker inherit the stand-in)."""
    import resource

    monkeypatch.setattr(resource, "getrusage",
                        lambda who: types.SimpleNamespace(ru_utime=1.0, ru_stime=0.5))
    out = bench_fs._wire_saturated_create(str(tmp_path), workers=1, records_per_worker=200,
                                          batch=64)
    assert out["records"] == 200
    assert out["worker_cpu_s"] == [0.0] and out["server_cpu_s"] == 0.0
    assert out["server_is_bottleneck"] is False


def test_importing_the_tools_loads_neither_torch_nor_jax():
    code = ("import sys\nimport cubefs_tpu_torch.tool.bench_fs, cubefs_tpu_torch.tool.aot_cuda\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('torch', 'jax', 'cubefs_tpu'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=60)
