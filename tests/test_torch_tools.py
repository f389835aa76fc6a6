"""The port's blob and codec tools (``cubefs_tpu_torch/blob/{dial,bench_tool}.py``,
``tool/{bench_codec,tier_ab,autofs}.py``) held against the reference's on
the CPU.

- ``tests/test_aux.py``'s ``test_access_through_proxy_and_dial`` and
  ``test_blob_bench_tool`` run on the port (``port_copy``, the blob roles
  on ``device="cpu"``);
- ``bench_codec``: a leg of ``run_ab`` on ``device="cpu"`` (engine
  ``cuda``, kernel A's plain version) returns the reference's outputs for
  the same seed, bit for bit; ``run_ab`` holds batched against unbatched
  and both against the host tables; ``run_repair_ab`` rebuilds the lost
  shard both ways with the reference's traffic accounting;
  ``run_fallback_ab``'s drill serves from ``numpy-xor`` and ``numpy`` by
  the XOR door; ``run_obs_tail`` round-trips on the CPU; with no card,
  the default device raises;
- ``tier_ab``'s legs on ``device="cpu"``: the stored-bytes ratios, the
  files transitioned, and the door-off digest equal to the control's and
  to the reference's digests of the same workload; no tool writes a file
  unless asked;
- ``autofs``'s default mount is the port's ``fs/fuse.mount``; the dial and
  blob-bench command lines run against an access server.

Tolerance: exact equality.
"""

import functools
import json

import numpy as np
import pytest
import torch

from cubefs_tpu_torch.blob import access, bench_tool, blobnode, dial
from cubefs_tpu_torch.tool import autofs, bench_codec, tier_ab
from cubefs_tpu_torch.utils import metrics, qos, rpc
from test_torch_raft import port_copy, run_scenario

AUX = port_copy("test_aux",
                AccessConfig=functools.partial(access.AccessConfig, device="cpu"),
                AccessHandler=access.AccessHandler,
                BlobNode=functools.partial(blobnode.BlobNode, device="cpu"))
mini_blob = AUX.mini_blob  # the scenarios' fixture


class _Still:
    def snapshot(self):
        return {}


@pytest.fixture(autouse=True)
def _port_qos_still(monkeypatch):
    monkeypatch.setattr(qos.DEFAULT, "_tracker", _Still())
    monkeypatch.setattr(qos.DEFAULT, "_levels", {})
    monkeypatch.setattr(qos.DEFAULT, "_last_refresh", float("-inf"))


@pytest.fixture(scope="module")
def ref_bench():
    from cubefs_tpu.tool import bench_codec as ref

    return ref


@pytest.mark.parametrize("name", ["test_access_through_proxy_and_dial", "test_blob_bench_tool"])
def test_reference_aux_scenario_on_the_port(name, request):
    run_scenario(AUX, name, request)


# ---------------- bench_codec ----------------

@pytest.mark.parametrize("batched", [True, False], ids=["batched", "unbatched"])
def test_a_run_ab_leg_equals_the_references(batched, ref_bench):
    """The same seed through the port's leg on the CPU (engine cuda, the
    plain version of A) and the reference's numpy leg: every submitter's
    last output is the same bytes."""
    port = bench_codec._run_leg(batched, 6, 5, 6, 3, 2048, "cuda", 0xBA7C4, 0.25, 2,
                                device="cpu")
    ref = ref_bench._run_leg(batched, 6, 5, 6, 3, 2048, "numpy", 0xBA7C4, 0.25, 2)
    assert sorted(port["outputs"]) == sorted(ref["outputs"]) == list(range(6))
    for tid, out in port["outputs"].items():
        assert out.dtype == np.uint8 and np.array_equal(out, ref["outputs"][tid])
    assert port["stripes"] == ref["stripes"] == 30


def test_run_ab_is_bit_identical_and_coalesces():
    steps0 = sum(v for k, v in metrics.codec_batch_steps.samples() if k[0] == "encode")
    out = bench_codec.run_ab(submitters=8, iters=6, rounds=2, device="cpu")
    assert out["bit_identical"] and out["equals_plain"]
    assert out["engine"] == "cuda" and out["device"] == "cpu"
    assert out["device_steps"] > 0 and out["mean_stripes_per_device_step"] >= 1
    assert sum(v for k, v in metrics.codec_batch_steps.samples() if k[0] == "encode") > steps0
    json.dumps(out)  # the record serializes: the outputs were stripped


def test_run_repair_ab_equals_the_references_accounting(ref_bench):
    port = bench_codec.run_repair_ab(stripes=6, rounds=1, device="cpu")
    ref = ref_bench.run_repair_ab(stripes=6, rounds=1, engine="numpy")
    assert port["bit_identical"] and ref["bit_identical"]
    for key in ("geometry", "bytes_pulled_per_stripe", "reduction_x", "cross_az_reduction_x"):
        assert port[key] == ref[key], key


def test_run_fallback_ab_serves_by_the_xor_door():
    out = bench_codec.run_fallback_ab(rounds=1, stripes=2, shard_ec=4096, shard_msr=6 * 1024)
    assert out["bit_identical"]
    assert out["drill"]["dead_engines"] == ["cuda", "cpp", "cpp-xor"]
    for w in out["workloads"].values():
        assert (w["xor"]["served_leg"], w["naive"]["served_leg"]) == ("numpy-xor", "numpy")


def test_run_obs_tail_round_trips_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.delenv("CUBEFS_TRACE", raising=False)
    out = bench_codec.run_obs_tail(str(tmp_path), puts=3, payload_kb=64, rounds=1,
                                   device="cpu")
    assert out["roundtrip_identical"] and out["interleaved"]
    assert len(out["trace_on"]["put_mibs"]) == len(out["trace_off"]["put_mibs"]) == 1


def test_bench_codec_merges_a_section_and_writes_only_where_asked(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    bench_codec.main(["--device", "cpu", "--submitters", "2", "--iters", "2", "--rounds", "1"])
    assert list(tmp_path.iterdir()) == []
    assert json.loads(capsys.readouterr().out)["bit_identical"]
    path = tmp_path / "rec.json"
    path.write_text(json.dumps({"fs": {"kept": 1}}))
    bench_codec.merge_artifact(str(path), "blob", {"x": 2})
    assert json.loads(path.read_text()) == {"fs": {"kept": 1}, "blob": {"x": 2}}


def test_bench_codec_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_codec.run_ab(submitters=2, iters=1, rounds=1)


# ---------------- tier_ab ----------------

def test_tier_ab_legs_on_the_cpu(tmp_path, monkeypatch):
    """Replicated hot bytes near 3x, the EC6P3 tier near 1.5x with every
    file transitioned, and the door-off digest equal to the control's."""
    monkeypatch.setattr(tier_ab, "FILES", 3)
    a = tier_ab.leg_replicated(str(tmp_path), 13)
    b = tier_ab.leg_tiered(str(tmp_path), 13, "cpu")
    d = tier_ab.leg_digests(str(tmp_path), 13, "cpu")
    assert 2.5 <= a["ratio"] <= 3.5 and a["logical_bytes"] == 3 * tier_ab.FILE_SIZE
    assert b["transitioned"] == 3 and 1.3 <= b["ratio"] <= 2.0
    assert d["identical"]


def test_tier_ab_digest_equals_the_references(tmp_path, monkeypatch):
    """The door-off leg's FSM digest of the same workload is the
    reference's: the two packages' metanodes decide the same state."""
    from cubefs_tpu.tool import tier_ab as ref_tier_ab

    monkeypatch.setattr(tier_ab, "FILES", 2)
    monkeypatch.setattr(ref_tier_ab, "FILES", 2)
    port = tier_ab.leg_digests(str(tmp_path / "port"), 5, "cpu")
    ref = ref_tier_ab.leg_digests(str(tmp_path / "ref"), 5)
    assert port["identical"] and ref["identical"]
    assert port["control_digest"] == ref["control_digest"]


def test_tier_ab_main_writes_only_where_asked(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tier_ab, "FILES", 2)
    rc = tier_ab.main(["--device", "cpu"])
    assert list(tmp_path.iterdir()) == []
    out = json.loads(capsys.readouterr().out)
    assert out["legs"][2]["identical"] and out["savings_x"] > 1
    assert rc == 0


# ---------------- autofs, dial and blob-bench ----------------

def test_autofs_mounts_through_the_ports_fuse_by_default(tmp_path, monkeypatch):
    from cubefs_tpu_torch.fs import fuse
    from test_torch_operators import OPS

    c = OPS.Cluster(tmp_path)
    try:
        mounted = []
        monkeypatch.setattr(fuse, "mount", lambda fs, mnt: mounted.append((fs, mnt)))
        entries = [{"mountpoint": str(tmp_path / "mnt"), "vol": "opvol", "master": "master"}]
        out = autofs.ensure_mounted(entries, pool=c.pool)
        assert out[0]["status"] == "mounted" and mounted[0][1] == str(tmp_path / "mnt")
        assert type(mounted[0][0]).__module__ == "cubefs_tpu_torch.fs.client"
    finally:
        c.stop()


def test_dial_and_blob_bench_command_lines(mini_blob, capsys):
    cm, cm_client, pool, _ = mini_blob
    acc = access.AccessHandler(cm_client, pool,
                               access.AccessConfig(blob_size=32 << 10, device="cpu"))
    srv = rpc.RpcServer(acc, service="access").start()
    try:
        ok0 = dial.dial_ops.value(op="get", ok=True)
        dial.main(["--access", srv.addr, "--size", "4096", "--interval", "0", "--count", "2"])
        assert capsys.readouterr().out.split("\n")[:2] == ["round 0: OK", "round 1: OK"]
        assert dial.dial_ops.value(op="get", ok=True) == ok0 + 2
        bench_tool.main(["--access", srv.addr, "--size", "8192", "--count", "4",
                         "--concurrency", "2"])
        out = json.loads(capsys.readouterr().out)
        assert out["count"] == 4 and out["put_mbps"] > 0 and out["get_mbps"] > 0
    finally:
        srv.stop()
        acc._pool.shutdown(wait=True)
