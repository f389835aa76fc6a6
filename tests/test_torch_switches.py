"""Six reference switches the port now reads, each flipped and held
against the reference on the CPU:

- ``CUBEFS_TRACE`` (the tracing layer's kill door) and
  ``CUBEFS_TRACE_SAMPLE`` (head sampling): the reference's own door and
  sampling scenarios of ``tests/test_trace_obs.py`` run on the port
  (``port_copy``), and for each setting both packages read the same
  values and record the same span trees for the same seeded workload;
- ``CUBEFS_SANITIZE`` (the lock witness, read when ``utils/lockwitness``
  is imported): in a fresh interpreter per setting, both packages turn
  the witness on or leave plain locks alike;
- ``CUBEFS_CODEC_MSR`` (MSR-coded volumes' repair path): the same disk
  of twin EC4P4MSR clusters repaired under each setting gives the same
  shards in both packages, through the sub-shard path at ``1`` and the
  conventional rows at ``0``;
- ``CUBEFS_CODEC_DP`` and ``CUBEFS_CODEC_DP_MIN_BYTES`` (the batcher's
  dp split, read when a ``BatchCodec`` is built): the same values in
  both, and a step splits in both packages or in neither, to the same
  bytes.

The file-system plane's switches of the slice are flipped in
``tests/test_torch_split.py`` (``CUBEFS_META_SPLIT``),
``tests/test_torch_readcache.py`` (``CUBEFS_READ_CACHE``,
``CUBEFS_READ_HOT``) and ``tests/test_torch_georepl.py``
(``CUBEFS_GEO``).

Tolerance: exact equality.
"""

import json
import os
import subprocess
import sys

import pytest

from cubefs_tpu_torch.codec import codemode as cmode
from cubefs_tpu_torch.fs import metanode as port_mn
from cubefs_tpu_torch.utils import metrics
from cubefs_tpu_torch.utils import trace as port_trace
from cubefs_tpu_torch.utils.retry import MONOTONIC
from test_torch_blob import PORT, Cluster, _isolated, payload, ref, ref_routing  # noqa: F401
from test_torch_raft import port_copy, run_scenario

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE_OBS = port_copy("test_trace_obs")
DOORS = ("test_trace_door_off_means_zero_spans_and_identical_fsm",
         "test_sampled_out_roots_skip_collection")


@pytest.fixture
def traces(monkeypatch):
    """Both packages' collectors empty, their clocks real, their ids
    seeded alike and the trace switches unset, before and after."""
    from cubefs_tpu.utils import retry as ref_retry
    from cubefs_tpu.utils import trace as ref_trace

    for var in ("CUBEFS_TRACE", "CUBEFS_TRACE_SAMPLE", "CUBEFS_SLOW_MS"):
        monkeypatch.delenv(var, raising=False)
    pairs = ((port_trace, MONOTONIC), (ref_trace, ref_retry.MONOTONIC))
    for mod, clock in pairs:
        mod.reset_collector()
        mod.set_clock(clock)
    yield {"port": port_trace, "ref": ref_trace}
    for mod, clock in pairs:
        mod.set_clock(clock)
        mod.reset_collector()


@pytest.mark.parametrize("name", DOORS)
def test_reference_trace_door_scenario_on_the_port(name, traces, request):
    run_scenario(TRACE_OBS, name, request)


def _workload(trace, mn) -> dict:
    """Twelve roots with a stage each over a partition, ids seeded: what
    each setting leaves in the collector, and the FSM it built."""
    trace.seed_ids(7)
    mp = mn.MetaPartition(1, 1, 1 << 20)
    for i in range(12):
        with trace.path_span("meta.write", "client.submit"):
            with trace.stage("raft_apply"):
                mp.apply({"op": "mknod", "parent": mn.ROOT_INO, "name": f"f{i}",
                          "type": mn.FILE, "mode": 0o644, "ts": 1.0, "op_id": f"w-{i}"})
    spans = trace.finished_spans()
    return {"enabled": trace.enabled(), "rate": trace._sample_rate(),
            "spans": sorted((s["op"], s["trace_id"], s["span_id"]) for s in spans),
            "traces": len(trace.known_trace_ids()), "fsm": mp.export_state()}


@pytest.mark.parametrize("env", [{}, {"CUBEFS_TRACE": "0"}, {"CUBEFS_TRACE": "1"},
                                 {"CUBEFS_TRACE_SAMPLE": "0.0"},
                                 {"CUBEFS_TRACE_SAMPLE": "0.5"},
                                 {"CUBEFS_TRACE_SAMPLE": "x"},
                                 {"CUBEFS_TRACE": "0", "CUBEFS_TRACE_SAMPLE": "1.0"}],
                         ids=["default", "off", "on", "sample_0", "sample_half",
                              "sample_bad", "off_sampled"])
def test_switch_trace_and_trace_sample_flipped(traces, monkeypatch, env):
    from cubefs_tpu.fs import metanode as ref_mn

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port = _workload(traces["port"], port_mn)
    want = _workload(traces["ref"], ref_mn)
    assert port == want
    if env.get("CUBEFS_TRACE") == "0" or env.get("CUBEFS_TRACE_SAMPLE") == "0.0":
        assert port["spans"] == []
    elif env.get("CUBEFS_TRACE_SAMPLE") == "0.5":
        assert 0 < port["traces"] < 12
    else:
        assert port["traces"] == 12


_SANITIZE_PROBE = """
import json, threading
from cubefs_tpu.utils import lockwitness as ref
from cubefs_tpu_torch.utils import lockwitness as port
out = {}
for name, lw in (("ref", ref), ("port", port)):
    lock = lw.make_lock("Probe._lock")
    out[name] = {"active": lw.active() is not None,
                 "plain": type(lock) is type(threading.Lock())}
print(json.dumps(out))
"""


@pytest.mark.parametrize("value", [None, "1", "true", "on", "0", "no"])
def test_switch_sanitize_flipped(value):
    """``CUBEFS_SANITIZE`` is read once, when ``utils/lockwitness`` is
    imported: a fresh interpreter per setting, both packages alike."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("CUBEFS_SANITIZE", None)
    if value is not None:
        env["CUBEFS_SANITIZE"] = value
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    out = subprocess.run([sys.executable, "-c", _SANITIZE_PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["port"] == got["ref"]
    on = value in ("1", "true", "on")
    assert got["port"] == {"active": on, "plain": not on}


@pytest.mark.parametrize("value", ["1", "0"])
def test_switch_codec_msr_flipped(ref, ref_routing, tmp_path, rng, monkeypatch, value):
    """One disk of twin EC4P4MSR clusters repaired with
    ``CUBEFS_CODEC_MSR`` at ``value``: the same rebuilt shards in both
    packages, and the same path: sub-shard reads at ``1``, none at
    ``0`` (the conventional rows, no fallback)."""
    from cubefs_tpu.utils import metrics as ref_metrics

    monkeypatch.setenv("CUBEFS_CODEC_MSR", value)
    shape = dict(n_nodes=4, disks_per_node=3, azs=None, colocated=True, blob_size=32 << 10)
    want = Cluster(ref, tmp_path / "ref", **shape)
    got = Cluster(PORT, tmp_path / "port", engine="cuda", **shape)
    data = payload(rng, 60_000)
    code = cmode.CodeMode.EC4P4MSR
    a, b = want.access.put(data, codemode=code), got.access.put(data, codemode=code)
    assert b.to_dict() == a.to_dict()
    victim = got.cm.get_volume(b.slices[0].vid).units[2]
    reads = {}
    for c, m in ((want, ref_metrics), (got, metrics)):
        s0 = m.repair_subshard_reads.value()
        f0 = sum(v for _, v in m.repair_msr_fallbacks.samples())
        assert c.sched.mark_disk_broken(victim.disk_id) >= 1
        c.node_of(victim.node_addr).break_disk(victim.disk_id)
        c.drain_worker()
        assert c.worker.failed == 0
        reads[c is got] = (m.repair_subshard_reads.value() - s0,
                           sum(v for _, v in m.repair_msr_fallbacks.samples()) - f0)
    assert got.shards() == want.shards()
    assert reads[True] == reads[False]
    assert (reads[True][0] > 0) == (value == "1") and reads[True][1] == 0
    assert got.access.get(b) == want.access.get(a) == data


@pytest.mark.parametrize("dp,min_bytes", [(None, None), ("1", "0"), ("0", "0"), ("1", "65536"),
                                          ("1", "262144"), ("1", "many")])
def test_switch_codec_dp_flipped(monkeypatch, dp, min_bytes):
    """``CUBEFS_CODEC_DP`` and ``CUBEFS_CODEC_DP_MIN_BYTES``, read when a
    batcher is built: both packages read the same values (an unreadable
    size falls back to 1 MiB), and a 192 KiB step of 8 stripes splits
    in both or in neither (the reference over its 8-device mesh, the
    port over 8 CPU devices), with the same bytes."""
    import numpy as np
    import torch

    from cubefs_tpu.codec import batcher as ref_batcher
    from cubefs_tpu.utils import metrics as ref_metrics
    from cubefs_tpu_torch.codec import batcher as port_batcher

    for var, value in (("CUBEFS_CODEC_DP", dp), ("CUBEFS_CODEC_DP_MIN_BYTES", min_bytes)):
        if value is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, value)
    rb = ref_batcher.BatchCodec(enabled=True)
    bc = port_batcher.BatchCodec(enabled=True, devices=["cpu"] * 8)
    assert (bc.dp_enabled, bc.dp_min_bytes) == (rb.dp_enabled, rb.dp_min_bytes)
    x = np.random.default_rng(6).integers(0, 256, (8, 6, 4096), dtype=np.uint8)
    counts = []
    for m in (ref_metrics, metrics):
        counts.append(-sum(v for _, v in m.codec_batch_dp_steps.samples()))
    want = rb.submit_encode("tpu", x, 3)
    got = bc.submit_encode("cpu", torch.from_numpy(x), 3).numpy()
    for i, m in enumerate((ref_metrics, metrics)):
        counts[i] += sum(v for _, v in m.codec_batch_dp_steps.samples())
    assert np.array_equal(got, want)
    splits = dp != "0" and min_bytes in ("0", "65536")
    assert counts == [int(splits)] * 2
