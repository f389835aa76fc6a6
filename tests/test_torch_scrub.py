"""The port's continuous scrubber (``cubefs_tpu_torch/utils/scrub.py``), the
scheduler's blob scrub (``Scheduler.make_scrubber``, whose parity
recompute is kernel A's wrapper), the ``CUBEFS_QOS`` door of
``utils/qos.py`` and the ``CUBEFS_VERIFY_READS`` door of the access
layer's read-repair, held against the reference's on the CPU.

- the generic-scrubber and blob scenarios of ``tests/test_integrity.py``
  and the brownout and door scenarios of ``tests/test_qos.py`` run on the
  port (``port_copy``; a blob scenario's cluster is the port's in-process
  cluster of ``tests/test_torch_blob.py``, engine ``cuda`` on the CPU);
- twin clusters of both packages, with the same seeded data, the same
  planted rot and the same silent corruption, give equal scrub results,
  verdicts, repair tasks, ``scrub_status``, detection counts and cursor
  bytes (in ``scrub_cursor.json`` and in the clustermgr's kv), and a
  cursor written by one package resumes in the other;
- ``CUBEFS_SCRUB``, ``CUBEFS_QOS`` and ``CUBEFS_VERIFY_READS`` flipped
  give the reference's results;
- the scheduler and its scrubber raise without a card unless asked for
  the CPU.

Tolerance: exact equality.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

from cubefs_tpu_torch.blob import clustermgr, scheduler
from cubefs_tpu_torch.codec import codemode as cmode
from cubefs_tpu_torch.utils import faultinject as fi
from cubefs_tpu_torch.utils import metrics, qos, rpc, scrub
from cubefs_tpu_torch.utils.retry import FakeClock
from test_torch_blob import PORT, Cluster, _isolated, ref_routing  # noqa: F401  (fixtures)
from test_torch_raft import port_copy, run_scenario

PORT.faultinject, PORT.metrics, PORT.qos, PORT.FakeClock = fi, metrics, qos, FakeClock


def port_cluster(root, **kw):
    return Cluster(PORT, root, engine="cuda", **kw)


INTEGRITY = port_copy("test_integrity", Cluster=port_cluster)
QOS = port_copy("test_qos", Cluster=port_cluster)
INTEGRITY_SCENARIOS = ["test_scrubber_cursor_resume_and_full_pass",
                       "test_scrubber_rate_limit_trickles", "test_scrubber_door_and_brownout",
                       "test_scrubber_unit_exception_is_skipped_not_fatal",
                       "test_blob_read_repair_heals_rotten_shard",
                       "test_blob_scrubber_flags_corrupt_volume"]
QOS_SCENARIOS = ["test_brownout_sheds_scrub_then_repair_never_foreground",
                 "test_door_off_returns_shared_noop",
                 "test_door_off_is_bit_identical_to_qos_on_no_overload"]
DOORS = ("CUBEFS_SCRUB", "CUBEFS_QOS", "CUBEFS_VERIFY_READS")


@pytest.fixture(autouse=True)
def _doors_and_plans(monkeypatch):
    """The three doors at their defaults, no fault plan of either package
    left installed, no brownout pinned, the tenant context clear."""
    for var in DOORS:
        monkeypatch.delenv(var, raising=False)
    assert rpc._fault is None, "a previous test leaked an installed plan"
    yield
    fi.uninstall()
    qos.DEFAULT._forced.clear()


_clean_tenant_context = QOS._clean_tenant_context  # the qos scenarios' autouse fixture


@pytest.mark.parametrize("name", INTEGRITY_SCENARIOS)
def test_reference_integrity_scenario_on_the_port(name, request):
    run_scenario(INTEGRITY, name, request)


@pytest.mark.parametrize("name", QOS_SCENARIOS)
def test_reference_qos_scenario_on_the_port(name, request):
    run_scenario(QOS, name, request)


@pytest.fixture(scope="module")
def ref():
    from cubefs_tpu.blob import access, blobnode, clustermgr, mq, scheduler, worker
    from cubefs_tpu.blob import types as btypes
    from cubefs_tpu.utils import faultinject, metrics, qos, rpc
    from cubefs_tpu.utils.retry import FakeClock

    return types.SimpleNamespace(access=access, blobnode=blobnode, clustermgr=clustermgr,
                                 mq=mq, scheduler=scheduler, worker=worker, rpc=rpc,
                                 types=btypes, faultinject=faultinject, metrics=metrics,
                                 qos=qos, FakeClock=FakeClock)


@pytest.fixture
def ref_plans(ref):
    yield
    ref.faultinject.uninstall()
    ref.qos.DEFAULT._forced.clear()


# ---------------- twin clusters ----------------

SIZES = (100_000, 37_000, 64_000, 5_000)  # EC6P3 over 16 KiB blobs: 1 to 7 stripes each


def _twins(ref, root, rng):
    want = Cluster(ref, root / "ref", blob_size=16 << 10)
    got = port_cluster(root / "port", blob_size=16 << 10)
    data = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in SIZES]
    locs = []
    for d in data:
        for c in (want, got):  # a second volume, so the cursor has units to walk
            c.cm.alloc_volume(int(cmode.CodeMode.EC6P3))
        a = want.access.put(d, codemode=cmode.CodeMode.EC6P3)
        b = got.access.put(d, codemode=cmode.CodeMode.EC6P3)
        assert b.to_dict() == a.to_dict()
        locs.append((a, b))
    return want, got, data, locs


def _targets(locs) -> list:
    """(vid, unit, bid) of the faults below: a data and a parity unit,
    and a data unit of another volume."""
    return [(sl.vid, idx, sl.min_bid) for sl, idx in ((locs[0][0].slices[0], 1),
                                                      (locs[2][0].slices[0], 7),
                                                      (locs[1][0].slices[0], 4))]


def _unit_shards(c, vid, idx) -> dict:
    u = c.cm.get_volume(vid).units[idx]
    node = c.node_of(u.node_addr)
    return {bid: node.get_shard(u.disk_id, u.chunk_id, bid)[0]
            for bid, _, _ in node.list_chunk(u.disk_id, u.chunk_id)}


def _rot(pkg, c, locs, seed=21):
    """The same faults on each twin: two planted rots (their reads
    surface a CRC refusal), and one silent corruption (the shard
    rewritten with wrong bytes under a valid CRC, which only the parity
    recompute sees)."""
    plan = pkg.faultinject.FaultPlan(seed=seed)
    pkg.faultinject.install(plan)
    (v1, i1, b1), (v2, i2, b2), (v3, i3, b3) = _targets(locs)
    for vid, idx, bid in ((v1, i1, b1), (v2, i2, b2)):
        u = c.cm.get_volume(vid).units[idx]
        plan.plant_rot(u.node_addr, u.disk_id, f"c{u.chunk_id}:b{bid}", kind="bitflip")
    u = c.cm.get_volume(v3).units[i3]
    node = c.node_of(u.node_addr)
    good = node.get_shard(u.disk_id, u.chunk_id, b3)[0]
    node.rpc_put_shard({"disk_id": u.disk_id, "chunk_id": u.chunk_id, "bid": b3},
                       bytes(b ^ 0x5A for b in good))


def _tasks(sched) -> list:
    return sorted((t["type"], t["vid"], t["unit_index"], t["reason"], t["state"])
                  for t in sched.tasks.values())


def _scrub(pkg, c):
    """A slice, then the rest of the pass, then a second pass: each
    result, each verdict by volume, the status and the kv cursor."""
    s = c.sched.make_scrubber(clock=pkg.FakeClock())
    verdicts = []
    unit = s.scrub_unit
    s.scrub_unit = lambda vid: verdicts.append((vid, unit(vid))) or verdicts[-1][1]
    det0 = pkg.metrics.integrity_corruptions_detected.value(plane="blob", source="scrub")
    first = s.run_once(max_units=2)
    cursor = c.cm.kv_get("sched/scrub_cursor")
    rest = s.run_full_pass()
    return {"first": first, "cursor": cursor, "rest": rest, "verdicts": verdicts,
            "detected": pkg.metrics.integrity_corruptions_detected.value(
                plane="blob", source="scrub") - det0,
            "status": c.sched.rpc_scrub_status({}, None), "tasks": _tasks(c.sched),
            "items": {o: pkg.metrics.scrub_items.value(plane="blob", outcome=o)
                      for o in ("clean", "corrupt", "skipped")}}


def test_twin_scrub_finds_the_same_units_and_heals_alike(ref, ref_routing, ref_plans, tmp_path,
                                                          rng):
    want, got, data, locs = _twins(ref, tmp_path, rng)
    pairs = [(vid, idx) for vid, idx, _ in _targets(locs)]
    before = {p: _unit_shards(got, *p) for p in pairs}
    items0 = [{o: pkg.metrics.scrub_items.value(plane="blob", outcome=o)
               for o in ("clean", "corrupt", "skipped")} for pkg in (ref, PORT)]
    for pkg, c in ((ref, want), (PORT, got)):
        _rot(pkg, c, locs)
    a, b = _scrub(ref, want), _scrub(PORT, got)
    items = [{o: r["items"][o] - i0[o] for o in i0} for r, i0 in ((a, items0[0]),
                                                                  (b, items0[1]))]
    a.pop("items"), b.pop("items")
    assert b == a and items[1] == items[0]
    assert sorted({(vid, i) for _, vid, i, _, _ in b["tasks"]}) == sorted(pairs)
    # the pass ends within run_full_pass's slice, which wraps to the rotten
    # volume 2 again: three refusals for two planted rots
    assert b["detected"] == 3 and b["rest"]["completed_pass"]
    assert {vid for vid, v in b["verdicts"] if v == "corrupt"} == {vid for vid, _ in pairs}
    assert json.loads(b["cursor"]) == {"cursor": b["verdicts"][1][0]}
    # the repairs rebuild each named unit elsewhere, byte for byte as the
    # PUT wrote it; a second pass is clean and reads are exact
    for c in (want, got):
        c.drain_worker()
        for p in pairs:
            assert _unit_shards(c, *p) == before[p]
    assert _tasks(got.sched) == _tasks(want.sched)
    again = [_scrub(pkg, c) for pkg, c in ((ref, want), (PORT, got))]
    assert again[1]["rest"]["corrupt"] == again[1]["first"]["corrupt"] == 0
    assert again[1]["verdicts"] == again[0]["verdicts"]
    for (x, y), d in zip(locs, data):
        assert got.access.get(y) == want.access.get(x) == d


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_scrub_cursor_file_resumes_in_either_package(ref, ref_routing, tmp_path, rng, direction):
    want, got, _, _ = _twins(ref, tmp_path, rng)
    clusters = {"ref": (ref, want), "port": (PORT, got)}

    def sched(tag, d):
        pkg, c = clusters[tag]
        dev = {"device": "cpu", "engine": "cuda"} if pkg is PORT else {}
        return pkg, pkg.scheduler.Scheduler(c.cm, node_pool=c.pool, data_dir=str(d), **dev)

    cursors = {}
    for tag in clusters:  # the same slice in each package: the same file
        pkg, s = sched(tag, tmp_path / f"{tag}-1")
        assert s.make_scrubber(clock=pkg.FakeClock()).run_once(max_units=3)["scanned"] == 3
        cursors[tag] = open(tmp_path / f"{tag}-1" / "scrub_cursor.json", "rb").read()
    assert cursors["port"] == cursors["ref"]
    writer, reader = direction.split("_to_")
    os.makedirs(tmp_path / "resume")
    with open(tmp_path / "resume" / "scrub_cursor.json", "wb") as f:
        f.write(cursors[writer])
    resumed = {}
    for tag, d in ((reader, tmp_path / "resume"), (writer, tmp_path / f"{writer}-1")):
        pkg, s = sched(tag, d)
        # the rest of the pass: it completes only from the saved cursor
        resumed[tag] = s.make_scrubber(clock=pkg.FakeClock()).run_once(
            max_units=len(want.cm.volumes) - 3)
    assert resumed[reader] == resumed[writer]
    assert resumed[reader]["completed_pass"]


# ---------------- the three doors ----------------

def _door_run(pkg, c, locs, door, value, monkeypatch):
    """One package's answer with ``door`` set to ``value``."""
    monkeypatch.setenv(door, value)
    if door == "CUBEFS_SCRUB":
        s = c.sched.make_scrubber(clock=pkg.FakeClock())
        return s.run_once(), c.sched.rpc_scrub_run({"full": True}, None)
    if door == "CUBEFS_QOS":  # a pinned brownout: shed unless the door is off
        pkg.qos.DEFAULT.force_level("blob.get", 1)
        try:
            s = c.sched.make_scrubber(clock=pkg.FakeClock())
            try:
                adm = pkg.qos.DEFAULT.admit("blob.get", priority=pkg.qos.SCRUB)
                adm.release()
                shed = type(adm).__name__
            except pkg.qos.QosRejected as e:
                shed = e.reason
            return pkg.qos.scrub_suppressed(), pkg.qos.repair_step_scale(), s.run_once(), shed
        finally:
            pkg.qos.DEFAULT.force_level("blob.get", None)
    # CUBEFS_VERIFY_READS: a data shard whose read refuses (409)
    plan = pkg.faultinject.FaultPlan(seed=5)
    pkg.faultinject.install(plan)
    sl = locs[0].slices[0]
    u = c.cm.get_volume(sl.vid).units[2]
    plan.plant_rot(u.node_addr, u.disk_id, f"c{u.chunk_id}:b{sl.min_bid}", kind="stale_crc")
    counts = [pkg.metrics.integrity_corruptions_detected.value(plane="blob", source="read"),
              pkg.metrics.integrity_corruptions_healed.value(plane="blob", source="read")]
    body = c.access.get(locs[0])
    counts = [pkg.metrics.integrity_corruptions_detected.value(plane="blob", source="read")
              - counts[0],
              pkg.metrics.integrity_corruptions_healed.value(plane="blob", source="read")
              - counts[1]]
    out = body, counts, plan.rot_remaining()
    pkg.faultinject.uninstall()
    return out


@pytest.mark.parametrize("value", ["0", "1"])
@pytest.mark.parametrize("door", DOORS)
def test_door_flipped_gives_the_reference_result(ref, ref_routing, ref_plans, tmp_path, rng,
                                                 monkeypatch, door, value):
    want, got, data, locs = _twins(ref, tmp_path, rng)
    a = _door_run(ref, want, [x for x, _ in locs], door, value, monkeypatch)
    b = _door_run(PORT, got, [y for _, y in locs], door, value, monkeypatch)
    assert b == a
    if door == "CUBEFS_SCRUB":
        assert (b[0].get("door") == "closed") == (value == "0")
    elif door == "CUBEFS_QOS":
        assert b[0] == (value == "1") and (b[2].get("suppressed") is True) == (value == "1")
        assert b[3] == ("_NoopAdmission" if value == "0" else "brownout")
    else:
        assert b[0] == data[0] and b[1][0] >= 1
        assert (b[1][1], b[2]) == ((1, 0) if value == "1" else (0, 1))


def test_scheduler_and_scrubber_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    cm = clustermgr.ClusterMgr()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scheduler.Scheduler(cm)
    s = scheduler.Scheduler(cm, device="cpu").make_scrubber(clock=FakeClock())
    assert isinstance(s, scrub.Scrubber) and s.run_full_pass()["scanned"] == 0
