"""The port's fsck and file-system scrubber (``cubefs_tpu_torch/fs/fsck.py``,
``fs/scrub.py``) held against the reference's on the CPU.

- every scenario of the reference's ``tests/test_deferred_delete.py``,
  ``test_tools.py``'s ``test_fsck_clean_and_findings``, and every scenario
  of ``tests/test_integrity.py`` that ``tests/test_torch_scrub.py`` does
  not run (the file-system read-repair and scrubber scenarios, the
  inventory reconciliation, the WAL, CRC and disk-health corners and the
  seeded chaos drills) run on the port (``port_copy``; a blob scenario's
  cluster is the port's in-process cluster of ``tests/test_torch_blob.py``
  on ``device="cpu"``);
- one port cluster over sockets, with a client of each package: both
  packages' ``fsck`` give equal ``summary()`` clean, with one replica of
  an extent corrupted, after ``--heal`` and after an orphan extent is
  planted; both packages' ``FsScrubber`` heal a planted mismatch through
  the one healer and count it the same;
- ``tool/scrub_ab.py``'s legs on the port: a full scrub pass under the
  foreground read loop, and the ``CUBEFS_SCRUB`` door.

Tolerance: exact equality.
"""

import functools
import os

import numpy as np
import pytest

from cubefs_tpu_torch.blob import access, blobnode
from cubefs_tpu_torch.fs import fsck as port_fsck
from cubefs_tpu_torch.fs import scrub as port_scrub
from cubefs_tpu_torch.tool import scrub_ab
from cubefs_tpu_torch.utils.retry import FakeClock
from test_torch_blob import _isolated  # noqa: F401  (autouse fixture)
from test_torch_fs import (FS_E2E, PORT, WireFs, _close, _port_qos_still,  # noqa: F401
                           first_mkdir, ref)
from test_torch_raft import port_copy, run_scenario, scenarios
from test_torch_scrub import INTEGRITY_SCENARIOS, port_cluster

DEFERRED = port_copy("test_deferred_delete", FsCluster=FS_E2E.FsCluster)
TOOLS = port_copy("test_tools", FsCluster=FS_E2E.FsCluster)
INTEGRITY = port_copy(
    "test_integrity", Cluster=port_cluster, FsCluster=FS_E2E.FsCluster,
    AccessConfig=functools.partial(access.AccessConfig, device="cpu"),
    AccessHandler=access.AccessHandler,
    BlobNode=functools.partial(blobnode.BlobNode, device="cpu"))
FS_INTEGRITY = [n for n in scenarios(INTEGRITY) if n not in INTEGRITY_SCENARIOS]
cluster = DEFERRED.cluster  # the deferred-delete scenarios' fixture
_no_leftover_plan = INTEGRITY._no_leftover_plan  # the integrity scenarios' autouse fixture


@pytest.mark.parametrize("name", scenarios(DEFERRED))
def test_reference_deferred_delete_scenario_on_the_port(name, request):
    run_scenario(DEFERRED, name, request)


def test_reference_fsck_clean_and_findings_on_the_port(request):
    run_scenario(TOOLS, "test_fsck_clean_and_findings", request)


@pytest.mark.parametrize("name", FS_INTEGRITY)
def test_reference_integrity_scenario_on_the_port(name, request):
    run_scenario(INTEGRITY, name, request)


def test_every_integrity_scenario_runs_on_the_port():
    assert len(scenarios(DEFERRED)) == 7
    assert set(FS_INTEGRITY) | set(INTEGRITY_SCENARIOS) == set(scenarios(INTEGRITY))
    assert {"test_fs_scrubber_heals_and_fsck_dedups", "test_integrity_chaos_drill_reproducible",
            "test_integrity_drill_doors_off_fsm_identical"} <= set(FS_INTEGRITY)


# ---------------- the two packages' fsck on one cluster ----------------

def _corrupt_one_replica(c, fs, path: str) -> tuple[int, int]:
    ek = fs.meta.inode_get(fs.resolve(path))["extents"][0]
    dp = next(d for d in c.view["dps"] if d["dp_id"] == ek["dp_id"])
    victim = next(a for a in dp["replicas"] if a != dp["leader"])
    node = next(d for d in c.datas if d.addr == victim)
    node.partitions[dp["dp_id"]].store.write(ek["extent_id"], 0, b"\x00" * 10)
    return ek["dp_id"], ek["extent_id"]


def test_both_fscks_give_equal_summaries_on_one_cluster(ref, tmp_path):
    """A port cluster over sockets and a client of each package on it: the
    two fscks' summaries are equal on a clean volume, with one replica
    corrupted, after either heals it, and with an orphan extent."""
    from cubefs_tpu.fs import fsck as ref_fsck

    c = WireFs(PORT, tmp_path)
    fss = {"port": PORT.FileSystem(c.view, PORT.rpc.NodePool()),
           "ref": ref.FileSystem(c.view, ref.rpc.NodePool())}
    pools = {"port": PORT.rpc.NodePool(), "ref": ref.rpc.NodePool()}
    mods = {"port": port_fsck, "ref": ref_fsck}

    def summaries(**kw):
        got = {k: mods[k].fsck(fss[k], pools[k], **kw).summary() for k in mods}
        assert got["port"] == got["ref"], got
        return got["port"]

    try:
        rng = np.random.default_rng(18)
        first_mkdir(fss["port"], "/d")
        fss["port"].write_file("/d/a.bin", rng.integers(0, 256, 150_000, np.uint8).tobytes())
        fss["ref"].write_file("/d/b.bin", rng.integers(0, 256, 90_001, np.uint8).tobytes())
        fss["port"].write_file("/top.bin", b"hello fsck")
        clean = summaries()
        assert clean["clean"] and clean["files"] == 3 and clean["bytes"] > 0
        for healer in ("port", "ref"):
            key = _corrupt_one_replica(c, fss["port"], "/d/a.bin")
            bad = summaries()
            assert bad["replica_mismatches"] == 1 and not bad["clean"]
            rep = mods[healer].fsck(fss[healer], pools[healer], heal=True)
            assert rep.healed_extents == [key] and rep.replica_mismatches == []
            assert summaries() == clean
        dp = c.view["dps"][0]
        leader = next(d for d in c.datas if d.addr == dp["leader"])
        eid = leader.partitions[dp["dp_id"]].alloc_extent()
        leader.write(dp["dp_id"], eid, 0, b"orphan", chain=False)
        assert summaries()["orphan_extents"] == 1
    finally:
        for fs in fss.values():
            _close(fs)
        c.stop()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_either_scrubber_heals_a_port_cluster_through_the_one_healer(pkg, ref, tmp_path):
    """Each package's ``FsScrubber`` over a port cluster finds a planted
    mismatch in one full pass, heals it through ``sync_extent_from`` and
    leaves every replica's fingerprint equal; a second pass is clean."""
    from cubefs_tpu.fs import scrub as ref_scrub

    mods = {"port": (port_scrub, PORT), "ref": (ref_scrub, ref)}
    scrub_mod, p = mods[pkg]
    c = WireFs(PORT, tmp_path)
    fs = p.FileSystem(c.view, p.rpc.NodePool())
    try:
        first_mkdir(fs, "/s")
        fs.write_file("/s/a.bin", bytes(range(256)) * 400)
        fs.write_file("/s/b.bin", b"b" * 70_000)
        port_fs = PORT.FileSystem(c.view, PORT.rpc.NodePool())
        key = _corrupt_one_replica(c, port_fs, "/s/a.bin")
        _close(port_fs)
        s = scrub_mod.FsScrubber(fs, p.rpc.NodePool(), clock=FakeClock())
        out = s.run_full_pass()
        assert out["completed_pass"] and out["corrupt"] == 1 and out["scanned"] == 2
        assert s.healed == {key}
        dp = next(d for d in c.view["dps"] if d["dp_id"] == key[0])
        fps = {next(d for d in c.datas if d.addr == a).extent_fingerprint(*key)
               for a in dp["replicas"]}
        assert len(fps) == 1
        assert s.run_full_pass()["corrupt"] == 0
        assert fs.read_file("/s/a.bin") == bytes(range(256)) * 400
    finally:
        _close(fs)
        c.stop()


def test_fs_scrubber_cursor_file_resumes_in_the_other_package(ref, tmp_path):
    """The scrubber's persisted cursor (``fs_scrub_cursor.json``) written
    by the port's scrubber resumes the reference's at the same unit."""
    from cubefs_tpu.fs import scrub as ref_scrub

    c = FS_E2E.FsCluster(tmp_path)
    try:
        for i in range(5):
            c.fs.write_file(f"/c{i}", bytes([i]) * 5000)
        d = str(tmp_path / "cursor")
        s = port_scrub.FsScrubber(c.fs, c.pool, clock=FakeClock(), data_dir=d)
        first = s.run_once(max_units=2)
        r = ref_scrub.FsScrubber(c.fs, c.pool, clock=FakeClock(), data_dir=d)
        rest = r.run_once(max_units=3)  # the pass ends only if it resumed at unit 3
        assert first["scanned"] == 2 and not first["completed_pass"]
        assert rest["scanned"] == 3 and rest["completed_pass"]
    finally:
        c.stop()


# ---------------- tool/scrub_ab.py's legs ----------------

def test_scrub_ab_legs(tmp_path, monkeypatch):
    """A full pass lands under the foreground read loop, every extent
    clean; with ``CUBEFS_SCRUB=0`` the pass sheds the sweep."""
    monkeypatch.setattr(scrub_ab, "FILES", 4)
    monkeypatch.setattr(scrub_ab, "READS", 60)
    monkeypatch.setenv("CUBEFS_NATIVE_DATA", "0")
    b = scrub_ab.leg_concurrent_scrub(str(tmp_path), 14)
    assert b["reads"] == 60 and b["scrub_full_passes"] >= 1
    assert b["scrub_scanned"] >= 4 and b["scrub_corrupt"] == 0
    d = scrub_ab.leg_door(str(tmp_path), 14)
    assert d["door"] == "closed" and d["scanned"] == 0
    a = scrub_ab.leg_baseline(str(tmp_path), 14)
    assert a["reads"] == 60 and a["p99_ms"] > 0


def test_scrub_ab_writes_no_file_unless_asked(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    # main pins the Python read plane for its process (setdefault, as the
    # reference's does): set here, the switch is taken back after the test
    monkeypatch.setenv("CUBEFS_NATIVE_DATA", "0")
    monkeypatch.setattr(scrub_ab, "FILES", 2)
    monkeypatch.setattr(scrub_ab, "READS", 10)
    scrub_ab.main([])
    assert list(tmp_path.iterdir()) == []
    assert '"bench": "SCRUB_AB"' in capsys.readouterr().out



def test_the_scrub_ab_main_test_leaves_the_environment_as_it_found_it(tmp_path, capsys):
    """A ``CUBEFS_NATIVE_DATA=0`` left behind turns off the native read
    plane of every DataNode built later in the same test process, and
    ``WireFs`` (the S3 mixed tests' clusters) refuses a node without it."""
    before = os.environ.get("CUBEFS_NATIVE_DATA")
    with pytest.MonkeyPatch.context() as mp:
        test_scrub_ab_writes_no_file_unless_asked(tmp_path, mp, capsys)
    assert os.environ.get("CUBEFS_NATIVE_DATA") == before
