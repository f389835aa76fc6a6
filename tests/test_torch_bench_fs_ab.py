"""Each A/B mode of the port's ``tool/bench_fs.py`` against the reference's,
on the CPU at a small size: the result's keys are the reference's (an
address key, ``host:port``, stands as one key), and every identity field
holds in both packages. The digests of the fixed tapes that do not depend
on timing are held equal across the packages:

- ``wire_ab`` (ABBA mux door, saturated create over the wire): the FSM
  digest and the blob bytes identical across its legs, and equal to the
  reference's;
- ``scale_partitions`` with its ``fsm_identity_check``, ``obs_tail`` with
  its trace-door digests, ``read_ab`` (every read byte-checked in the
  tool), ``geo_ab`` (the geo-off tape's digest equal to the reference's,
  the lag leg drained and converged) and ``split_ab`` (the door-off leg
  bit-identical and equal to the reference's).

``write_ab`` and ``deployed_ab`` (deployed clusters) are
``tests/test_torch_bench_fs_deploy.py``. The speed verdicts of these legs (speedups, ``within_10pct``,
``scaling_past_plateau``) are timing, not identity, and are not held
here. Tolerance: exact equality.
"""

import functools
import re

import pytest

from cubefs_tpu_torch.tool import bench_fs

ADDR = re.compile(r"^[\w.-]+:\d+$")
# process-wide histograms whose stages depend on what else the process ran
VOLATILE = {"stage_tails"}


def _union(a, b):
    if isinstance(a, dict) and isinstance(b, dict):
        return {k: _union(a.get(k), b.get(k)) for k in {**a, **b}}
    return a if a is not None else b


def keys(obj):
    """The key structure of a result: nested dict keys, a list of dicts as
    its first item's structure, anything else as None. Keys of the form
    ``host:port`` (one per node) stand as one key ``ADDR`` holding the
    union of their structures: a node's view has a section only where its
    traffic reached it (a follower that pipelined no append has no
    ``pipeline``), in either package."""
    if isinstance(obj, dict):
        out: dict = {}
        for k, v in obj.items():
            if ADDR.match(str(k)):
                out["ADDR"] = _union(out.get("ADDR"), keys(v))
            else:
                out[k] = None if k in VOLATILE else keys(v)
        return out
    if isinstance(obj, list) and obj and isinstance(obj[0], dict):
        return [keys(obj[0])]
    return None


# A split leg's client whose table still names a partition the sweep
# merged away answers this until it re-reads its view, in both packages
# (ROADMAP.md, "Limits shared with the reference")
MERGED_AWAY = re.compile(r"RpcError: rpc 404: meta partition \d+ not on node \d+$")


@pytest.fixture(scope="module")
def ref():
    from cubefs_tpu.tool import bench_fs as ref_bench

    return ref_bench


def both(ref, fn: str, tmp_path, **kw):
    port = getattr(bench_fs, fn)(str(tmp_path / "port"), **kw)
    want = getattr(ref, fn)(str(tmp_path / "ref"), **kw)
    assert keys(port) == keys(want)
    return port, want


def test_wire_ab_keys_and_identity(tmp_path, ref):
    port, want = both(ref, "wire_ab", tmp_path, n_objects=1, n_meta_writes=40,
                      n_small_reads=16, sat_records=512)
    for out in (port, want):
        assert out["summary"]["fsm_digest_identical"] and out["summary"]["blob_bytes_identical"]
        assert [leg["mux"] for leg in out["legs"]] == [True, False, False, True]
    assert port["legs"][0]["fsm_digest"] == want["legs"][0]["fsm_digest"]
    assert port["legs"][0]["blob_sha"] == want["legs"][0]["blob_sha"]


def test_scale_partitions_keys_and_identity(tmp_path, ref, monkeypatch):
    for mod in (bench_fs, ref):  # its closing identity check, on a shorter tape
        monkeypatch.setattr(mod, "fsm_identity_check", functools.partial(
            mod.fsm_identity_check, n_parts=2, records_per_part=20))
    port, want = both(ref, "scale_partitions", tmp_path, parts=(2,), threads=4, secs=0.2,
                      rounds=1, fan_threads=2)
    assert port["fsm_identity"]["bit_identical"] and want["fsm_identity"]["bit_identical"]
    assert port["fsm_identity"]["digests"] == want["fsm_identity"]["digests"]


def test_obs_tail_keys_and_identity(tmp_path, ref):
    port, want = both(ref, "obs_tail", tmp_path, threads=4, secs=0.2, rounds=1, n_parts=2)
    assert port["fsm_digests"]["bit_identical"] and want["fsm_digests"]["bit_identical"]
    assert port["fsm_digests"]["trace_on"] == want["fsm_digests"]["trace_on"]


def test_read_ab_keys(tmp_path, ref):
    port, want = both(ref, "read_ab", tmp_path, files=4, file_kb=96, secs=0.2, rounds=1)
    for out in (port, want):
        assert out["byte_identical"] and out["door_off_is_plain_path"]


def test_geo_ab_keys_and_identity(tmp_path, ref):
    port, want = both(ref, "geo_ab", tmp_path, files=4, file_kb=96, secs=0.2, rounds=1,
                      load_secs=0.5)
    for out in (port, want):
        lag = out["steady_lag"]
        assert lag["drained"] and lag["digests_converged"] and lag["counters"]["gap"] == 0
        assert out["summary"]["geo_off_digest_identical"]
        assert out["follower_read"]["mutation_bounced_452"]
    assert port["geo_off_digest"] == want["geo_off_digest"]


def test_split_ab_keys_and_identity(tmp_path, ref):
    port, want = both(ref, "split_ab", tmp_path, threads=4, secs=0.3, rounds=1)
    for out in (port, want):
        assert out["summary"]["door_off_identical"] and out["identity"]["sweeps_inert"]
        errors = [e for legs in out["legs"].values() for leg in legs for e in leg["errors"]]
        assert all(MERGED_AWAY.search(e) for e in errors), errors
    assert port["identity"]["digests"] == want["identity"]["digests"]
