"""The deployed modes of the port's ``tool/bench_fs.py`` against the
reference's, on the CPU at a small size: each package's launcher
(``deploy/cluster.py``) starts a master, 2 metanodes and 3 datanodes as
processes, and the harness drives them from client processes.

- ``write_ab``: group commit off and on, each leg's in-process server
  capacity (``server_create_capacity``) and the deployed saturated create
  (``saturated_create``, 2 client processes), with every metanode's
  write-path view;
- ``deployed_ab``: the mdtest/fio run over the HTTP, packet and native
  meta planes, the stat saturation (``saturated_stat``, 2 client
  processes, 0.3 s windows) and ``native_loadgen`` (the C++ ``ms_bench``
  of each package's library, 2,000 round trips a connection).

The result's keys are the reference's (``tests/test_torch_bench_fs_ab.py``'s
``keys``). Tolerance: exact equality.
"""

import functools

import pytest

from cubefs_tpu_torch.tool import bench_fs
from test_torch_bench_fs_ab import both


@pytest.fixture(scope="module")
def ref():
    from cubefs_tpu.tool import bench_fs as ref_bench

    return ref_bench


def test_write_ab_keys(tmp_path, ref):
    port, want = both(ref, "write_ab", tmp_path, procs=2, threads=2, secs=0.3, cap_threads=8)
    for out in (port, want):
        for leg in ("baseline_per_op", "group_commit"):
            assert out[leg]["server_capacity"]["creates"] > 0
            assert out[leg]["deployed"]["create_ops"] > 0
            assert len(out[leg]["deployed"]["loadgen_cpu_s"]) == 2
            assert out[leg]["deployed"]["write_path"]


def test_deployed_ab_keys(tmp_path, ref, monkeypatch):
    for mod in (bench_fs, ref):  # shorter saturation windows and loadgen runs
        monkeypatch.setattr(mod, "saturated_stat", functools.partial(mod.saturated_stat,
                                                                      secs=0.3))
        monkeypatch.setattr(mod, "native_loadgen", functools.partial(mod.native_loadgen,
                                                                      iters=2000))
    port, want = both(ref, "deployed_ab", tmp_path, files=8, threads=2, procs=2)
    for out in (port, want):
        assert out["stat_saturation"]["packet_ops"] > 0
        assert out["stat_saturation"]["native_ops"] > 0
        assert out["native_loadgen"]["walk_stat_ops"] > 0
        assert out["meta_native"]["file_stat_ops"] > 0
