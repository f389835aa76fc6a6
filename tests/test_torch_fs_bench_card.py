"""Phase ``fs_bench`` of ``chip_smoke.py`` on the card's machine, at a small
size: the port's ``tool/bench_fs.py`` (the mdtest/fio run at 20 files and
2 MiB, the wire A/B, the split and geo A/Bs at half-second windows) and
``tool/aot_cuda.py`` (the three kernel sources compiled for ``sm_90a``),
each a process of its own, every check of the phase true.

The test needs the card's machine (``cuda`` marker; the fixture skips
without a CUDA device, and the build check needs nvcc). The file imports
no jax:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_fs_bench_card.py
"""

import os
import sys

import pytest

from test_torch_fs_card import cuda_device  # noqa: F401  (fixture)

SMALL = (
    ("mdtest_fio", "cubefs_tpu_torch.tool.bench_fs", ("--files", "20", "--io-mb", "2",
                                                      "--threads", "4")),
    ("wire_ab", "cubefs_tpu_torch.tool.bench_fs", ("--wire-ab",)),
    ("split_ab", "cubefs_tpu_torch.tool.bench_fs", ("--split-ab", "--secs", "0.5",
                                                    "--rounds", "1", "--threads", "4")),
    ("geo_ab", "cubefs_tpu_torch.tool.bench_fs", ("--geo-ab", "--secs", "0.5", "--rounds", "1")),
    ("aot_cuda", "cubefs_tpu_torch.tool.aot_cuda", ()),
)


@pytest.mark.cuda
def test_fs_bench_phase_at_a_small_size(cuda_device):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke

    rec = chip_smoke.fs_bench_phase("card", runs=SMALL, timeout=240.0)
    failed = [k for k, v in rec["checks"].items() if not v]
    assert not failed, (failed, {k: r.get("stderr_tail") for k, r in rec["runs"].items()})
    assert set(rec["runs"]) == {name for name, _, _ in SMALL}
