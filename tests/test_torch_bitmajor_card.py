"""The bit-matrix kernels C and D (``csrc/gf_bitmajor.cu``) on the card,
held against their plain PyTorch versions, and the CUDA-event timers.

Every test here needs a CUDA device (``cuda`` marker; the fixture skips
without one). The file imports no jax, so it also runs on a machine that
has only the port's dependencies:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_bitmajor_card.py

Tolerance: exact equality (integer math end to end).
"""

import numpy as np
import pytest
import torch

from cubefs_tpu_torch.models import repair
from cubefs_tpu_torch.ops import _build, gf256, gf_bitmajor
from cubefs_tpu_torch.utils import benchtime

_PLAN = repair.make_plan(12, 4, [1, 7])
COEFFS = {
    "rows_2x12": np.ascontiguousarray(_PLAN.rows, dtype=np.uint8),
    "step_rows_4x12": repair._step_rows(_PLAN),
    "parity_6p3": gf256.parity_matrix(6, 3),
    "random_5x9": np.random.default_rng(59).integers(0, 256, (5, 9), dtype=np.uint8),
    "random_36x36": np.random.default_rng(36).integers(0, 256, (36, 36), dtype=np.uint8),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# Ragged S (not a multiple of the tile, nor of 16): the reference grid
# s // tile leaves the tail unwritten, so its output is undefined there;
# the port masks the tail and is held against its own plain version only.
@pytest.mark.cuda
@pytest.mark.parametrize("grid", gf_bitmajor.GRIDS)
@pytest.mark.parametrize("extract", ["loop", "bcast", "bool"])
@pytest.mark.parametrize("case,s", [("rows_2x12", 4096), ("step_rows_4x12", 3000 + 7),
                                    ("parity_6p3", 2048 + 5), ("random_5x9", 1111),
                                    ("random_36x36", 1536)])
def test_bitmajor_kernel_matches_plain_on_card(cuda_device, case, s, extract, grid):
    coeff = COEFFS[case]
    x = torch.from_numpy(np.random.default_rng(s).integers(
        0, 256, (3, coeff.shape[1], s), dtype=np.uint8)).to(cuda_device)
    before = dict(_build.LAUNCHES)
    got = gf_bitmajor.bitmajor_apply(coeff, x, tile=256, extract=extract, grid=grid)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["gf_bitmajor"] == before["gf_bitmajor"] + (3 if grid == "stripe" else 1)
    assert torch.equal(got, gf_bitmajor.plain(coeff, x))


@pytest.mark.cuda
@pytest.mark.parametrize("grid", gf_bitmajor.GRIDS)
@pytest.mark.parametrize("probe,extract", [("nodot", "loop"), ("nodot", "bcast"),
                                           ("nodot", "bool"), ("noext", "bcast")])
@pytest.mark.parametrize("case,s", [("step_rows_4x12", 3000 + 7), ("random_36x36", 1536)])
def test_bitmajor_probe_matches_plain_on_card(cuda_device, case, s, probe, extract, grid):
    coeff = COEFFS[case]
    x = torch.from_numpy(np.random.default_rng(s).integers(
        0, 256, (2, coeff.shape[1], s), dtype=np.uint8)).to(cuda_device)
    before = _build.LAUNCHES["gf_bitmajor_probe"]
    got = gf_bitmajor.bitmajor_probe(coeff, x, tile=512, extract=extract, grid=grid, probe=probe)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["gf_bitmajor_probe"] > before
    assert torch.equal(got, gf_bitmajor.plain(coeff, x, probe))


# The persistent kernel's edges: (label, coeff, B, S, tile, stripe stride or
# None). The grid is at most the blocks the SMs hold (a few per SM), so
# 2 x 1001 tiles and 1500 stripes both leave blocks several items each;
# S % 16 != 0 and the odd stripe stride take the producer's own loads.
EDGES = [
    ("S_below_one_tile", "step_rows_4x12", 3, 300, 1024, None),
    ("more_tiles_than_blocks", "rows_2x12", 2, 256 * 1001, 256, None),
    ("more_tiles_than_blocks_ragged_123", "rows_2x12", 2, 256 * 1000 + 123, 256, None),
    ("B_larger_than_grid", "parity_6p3", 1500, 96, 64, None),
    ("stripe_stride_not_16", "step_rows_4x12", 3, 4096, 512, 12 * 4096 + 5),
    ("36x36_largest_tile", "random_36x36", 1, 3 * 1024 + 32, 1024, None),
]
COMBOS = [(None, e) for e in ("loop", "bcast", "bool")] + [
    ("nodot", e) for e in ("loop", "bcast", "bool")] + [("noext", "bcast")]


@pytest.mark.cuda
@pytest.mark.parametrize("grid", gf_bitmajor.GRIDS)
@pytest.mark.parametrize("probe,extract", COMBOS)
@pytest.mark.parametrize("label,case,b,s,tile,stride", EDGES, ids=[e[0] for e in EDGES])
def test_persistent_kernel_edges_on_card(cuda_device, label, case, b, s, tile, stride, probe,
                                         extract, grid):
    coeff = COEFFS[case]
    c = coeff.shape[1]
    rng = np.random.default_rng(s + b)
    if stride is None:
        x = torch.from_numpy(rng.integers(0, 256, (b, c, s), dtype=np.uint8)).to(cuda_device)
    else:  # stripes ``stride`` bytes apart in one buffer on the card
        buf = torch.from_numpy(rng.integers(0, 256, (b - 1) * stride + c * s,
                                            dtype=np.uint8)).to(cuda_device)
        x = buf.as_strided((b, c, s), (stride, s, 1))
        assert x.stride(0) % 16 == 5
    if label == "36x36_largest_tile":
        assert gf_bitmajor.smem_bytes(36, 36, 2 * tile) > gf_bitmajor.MAX_SMEM_BYTES
        assert gf_bitmajor.smem_bytes(36, 36, tile) <= gf_bitmajor.MAX_SMEM_BYTES
    kernel = "gf_bitmajor" if probe is None else "gf_bitmajor_probe"
    before = _build.LAUNCHES[kernel]
    if probe is None:
        got = gf_bitmajor.bitmajor_apply(coeff, x, tile=tile, extract=extract, grid=grid)
    else:
        got = gf_bitmajor.bitmajor_probe(coeff, x, tile=tile, extract=extract, grid=grid,
                                         probe=probe)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[kernel] == before + (b if grid == "stripe" else 1)
    assert torch.equal(got, gf_bitmajor.plain(coeff, x, probe))


@pytest.mark.cuda
def test_occupancy_query_on_card(cuda_device):
    for probe, extract in COMBOS:
        assert gf_bitmajor.blocks_per_sm(2, 12, 1024, extract, probe) >= 1
    assert gf_bitmajor.blocks_per_sm(36, 36, 1024) >= 1


@pytest.mark.cuda
def test_timers_on_card(cuda_device):
    x = torch.zeros(1 << 20, device=cuda_device)
    assert benchtime.timed_ms(lambda: x.add_(1), 3) > 0
    assert benchtime.timed_slope(lambda a: a + 1, x, 1, 5, repeats=2) > 0
