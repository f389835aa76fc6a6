"""The port's bit-matrix GF(2^8) kernels C and D (``ops/gf_bitmajor.py``,
``csrc/gf_bitmajor.cu``) and the GF tuning sweep against the JAX package.

The reference kernels are the bodies of ``benchmarks/pallas_tuning.py``
(``_kernel_bitmajor``) and ``benchmarks/pallas_tuning2.py``
(``_mk_kernel``). Their jitted wrappers call ``pl.pallas_call`` with TPU
memory spaces and take no ``interpret`` flag, so the tests call the
bodies eagerly on the CPU: jnp arrays in, a numpy buffer as the output
ref. On the CPU the port runs its plain versions, which are what the
card holds the kernels against (``tests/test_torch_bitmajor_card.py`` and
``chip_smoke.py``). Tolerance: exact equality (integer math end to end).
"""

import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import pallas_tuning, pallas_tuning2
from cubefs_tpu.ops import bitlin as ref_bitlin
from cubefs_tpu.models import repair as ref_repair
from cubefs_tpu.ops import gf256 as ref_gf256
from cubefs_tpu_torch import convert
from cubefs_tpu_torch.models import repair
from cubefs_tpu_torch.ops import gf256, gf_bitmajor
from cubefs_tpu_torch.tuning import gf_tuning
from cubefs_tpu_torch.utils import benchtime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PLAN = repair.make_plan(12, 4, [1, 7])
COEFFS = {
    "rows_2x12": np.ascontiguousarray(_PLAN.rows, dtype=np.uint8),
    "step_rows_4x12": repair._step_rows(_PLAN),
    "parity_6p3": gf256.parity_matrix(6, 3),
    "random_5x9": np.random.default_rng(59).integers(0, 256, (5, 9), dtype=np.uint8),
    "random_36x36": np.random.default_rng(36).integers(0, 256, (36, 36), dtype=np.uint8),
}
# (name, C extraction or D mode, D probe, D flat form); None mode = C.
VARIANTS = [("C-int32", False, None, False), ("C-u8", True, None, False)] + [
    (f"D-{mode}-{probe or 'dot'}-{'flat' if flat else '2d'}", mode, probe, flat)
    for mode in ("loop", "bcast", "bool") for probe in (None, "nodot", "noext")
    for flat in (False, True)]


def _ref_wb(coeff):
    r, c = coeff.shape
    return jnp.asarray(ref_bitlin.w_to_bitmajor(ref_bitlin.gf_matrix_to_bits(coeff), r, c),
                       dtype=jnp.int8)


def _ref_body(coeff, x, mode, probe, flat):
    """One stripe (C, T) through the reference kernel body -> (R, T)."""
    wb, r = _ref_wb(coeff), coeff.shape[0]
    if isinstance(mode, bool):  # C: use_u8
        out = np.zeros((r, x.shape[1]), np.uint8)
        pallas_tuning._kernel_bitmajor(mode, wb, jnp.asarray(x), out)
        return out
    kern = pallas_tuning2._mk_kernel(mode, probe)
    if flat:
        out = np.zeros((1, r, x.shape[1]), np.uint8)
        kern(wb, jnp.asarray(x[None]), out)
        return out[0]
    out = np.zeros((r, x.shape[1]), np.uint8)
    kern(wb, jnp.asarray(x), out)
    return out


@pytest.mark.parametrize("name,mode,probe,flat", VARIANTS, ids=[v[0] for v in VARIANTS])
@pytest.mark.parametrize("case", sorted(COEFFS))
def test_variant_matches_reference_kernel_body(case, name, mode, probe, flat):
    coeff = COEFFS[case]
    r, c = coeff.shape
    s = 1536 if case == "random_36x36" else 256
    x = np.random.default_rng(r * 100 + c).integers(0, 256, (2, c, s), dtype=np.uint8)
    got = gf_bitmajor.plain(coeff, torch.from_numpy(x), probe).numpy()
    want = np.stack([_ref_body(coeff, xs, mode, probe, flat) for xs in x])
    assert got.shape == (2, r, s)
    assert np.array_equal(got, want)
    if probe is None:
        assert np.array_equal(got, np.stack([ref_gf256.gf_matmul(coeff, xs) for xs in x]))


def test_noext_casts_row_zero_with_wraparound():
    """The reference casts byte row 0 to int8 with wraparound (255 -> -1);
    the port's noext agrees on a row of 255s, and its output is not zero."""
    coeff = COEFFS["rows_2x12"]
    x = np.full((1, 12, 64), 255, np.uint8)
    got = gf_bitmajor.plain(coeff, torch.from_numpy(x), "noext").numpy()
    assert np.array_equal(got[0], _ref_body(coeff, x[0], "bcast", "noext", False))
    assert got.any()


def test_nodot_refuses_more_rows_than_shards():
    with pytest.raises(ValueError, match="r=5 > C=3"):
        gf_bitmajor.probe_nodot_plain(torch.zeros((3, 64), dtype=torch.uint8), 5)


@pytest.mark.parametrize("case", sorted(COEFFS))
def test_bitmajor_operand_decodes_to_reference_matrix(case):
    coeff = COEFFS[case]
    r, c = coeff.shape
    w = convert.bitmajor_operand(coeff)
    assert w.dtype == np.int8 and w.shape[0] % 16 == 0 and w.shape[1] % 32 == 0
    rpad, cpad = w.shape[0] // 8, w.shape[1] // 8
    # row 8r + k <- reference row k*R + r; column 32*(c//4) + 4k + c%4 <- k*C + c
    rows = [8 * i + k for k in range(8) for i in range(r)]
    cols = [32 * (j // 4) + 4 * k + j % 4 for k in range(8) for j in range(c)]
    ref = ref_bitlin.w_to_bitmajor(ref_bitlin.gf_matrix_to_bits(coeff), r, c)
    assert np.array_equal(w[np.ix_(rows, cols)], ref)
    assert int(np.abs(w).sum()) == int(np.abs(ref).sum())  # the padding is zero
    assert rpad == r + r % 2 and cpad == -(-c // 4) * 4


@pytest.mark.parametrize("kwargs,match", [
    ({"tile": 48}, "multiple of 32"),
    ({"tile": 0}, "multiple of 32"),
    ({"extract": "simd"}, "unknown extract"),
    ({"grid": "vmap"}, "unknown grid"),
])
def test_wrapper_refuses_bad_arguments(kwargs, match):
    x = torch.zeros((12, 64), dtype=torch.uint8)
    with pytest.raises(ValueError, match=match):
        gf_bitmajor.bitmajor_apply(COEFFS["rows_2x12"], x, **kwargs)


def test_wrapper_refuses_oversized_shared_memory_and_bad_probes():
    coeff = COEFFS["random_36x36"]
    x = torch.zeros((36, 64), dtype=torch.uint8)
    assert gf_bitmajor.smem_bytes(36, 36, 4096) > gf_bitmajor.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        gf_bitmajor.bitmajor_apply(coeff, x, tile=4096)
    with pytest.raises(ValueError, match="unknown probe"):
        gf_bitmajor.bitmajor_probe(coeff, x, probe="nomma")
    with pytest.raises(ValueError, match="R <= C"):
        gf_bitmajor.bitmajor_probe(COEFFS["random_5x9"].T.copy(),
                                   torch.zeros((5, 64), dtype=torch.uint8), probe="nodot")


def _reference_round2_cases():
    """The (name, mode, probe, flat) table of pallas_tuning2.main, read
    from its source."""
    with open(os.path.join(ROOT, "benchmarks", "pallas_tuning2.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "cases":
            return ast.literal_eval(node.value)
    raise AssertionError("no cases table in pallas_tuning2.py")


def test_tuning_variant_table_matches_reference():
    got2 = [(v.name, v.extract, v.probe, v.grid == "flat") for v in gf_tuning.ROUNDS[2]]
    assert got2 == [tuple(c) for c in _reference_round2_cases()]
    got1 = [(v.name, v.extract, v.grid) for v in gf_tuning.ROUNDS[1]]
    assert got1 == [("base", None, "stripe"), ("bitmajor", "int32", "stripe"),
                    ("bitmajor-u8", "u8", "stripe"), ("flatgrid", "u8", "flat")]
    assert np.array_equal(gf_tuning.coefficients(), ref_repair.make_plan(12, 4, bad=[1, 7]).rows)
    assert (gf_tuning.N, gf_tuning.M, gf_tuning.S, gf_tuning.BR) == (
        pallas_tuning2.N, pallas_tuning2.M, pallas_tuning2.S, pallas_tuning2.BR)


def test_tuning_tiles_are_for_this_card():
    assert not set(gf_tuning.TILES) & {8192, 16384, 32768, 65536, 131072}
    for tile in gf_tuning.TILES:
        assert tile % 32 == 0
        assert gf_bitmajor.smem_bytes(2, 12, tile) <= gf_bitmajor.MAX_SMEM_BYTES


@pytest.mark.parametrize("tile", [32, 256])
def test_verify_variant_runs_two_tiles_wide(tile):
    coeff = COEFFS["rows_2x12"]
    shapes = []

    def launch(x):
        shapes.append(tuple(x.shape))
        return gf_bitmajor.plain(coeff, x)

    assert gf_bitmajor.verify_variant(coeff, launch, tile, seed=3, device="cpu")
    assert shapes == [(2, 12, 2 * tile)]
    # a launch that gets the second tile wrong fails the gate
    def half_right(x):
        y = gf_bitmajor.plain(coeff, x)
        y[..., tile:] ^= 1
        return y

    assert not gf_bitmajor.verify_variant(coeff, half_right, tile, device="cpu")


def test_best_skips_probes_errors_and_wrong_outputs():
    coeff = gf_tuning.coefficients()
    surv = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 12, 512), dtype=np.uint8))
    fake_ms = {"bm-loop": 3.0, "bm-bcast": 2.0, "bm-bool": 4.0, "bm-flat": 5.0,
               "bm-nodot": 0.5, "bm-noext": 0.25}
    records = []
    for v in gf_tuning.ROUNDS[2]:
        def timer(fn, reps, _ms=fake_ms[v.name]):
            fn()
            return _ms
        records.append(gf_tuning.run_variant(
            v, lambda x, v=v: gf_bitmajor.plain(coeff, x, v.probe), coeff, surv, 64, timer=timer))
    # injected: a wrong output that would be the fastest, and a variant that raises
    wrong = gf_tuning.Variant("bm-wrong", "bcast")
    records.append(gf_tuning.run_variant(
        wrong, lambda x: torch.zeros((x.shape[0], 2, x.shape[2]), dtype=torch.uint8),
        coeff, surv, 64, timer=lambda fn, reps: 0.01))
    records.append(gf_tuning.run_variant(
        gf_tuning.Variant("bm-raise", "bcast"), lambda x: 1 / 0, coeff, surv, 64))
    assert records[-2] == {"v": "bm-wrong", "tile": 64, "error": "wrong output"}
    assert records[-1]["error"].startswith("ZeroDivisionError")
    assert all("gibs" in r for r in records[:-2])
    assert gf_tuning.best(records)["v"] == "bm-bcast"
    assert records[1]["gibs"] == pytest.approx(2 * 12 * 512 / 2e-3 / 2**30)
    assert gf_tuning.best(records[-2:]) is None


def test_sweep_and_timers_need_a_gpu():
    with pytest.raises(RuntimeError, match="CUDA"):
        gf_tuning.sweep(1, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the timers are valid here")
    with pytest.raises(RuntimeError):
        gf_tuning.sweep(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        benchtime.timed_ms(lambda: None, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        benchtime.timed_slope(lambda a: a, torch.zeros(1), 1, 2)


_GF = "void (anonymous namespace)::gf_apply_kernel<true>(unsigned char const*, ...)"
_FILL = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<long>, ...>"


@pytest.mark.parametrize("one,many,launched,whole", [
    ({_GF: (1, 0.1), _FILL: (2, 0.01)}, {_GF: (10, 1.0), _FILL: (20, 0.1)}, 1, True),
    ({_GF: (1, 0.1), _FILL: (2, 0.01)}, {_GF: (9, 0.9), _FILL: (20, 0.1)}, 1, False),
    ({_GF: (1, 0.1), _FILL: (2, 0.01)}, {_GF: (10, 1.0)}, 1, False),
    ({_FILL: (2, 0.01)}, {_FILL: (20, 0.1)}, 1, False),
    ({_GF: (1, 0.1)}, {_GF: (10, 1.0), _FILL: (20, 0.1)}, 1, False),
    ({_FILL: (2, 0.01)}, {_FILL: (20, 0.1)}, 0, True),
    ({}, {}, 0, True),
])
def test_profiler_trace_is_whole_only_with_every_record(one, many, launched, whole):
    """A trace of 10 runs is kept only if it holds 10 times the records
    of a trace of one run, name by name, and that one holds a record of
    each launch of the port's kernels."""
    assert benchtime.whole(one, many, 10, launched) is whole
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            benchtime.kernel_ms(lambda: None, 10)
