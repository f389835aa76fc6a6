"""The port's sharded codec step (``cubefs_tpu_torch/parallel``) on the
CPU: worlds of spawned ranks over gloo, each rank holding only its block.

Every rank's block of every result is held exactly against the JAX
reference's ``sharded_codec`` / ``sharded_repair_step`` on the 8-device
CPU mesh that testenv forces (run here, in the test process), against
the port's single-rank ``encode_parity`` / ``repair_step`` and against
zlib; CRCs as unsigned values. The ranks run ``cubefs_tpu_torch`` code
only (``tests/torch_parallel_ranks.py``, ``parallel/dryrun.py``): they
never import JAX.

One spawn runs every case of a world (a spawn costs seconds), and each
case is a parametrized test of its own. Every spawn has a deadline well
inside the suite's time limit, so a hang fails a test instead of the run.
"""

import functools
import re
import time
import zlib

import jax
import numpy as np
import pytest
import torch

import torch_parallel_ranks
from cubefs_tpu.models import repair as jrepair
from cubefs_tpu.parallel import mesh as jmesh
from cubefs_tpu.parallel import sharded_codec as jsharded
from cubefs_tpu_torch.models import repair as trepair
from cubefs_tpu_torch.ops import rs_kernel
from cubefs_tpu_torch.parallel import dryrun, launch
from cubefs_tpu_torch.parallel import mesh as tmesh
from cubefs_tpu_torch.parallel import sharded_codec as tsharded

N, M = 12, 4
DEADLINE = 45.0  # seconds a spawned world may take: well under the suite's limit
TIMEOUT = 30.0  # the process group's own waits


def _dims(dp, tp, sp):
    return {"dp": dp, "tp": tp, "sp": sp}


def _cases(dims: dict, s: int, crc_lens: list[int]) -> list[tuple[str, dict]]:
    """An encode, the CRCs at each length and the repair of two plans on one
    mesh. B = 8 stripes and rows divide by every dp here."""
    tag = "x".join(str(dims[a]) for a in tmesh.AXES)
    out = [(f"{tag}-encode-S{s}",
            {"dims": dims, "op": "encode", "seed": s, "b": 8, "n": N, "m": M, "s": s})]
    out += [(f"{tag}-crc-L{n}", {"dims": dims, "op": "crc", "seed": n, "rows": 8, "len": n})
            for n in crc_lens]
    out += [(f"{tag}-repair-bad{bad[0]}_{bad[1]}-S{s}",
             {"dims": dims, "op": "repair", "seed": 7 + bad[0], "b": 8, "n": N, "m": M, "s": s,
              "bad": bad}) for bad in ([2, 13], [1, 7])]
    return out


# Each mesh has a length whose S/sp is odd (B's and A's byte paths).
WORLD8 = (_cases(_dims(2, 2, 2), 1030, [4096, 1026, 300])
          + _cases(_dims(8, 1, 1), 1031, [4096, 1001, 300])
          + _cases(_dims(1, 2, 4), 1028, [4096, 1020, 300]))
WORLD4 = _cases(tmesh.factor_mesh(4), 1030, [4096, 1026])
# the rank body of chip_smoke.py's sharded phase at a small width, run in
# the 8-rank world after its cases: the mixed mesh and the dp-only fleet
MULTICHIP_RUNS = [
    {"name": "mixed", "dims": _dims(2, 2, 2), "seed": 1, "b": 4, "n": N, "m": M,
     "s": 2 * 1031, "bad": [1, 7]},
    {"name": "dp_only", "dims": _dims(8, 1, 1), "seed": 2, "b": 16, "n": N, "m": M,
     "s": 1000, "bad": [2, 13]},
]


def _spawn(world: int, cases, runs):
    return launch.launch(torch_parallel_ranks.outputs, world, backend="gloo", device="cpu",
                         args=([c for _, c in cases], runs), deadline=DEADLINE,
                         timeout=TIMEOUT)


@pytest.fixture(scope="module")
def world8():
    return _spawn(8, WORLD8, MULTICHIP_RUNS)


@pytest.fixture(scope="module")
def world4():
    return _spawn(4, WORLD4, [])


def _jax_mesh(dims: dict):
    world = dims["dp"] * dims["tp"] * dims["sp"]
    assert len(jax.devices()) >= 8, "testenv must force the 8-device CPU mesh"
    return jmesh.make_mesh(world, dims=dims)


@functools.lru_cache(maxsize=None)
def _reference(cases_id: str, i: int) -> dict:
    """Global results of case i: the JAX reference's sharded call on a mesh
    of the same dims, and the port's single-rank path (with zlib)."""
    case = dict((WORLD8 if cases_id == "8" else WORLD4)[i][1])
    mesh = _jax_mesh(case["dims"])
    x = np.asarray(torch_parallel_ranks.case_input(case, torch.device("cpu")))
    if case["op"] == "encode":
        jax_out = {"parity": jax.jit(jsharded.encode_sharded(mesh, N, M))(x)}
        single = {"parity": rs_kernel.encode_parity(torch.from_numpy(x), M)}
    elif case["op"] == "crc":
        jax_out = {"crcs": jax.jit(jsharded.crc32_sharded(mesh, case["len"], chunk_len=512))(x)}
        single = {"crcs": np.array([zlib.crc32(r.tobytes()) for r in x], dtype=np.int64)}
    else:
        jplan = jrepair.make_plan(N, M, case["bad"])
        rec, crcs = jrepair.sharded_repair_step(mesh, jplan, x)
        jax_out = {"recovered": rec, "crcs": crcs}
        plan = trepair.make_plan(N, M, case["bad"])
        st = dryrun.global_stripes(case["seed"], case["b"], N, M, case["s"], "cpu")
        rec1, crcs1, ok = trepair.repair_step(plan, st[:, list(plan.present)])
        assert bool(ok.all())
        assert torch.equal(rec1, st[:, list(plan.wanted)])  # the lost shards themselves
        zl = np.array([[zlib.crc32(r.tobytes()) for r in rows] for rows in rec1.numpy()])
        assert np.array_equal(crcs1.numpy(), zl)
        single = {"recovered": rec1, "crcs": crcs1}
    as_np = lambda d: {k: np.asarray(v).astype(np.int64) for k, v in d.items()}  # noqa: E731
    return {"dims": case["dims"], "jax": as_np(jax_out), "single": as_np(single)}


SPECS = {"parity": tmesh.ROWS, "recovered": tmesh.ROWS, "crcs": ("dp",)}


def _hold(world, cases_id: str, i: int, against: str) -> None:
    ref = _reference(cases_id, i)
    for rank, got in enumerate(world):
        local = got.result["cases"][i]
        assert local["coords"] == tmesh.coords(rank, ref["dims"])
        view = tmesh.Mesh(ref["dims"], rank, {}, torch.device("cpu"))  # its blocks, no group
        for key, want in ref[against].items():
            block = tmesh.local_block(view, want, SPECS[key]).numpy()
            assert local[key].shape == block.shape, (rank, key)
            assert np.array_equal(local[key].astype(np.int64), block), (rank, key)


@pytest.mark.parametrize("i", range(len(WORLD8)), ids=[name for name, _ in WORLD8])
def test_sharded_8_ranks_equal_jax_reference(world8, i):
    _hold(world8, "8", i, "jax")


@pytest.mark.parametrize("i", range(len(WORLD8)), ids=[name for name, _ in WORLD8])
def test_sharded_8_ranks_equal_single_rank_and_zlib(world8, i):
    _hold(world8, "8", i, "single")


@pytest.mark.parametrize("i", range(len(WORLD4)), ids=[name for name, _ in WORLD4])
def test_sharded_4_ranks_factor_mesh_equal_jax_reference(world4, i):
    assert WORLD4[i][1]["dims"] == _dims(1, 2, 2)
    _hold(world4, "4", i, "jax")


@pytest.mark.parametrize("i", range(len(WORLD4)), ids=[name for name, _ in WORLD4])
def test_sharded_4_ranks_factor_mesh_equal_single_rank_and_zlib(world4, i):
    _hold(world4, "4", i, "single")


def test_spawned_ranks_import_neither_jax_nor_the_jax_package(world8):
    for got in world8:
        assert not set(got.result["modules"]) & {"jax", "jaxlib", "cubefs_tpu"}
        assert got.launches == {k: 0 for k in got.launches}  # the CPU path launches nothing


def test_multichip_dryrun_holds_on_8_cpu_ranks(world8):
    """The rank body of chip_smoke.py's sharded phase, at a small width:
    the mixed mesh and the dp-only fleet from one world."""
    for rank, got in enumerate(world8):
        assert len(got.result["multichip"]) == len(MULTICHIP_RUNS)
        for run, summary in zip(MULTICHIP_RUNS, got.result["multichip"]):
            assert summary["checks"] and all(summary["checks"].values()), summary
            assert summary["coords"] == tmesh.coords(rank, run["dims"])


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16])
def test_factor_mesh_matches_reference(n):
    assert tmesh.factor_mesh(n) == jmesh.factor_mesh(n)


@pytest.mark.parametrize("dims", [(2, 2, 2), (8, 1, 1), (1, 2, 4), (1, 2, 2)])
def test_rank_coords_match_the_reference_device_layout(dims):
    """Rank r sits where the reference's mesh puts device r."""
    jm = _jax_mesh(_dims(*dims))
    for idx, dev in np.ndenumerate(jm.devices):
        assert tmesh.coords(dev.id, _dims(*dims)) == dict(zip(tmesh.AXES, idx))
    for axis in tmesh.AXES:
        groups = tmesh.axis_groups(_dims(*dims), axis)
        assert sorted(r for g in groups for r in g) == list(range(int(np.prod(dims))))
        for g in groups:
            assert [tmesh.coords(r, _dims(*dims))[axis] for r in g] == list(range(len(g)))


@pytest.fixture
def no_collective(monkeypatch):
    """A (2, 2, 2) mesh view with no process group behind it; reaching a
    collective fails the test."""
    def refuse(*args, **kwargs):
        raise AssertionError("a collective was reached before the shape check")

    monkeypatch.setattr(torch.distributed, "all_gather", refuse)
    return tmesh.Mesh(_dims(2, 2, 2), 0, {a: object() for a in tmesh.AXES},
                      torch.device("cpu"))


def _indivisible(mesh):
    z = np.zeros
    plan = trepair.make_plan(N, M, [1, 7])
    return {
        "stripes_over_dp": lambda: tmesh.local_block(mesh, z((3, 12, 8), np.uint8)),
        "shards_over_tp": lambda: tmesh.local_block(mesh, z((4, 5, 8), np.uint8)),
        "bytes_over_sp": lambda: tmesh.local_block(mesh, z((4, 12, 9), np.uint8)),
        "apply_n_in_over_tp": lambda: tsharded.gf_matrix_apply_sharded(
            mesh, z((2, 5), np.uint8), 5),
        "apply_block_shape": lambda: tsharded.encode_sharded(mesh, N, M)(
            torch.zeros((2, 5, 8), dtype=torch.uint8)),
        "crc_segment_over_sp": lambda: tsharded.crc32_sharded(mesh, 301),
        "crc_block_length": lambda: tsharded.crc32_sharded(mesh, 300)(
            torch.zeros((2, 149), dtype=torch.uint8)),
        "repair_extra_survivors": lambda: trepair.sharded_repair_step(
            mesh, plan, torch.zeros((2, 7, 8), dtype=torch.uint8)),
    }


@pytest.mark.parametrize("what", list(_indivisible(None)))
def test_indivisible_shapes_raise_before_any_collective(no_collective, what):
    with pytest.raises(ValueError):
        _indivisible(no_collective)[what]()


def test_launch_refuses_bad_arguments():
    with pytest.raises(ValueError, match="backend"):
        launch.launch(torch_parallel_ranks.sleep, 2, backend="mpi", device="cpu", args=(0,))
    with pytest.raises(ValueError, match="world"):
        launch.launch(torch_parallel_ranks.sleep, 0, backend="gloo", device="cpu", args=(0,))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            launch.launch(torch_parallel_ranks.sleep, 2, backend="gloo", args=(0,))


@pytest.mark.parametrize("fn, cause", [
    (torch_parallel_ranks.raise_on_rank, "rank 1 of 3 failed:\n.*fails on purpose"),
    (torch_parallel_ranks.exit_on_rank, re.escape("rank 1 of 3 died (exit code 3)")),
], ids=["raises", "dies"])
def test_a_failing_rank_fails_the_launch_within_its_deadline(fn, cause):
    """The other ranks wait on for minutes and the process group's own
    timeout is far away, so only the launch's watch on its ranks ends
    the run in time, and it names the cause."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        launch.launch(fn, 3, backend="gloo", device="cpu", args=(1,), deadline=DEADLINE,
                      timeout=600.0)
    assert time.monotonic() - t0 < DEADLINE
    assert re.search(cause, str(err.value), re.DOTALL), str(err.value)


def test_a_hung_world_fails_at_its_deadline():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not return within"):
        launch.launch(torch_parallel_ranks.sleep, 2, backend="gloo", device="cpu",
                      args=(600.0,), deadline=5.0)
    assert time.monotonic() - t0 < 5.0 + 10.0
