"""Rank bodies that drive the sharded codec step: the port's twin of the
reference's ``__graft_entry__.dryrun_multichip`` and ``dryrun_dp_only``.

Each function runs on every rank of a world that ``parallel/launch.py``
started (``launch(fn, world, backend=..., device=..., args=...)``), so it
lives in the port: a spawned rank imports only ``cubefs_tpu_torch``.
Every rank makes the same global stripes from a seed with numpy and
takes its own block of them, so nothing is scattered.

``multichip`` runs whole repair steps on meshes of the caller's choice
(the mixed (2, 2, 2) mesh and the dp-only (8, 1, 1) fleet on 8 ranks)
and holds every block of every result, exactly, against the single-rank
``encode_parity`` and ``repair_step`` on the same device, against the
lost shards themselves and against ``zlib``; on CUDA it also times the
step. The global parity is made by the plain PyTorch GF apply
(``rs_kernel.gf_apply_bits``), never by kernel A, so the checks hold A's
results against an independent computation; each rank also holds its
own partial applies (its coefficient columns on its block) against the
plain version on the same block.
"""

from __future__ import annotations

import statistics
import zlib

import numpy as np
import torch
import torch.distributed as dist

from ..models import repair
from ..ops import _build, gf256, rs_kernel
from . import mesh as meshlib
from . import sharded_codec

# the __global__ functions of kernels A and B, as the profiler names them
KERNEL_SYMBOLS = {"gf_apply": "gf_apply_kernel", "crc32_blocks": "crc32_span_kernel"}


def random_bytes(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def global_stripes(seed: int, b: int, n: int, m: int, s: int, device) -> torch.Tensor:
    """(b, n+m, s) uint8 stripes on ``device``: the data from the seed, the
    parity from the plain PyTorch GF apply (not kernel A)."""
    data = torch.from_numpy(random_bytes(seed, (b, n, s))).to(device)
    return torch.cat([data, plain_apply(gf256.parity_matrix(n, m), data)], dim=1)


def plain_apply(coeff: np.ndarray, shards: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of ``rs_kernel.gf_matrix_apply`` on any
    device: what kernel A is held against."""
    return rs_kernel.gf_apply_bits(torch.from_numpy(rs_kernel.coeff_bits(coeff)), shards)


def _zlib_rows(blocks: torch.Tensor) -> torch.Tensor:
    host = blocks.cpu().numpy()
    return torch.tensor([[zlib.crc32(r.tobytes()) for r in rows] for rows in host],
                        dtype=torch.int64)


def _timed_ms(fn, reps: int) -> float:
    """Median over ``reps`` of ``fn()`` between two CUDA events, each run
    started together on every rank (a barrier, then a synchronize)."""
    times = []
    for _ in range(reps):
        dist.barrier()
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _kernel_ms(fn, reps: int, traced: bool) -> dict[str, float]:
    """Device milliseconds per run of ``fn()`` in kernels A and B, from the
    profiler's CUDA trace, where ``traced``; the other ranks run ``fn``
    as often, untraced, so the collectives still meet."""
    if not traced:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return {}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(KERNEL_SYMBOLS, 0.0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for name, symbol in KERNEL_SYMBOLS.items():
                if symbol in e.name:
                    out[name] += e.time_range.elapsed_us() / 1e3 / reps
    return out


def multichip(device: torch.device, runs: list[dict], reps: int = 0) -> list[dict]:
    """Sharded encode + repair + CRC on each run's mesh, every block held
    exactly against the plain version, the single-rank path, the lost
    shards and zlib; one summary dict per run.

    A run: {"name", "dims", "seed", "b", "n", "m", "s", "bad"}. The
    launch counts cover the sharded calls alone (set to 0 just before,
    read just after). With ``reps`` > 0 on CUDA, also the medians of the
    step, of the encode and of the step's collectives alone (the same
    all-gathers on tensors of the same sizes), and on rank 0 A's and B's
    device time per step."""
    summaries = []
    for run in runs:
        mesh = meshlib.make_mesh(run["dims"], device)
        n, m, s = run["n"], run["m"], run["s"]
        plan = repair.make_plan(n, m, run["bad"])
        st = global_stripes(run["seed"], run["b"], n, m, s, device)
        rec_ref, crc_ref, ok_ref = repair.repair_step(plan, st[:, list(plan.present)])
        data = meshlib.local_block(mesh, st[:, :n])
        surviving = meshlib.local_block(mesh, st[:, list(plan.present[:n])])
        encode = sharded_codec.encode_sharded(mesh, n, m)
        local_s = s // mesh.dims["sp"]
        parity_crc = sharded_codec.crc32_sharded(mesh, s)

        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dist.barrier()
        _build.reset_launches()
        parity = encode(data)
        recovered, crcs = repair.sharded_repair_step(mesh, plan, surviving)
        parity_crcs = parity_crc(parity.reshape(-1, local_s)).reshape(parity.shape[:2])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        launches = dict(_build.LAUNCHES)

        lost = meshlib.local_block(mesh, st[:, list(plan.wanted)], ("dp",))
        full_parity = meshlib.local_block(mesh, st[:, n:], ("dp",))
        single_parity = rs_kernel.encode_parity(st[:, :n], m)
        checks = {
            "partials_equal_plain": all(
                torch.equal(rs_kernel.gf_matrix_apply(cols, block), plain_apply(cols, block))
                for cols, block in (
                    (sharded_codec.local_columns(mesh, gf256.parity_matrix(n, m), n), data),
                    (sharded_codec.local_columns(mesh, plan.rows, n), surviving))),
            "encode_equals_plain": torch.equal(
                parity, meshlib.local_block(mesh, st[:, n:], meshlib.ROWS)),
            "encode_equals_single": torch.equal(
                parity, meshlib.local_block(mesh, single_parity, meshlib.ROWS)),
            "recovered_equals_single": torch.equal(
                recovered, meshlib.local_block(mesh, rec_ref, meshlib.ROWS)),
            "recovered_equals_lost": torch.equal(
                recovered, meshlib.local_block(mesh, lost, (None, None, "sp"))),
            "crcs_equal_single": torch.equal(crcs, meshlib.local_block(mesh, crc_ref, ("dp",))),
            "crcs_equal_zlib": torch.equal(crcs.cpu(), _zlib_rows(lost)),
            "parity_crcs_equal_zlib": torch.equal(parity_crcs.cpu(), _zlib_rows(full_parity)),
            "single_step_ok": bool(ok_ref.all()),
            "gathered_equals_single": torch.equal(meshlib.gather_rows(mesh, recovered), rec_ref),
        }
        summary = {"name": run["name"], "dims": mesh.dims, "rank": mesh.rank,
                   "coords": mesh.coords, "block": list(surviving.shape), "checks": checks,
                   "launches": launches}
        if reps and device.type == "cuda":
            def step():
                return repair.sharded_repair_step(mesh, plan, surviving)

            tp_part = torch.empty_like(recovered)
            crc_part = torch.empty(recovered.shape[0] * recovered.shape[1], dtype=torch.int64,
                                   device=device)

            def collectives():
                for axis, t in (("tp", tp_part), ("sp", crc_part)):
                    if mesh.groups[axis] is not None:
                        dist.all_gather([torch.empty_like(t) for _ in range(mesh.dims[axis])],
                                        t, group=mesh.groups[axis])

            summary["step_ms"] = _timed_ms(step, reps)
            summary["encode_ms"] = _timed_ms(lambda: encode(data), reps)
            summary["collective_ms"] = _timed_ms(collectives, reps)
            summary["kernel_ms"] = _kernel_ms(step, reps, traced=mesh.rank == 0)
        summaries.append(summary)
        del st, rec_ref, crc_ref, single_parity, data, surviving, parity, recovered
        del lost, full_parity
    return summaries
