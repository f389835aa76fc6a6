"""Concurrent-submitter A/B benchmark for the batched codec admission
layer (codec/batcher.py).

Synthetic PUT/repair submitters — each the shape of one access-PUT
encode or one worker repair matrix_apply — hammer the admission surface
concurrently. Leg A coalesces (CUBEFS_CODEC_BATCH on), leg B is the
unbatched control (every submission its own device dispatch). Reports
aggregate encode throughput, latency percentiles, mean stripes per
drained device step, and asserts the batched outputs are bit-identical
to the unbatched golden.

Run: `python -m cubefs_tpu_torch.tool.bench_codec [--out FILE]` (knobs
below; the defaults are the acceptance shape: 32 submitters, stripes per
step >= 8, batched/unbatched >= 3x).

The port's copy of ``cubefs_tpu/tool/bench_codec.py``. It runs in this
process on ``--device`` (``cuda`` by default; ``cpu`` is the only way off
the card) through engine ``cuda`` (the default of ``--engine``), so that
kernel A, not the crossover table, serves the batched legs: stripes are
uint8 tensors on the device. Any other ``--engine`` (the reference's host
names, or ``auto``) takes host stripes, as the batcher does. On the card
each submitter waits for its result on its stream before it counts the
submission done, and each leg's wall ends after the device is idle.
``run_fallback_ab``'s drill declares the card and the native legs lost
(``CUBEFS_CODEC_DEAD=cuda,cpp,cpp-xor``) under a request for ``cpp``, the
port's names for the reference's device and native legs.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time

import numpy as np
import torch

from .. import device as devlib
from ..codec.batcher import BatchCodec
from ..ops import msr, rs_kernel
from ..utils import metrics
from .bench_fs import merge_artifact  # the shared record's writer, with the FS bench


def _pct(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p / 100 * len(xs)))] if xs else 0.0


def _place(x: np.ndarray, engine: str, dev: torch.device):
    """Stripes as the engine takes them: a tensor on ``dev`` for ``cuda``,
    the host array for every other engine."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev) if engine == "cuda" else x


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _settle(engine: str, dev: torch.device) -> None:
    """Wait for the card's queued work (a no-op for host stripes)."""
    if engine == "cuda" and dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def _run_leg(batched: bool, submitters: int, iters: int, n: int, m: int,
             shard_size: int, engine: str, seed: int,
             wait_ms: float, depth: int, device="cuda") -> dict:
    """One leg: `submitters` threads, each submitting `iters` stripes
    (even threads PUT-shaped encodes, odd threads repair-shaped
    matrix_applys) through a private BatchCodec. Each keeps `depth`
    submissions in flight (submit_*_async then collect) — the async
    admission pattern a pipelined PUT/repair caller uses."""
    dev = devlib.resolve(device)
    codec = BatchCodec(enabled=batched, max_wait_ms=wait_ms)
    rng = np.random.default_rng(seed)
    total = n + m
    # repair shape: unit 0 lost, decode row over the next n survivors
    rows = rs_kernel.reconstruct_rows(n, total, list(range(1, n + 1)), [0])
    stripes = [_place(rng.integers(0, 256, (1, n, shard_size), dtype=np.uint8), engine, dev)
               for _ in range(8)]
    # warm up outside the timed window: first-use costs (engine lib
    # load, crossover table read, the kernel's library) must not land in
    # either leg's wall
    codec.submit_encode(dev, stripes[0], m, engine=engine)
    codec.submit_apply(dev, rows, stripes[0], engine=engine)
    _settle(engine, dev)
    lat: list[float] = []
    lat_mu = threading.Lock()
    outs: dict[int, np.ndarray] = {}
    errs: list[BaseException] = []
    start = threading.Barrier(submitters + 1)

    def submitter(tid: int):
        my_lat = []
        my_out = None
        data = stripes[tid % len(stripes)]
        inflight: list = []

        def submit():
            t0 = time.perf_counter()
            if tid % 2 == 0:  # PUT-shaped: encode parity
                fut = codec.submit_encode_async(dev, data, m, engine=engine)
            else:  # repair-shaped: decode the lost unit
                fut = codec.submit_apply_async(dev, rows, data, engine=engine)
            inflight.append((t0, fut))

        def collect(t0, fut):
            out = fut.result()
            _settle(engine, dev)
            my_lat.append(time.perf_counter() - t0)
            return out

        try:
            start.wait()
            for _ in range(iters):
                if len(inflight) >= depth:
                    t0, fut = inflight.pop(0)
                    my_out = collect(t0, fut)
                submit()
            for t0, fut in inflight:
                my_out = collect(t0, fut)
        except BaseException as e:  # pragma: no cover - bench guard
            errs.append(e)
        with lat_mu:
            lat.extend(my_lat)
            outs[tid] = None if my_out is None else _host(my_out)

    threads = [threading.Thread(target=submitter, args=(i,))
               for i in range(submitters)]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    _settle(engine, dev)
    wall = time.perf_counter() - t0
    if errs:
        raise errs[0]
    n_stripes = submitters * iters
    data_bytes = n_stripes * n * shard_size
    return {
        "batched": batched,
        "wall_s": round(wall, 3),
        "stripes": n_stripes,
        "throughput_gibs": round(data_bytes / wall / 2**30, 4),
        "submit_p50_ms": round(_pct(lat, 50) * 1e3, 3),
        "submit_p99_ms": round(_pct(lat, 99) * 1e3, 3),
        "outputs": outs,  # stripped before serialization
    }


def _occupancy_totals() -> tuple[float, int]:
    """(sum, count) across all label series of the stripes-per-step
    histogram — metrics are the bench's only occupancy bookkeeping."""
    s = c = 0
    for _, row in metrics.codec_batch_stripes.samples():
        s += row["sum"]
        c += row["count"]
    return s, c


def _median(xs):
    xs = sorted(xs)
    mid = len(xs) // 2
    return xs[mid] if len(xs) % 2 else (xs[mid - 1] + xs[mid]) / 2


def run_ab(submitters: int = 32, iters: int = 200, n: int = 6, m: int = 3,
           shard_size: int = 2048, engine: str = "cuda",
           seed: int = 0xBA7C4, wait_ms: float = 0.25,
           depth: int = 4, rounds: int = 3, device="cuda") -> dict:
    """Alternating batched/unbatched rounds; per-leg medians (the host
    is a shared core — single runs swing 2x), bit-identity cross-check,
    and step occupancy from the metrics registry."""
    b_rounds, u_rounds = [], []
    b_out = u_out = None
    steps = coalesced = 0
    for _ in range(rounds):
        sum0, cnt0 = _occupancy_totals()
        b = _run_leg(True, submitters, iters, n, m, shard_size,
                     engine, seed, wait_ms, depth, device)
        sum1, cnt1 = _occupancy_totals()
        u = _run_leg(False, submitters, iters, n, m, shard_size,
                     engine, seed, wait_ms, depth, device)
        steps += cnt1 - cnt0
        coalesced += sum1 - sum0
        b_out, u_out = b.pop("outputs"), u.pop("outputs")
        b_rounds.append(b)
        u_rounds.append(u)

    # bit-identity: same tid => same input; outputs must match exactly
    bit_identical = all(np.array_equal(b_out[tid], u_out[tid])
                        for tid in b_out)
    # and each against the host's table golden of the same stripe
    golden = _leg_golden(submitters, n, m, shard_size, seed)
    equals_plain = all(np.array_equal(b_out[tid], golden[tid]) for tid in b_out)
    med_b = _median([r["throughput_gibs"] for r in b_rounds])
    med_u = _median([r["throughput_gibs"] for r in u_rounds])
    out = {
        "submitters": submitters,
        "iters_per_submitter": iters,
        "rounds": rounds,
        "rs": f"{n}+{m}",
        "shard_size": shard_size,
        "engine": engine,
        "device": str(devlib.resolve(device)),
        "max_wait_ms": wait_ms,
        "pipeline_depth": depth,
        "batched": {"median_throughput_gibs": med_b, "rounds": b_rounds},
        "unbatched": {"median_throughput_gibs": med_u, "rounds": u_rounds},
        "speedup": round(med_b / med_u, 2) if med_u else None,
        "device_steps": steps,
        "mean_stripes_per_device_step":
            round(coalesced / steps, 2) if steps else None,
        "bit_identical": bit_identical,
        "equals_plain": equals_plain,
    }
    return out


def _leg_golden(submitters: int, n: int, m: int, shard_size: int,
                seed: int) -> dict[int, np.ndarray]:
    """What each submitter of a leg must get back, from the GF(2^8)
    tables on the host (``gf256.gf_matmul``), independent of every
    engine."""
    from ..ops import gf256

    rng = np.random.default_rng(seed)
    stripes = [rng.integers(0, 256, (1, n, shard_size), dtype=np.uint8) for _ in range(8)]
    rows = rs_kernel.reconstruct_rows(n, n + m, list(range(1, n + 1)), [0])
    enc = gf256.parity_matrix(n, m)
    return {tid: gf256.gf_matmul(enc if tid % 2 == 0 else rows, stripes[tid % 8][0])[None]
            for tid in range(submitters)}


def _az_layout(k: int, m: int, az_count: int) -> list[int]:
    """Unit index -> AZ id under the contiguous data/parity split the
    placement layer uses (ec_layout_by_az): each AZ hosts an equal
    contiguous slice of the data shards and of the parity shards."""
    az_of = [0] * (k + m)
    per_d, per_p = k // az_count, m // az_count
    for i in range(k):
        az_of[i] = min(i // per_d, az_count - 1)
    for i in range(m):
        az_of[k + i] = min(i // per_p, az_count - 1)
    return az_of


def _helper_order(az_of: list[int], failed: int) -> list[int]:
    """AZ-local-first survivor preference (topology.pick_repair_helpers
    shape): the failed unit's AZ peers first, then remote AZs round-robin."""
    local = [i for i in range(len(az_of))
             if i != failed and az_of[i] == az_of[failed]]
    remote: dict[int, list[int]] = {}
    for i in range(len(az_of)):
        if i != failed and az_of[i] != az_of[failed]:
            remote.setdefault(az_of[i], []).append(i)
    order = list(local)
    queues = [remote[a] for a in sorted(remote)]
    while any(queues):
        for q in queues:
            if q:
                order.append(q.pop(0))
    return order


def run_repair_ab(stripes: int = 96, k: int = 6, m: int = 6, d: int = 11,
                  az_count: int = 3, shard_size: int = 12288,
                  engine: str = "cuda", seed: int = 0x4353, failed: int = 0,
                  wait_ms: float = 0.25, rounds: int = 3, device="cuda") -> dict:
    """Single-shard repair A/B: the MSR sub-shard path (leg A) pulls one
    beta = S/alpha helper symbol from each of d survivors; the
    conventional control (leg B) pulls k full shards. Both rebuild the
    same lost shard from the same encoded stripes; the record reports
    bytes-pulled (split az_local / cross_az by the placement layout),
    the reduction factor, repair throughput, bit-identity of the two
    reconstructions against the original, and the admission-layer
    stripes-per-step occupancy that proves MSR repair math rides the
    batched codec like any other stripe work."""
    dev = devlib.resolve(device)
    total = k + m
    alpha = d - k + 1
    if shard_size % alpha:
        raise SystemExit(f"--shard-size {shard_size} must be divisible by "
                         f"alpha={alpha}")
    beta = shard_size // alpha
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (stripes, k, shard_size), dtype=np.uint8)
    tdata = torch.from_numpy(data).to(dev if engine == "cuda" else "cpu")
    parity = rs_kernel.msr_encode_parity(tdata, k, total, d)
    shards_t = torch.cat([tdata, parity], dim=1)
    shards = shards_t.cpu().numpy()
    subs = _place(shards, engine, dev).reshape(stripes, total, alpha, beta)
    cat, stack = ((torch.cat, torch.stack) if engine == "cuda"
                  else (np.concatenate, np.stack))

    az_of = _az_layout(k, m, az_count)
    order = _helper_order(az_of, failed)
    helpers = tuple(order[:d])
    conv_set = tuple(sorted(order[:k]))
    helper_row = msr.helper_rows(k, total, d, failed)
    repair_rows = msr.repair_rows(k, total, d, failed, helpers)
    recon_rows = msr.reconstruct_rows(k, total, d, conv_set, (failed,))

    codec = BatchCodec(enabled=True, max_wait_ms=wait_ms)
    codec.submit_apply(dev, helper_row, subs[0, 1][None], engine=engine)  # warm-up

    def msr_leg() -> tuple[np.ndarray, float]:
        t0 = time.perf_counter()
        # helper-side combination: ONE beta-symbol per (stripe, helper),
        # every submission shares the same phi_f row -> they coalesce
        futs = [[codec.submit_apply_async(dev, helper_row, subs[s, h][None], engine=engine)
                 for h in helpers] for s in range(stripes)]
        syms = stack([cat([f.result()[0] for f in row]) for row in futs])
        # replacement-side solve: shared repair matrix across stripes
        futs2 = [codec.submit_apply_async(dev, repair_rows, syms[s][None], engine=engine)
                 for s in range(stripes)]
        out = stack([f.result().reshape(shard_size) for f in futs2])
        _settle(engine, dev)
        return _host(out), time.perf_counter() - t0

    def conv_leg() -> tuple[np.ndarray, float]:
        t0 = time.perf_counter()
        futs = [codec.submit_apply_async(
                    dev, recon_rows,
                    subs[s, list(conv_set)].reshape(1, k * alpha, beta), engine=engine)
                for s in range(stripes)]
        out = stack([f.result().reshape(shard_size) for f in futs])
        _settle(engine, dev)
        return _host(out), time.perf_counter() - t0

    m_walls, c_walls = [], []
    m_occ = None
    for _ in range(rounds):
        s0, c0 = _occupancy_totals()
        m_out, mw = msr_leg()
        s1, c1 = _occupancy_totals()
        c_out, cw = conv_leg()
        m_walls.append(mw)
        c_walls.append(cw)
        m_occ = (s1 - s0, c1 - c0)
    bit_identical = (np.array_equal(m_out, shards[:, failed])
                     and np.array_equal(c_out, shards[:, failed]))

    # traffic accounting is arithmetic over the placement layout: the
    # MSR leg moves one beta per helper, the control k full shards
    msr_local = sum(beta for h in helpers if az_of[h] == az_of[failed])
    msr_cross = sum(beta for h in helpers if az_of[h] != az_of[failed])
    conv_local = sum(shard_size for i in conv_set
                     if az_of[i] == az_of[failed])
    conv_cross = sum(shard_size for i in conv_set
                     if az_of[i] != az_of[failed])
    repaired = stripes * shard_size
    med_m, med_c = _median(m_walls), _median(c_walls)
    return {
        "mode": "repair-ab",
        "geometry": {"k": k, "m": m, "d": d, "alpha": alpha,
                     "az_count": az_count, "shard_size": shard_size,
                     "beta": beta, "failed_unit": failed,
                     "helpers": list(helpers),
                     "conventional_read_set": list(conv_set)},
        "stripes": stripes,
        "rounds": rounds,
        "engine": engine,
        "device": str(dev),
        "bytes_pulled_per_stripe": {
            "msr": {"az_local": msr_local, "cross_az": msr_cross,
                    "total": msr_local + msr_cross},
            "conventional": {"az_local": conv_local, "cross_az": conv_cross,
                             "total": conv_local + conv_cross},
        },
        "reduction_x": round((conv_local + conv_cross)
                             / (msr_local + msr_cross), 2),
        "cross_az_reduction_x":
            round(conv_cross / msr_cross, 2) if msr_cross else None,
        "msr": {"median_wall_s": round(med_m, 3),
                "repair_gibs": round(repaired / med_m / 2**30, 4)},
        "conventional": {"median_wall_s": round(med_c, 3),
                         "repair_gibs": round(repaired / med_c / 2**30, 4)},
        "msr_mean_stripes_per_device_step":
            round(m_occ[0] / m_occ[1], 2) if m_occ and m_occ[1] else None,
        "bit_identical": bool(bit_identical),
    }


def run_fallback_ab(rounds: int = 3, stripes: int = 8,
                    shard_ec: int = 1 << 18, shard_msr: int = 49152,
                    seed: int = 0x19AB, wait_ms: float = 0.25) -> dict:
    """Degraded-mode XOR-door A/B.

    Not a microbenchmark: every timed call rides the real admission →
    dispatch → fallback machinery while a simulated device-loss drill
    (CUBEFS_CODEC_DEAD) declares the card AND native legs transiently
    dead — the exact cluster posture where codec throughput becomes
    repair MTTR. What remains is the numpy host leg, and the
    CUBEFS_CODEC_XOR door decides whether it serves as the compiled
    XOR schedule (numpy-xor) or the naive GF(256) table path. Four
    production-shaped workloads: EC6P3 encode + worst-case repair
    decode, EC6P6MSR sub-shard encode + d=11 regenerating repair.
    ABBA-ordered alternating rounds, per-leg medians, bit-identity
    across both door positions AND against the gf_matmul golden,
    reproducible schedule digests, and the served-leg evidence from
    engine.last_dispatch."""
    from ..codec import engine as eng
    from ..ops import gf256, xorprog

    k1, m1 = 6, 3
    k2, m2, d2 = 6, 6, 11
    total2 = k2 + m2
    alpha = d2 - k2 + 1
    if shard_msr % alpha:
        raise SystemExit(f"--shard-size {shard_msr} not divisible by "
                         f"alpha={alpha}")
    beta = shard_msr // alpha
    rng = np.random.default_rng(seed)
    helpers = tuple(range(1, d2 + 1))

    # (label, coeff, input batch): each coeff is a real production
    # matrix, each input the shape that matrix sees in the field
    workloads = [
        ("ec6p3_encode", gf256.parity_matrix(k1, m1),
         rng.integers(0, 256, (stripes, k1, shard_ec), dtype=np.uint8)),
        ("ec6p3_repair", gf256.decode_matrix(k1, k1 + m1,
                                             list(range(m1, m1 + k1))),
         rng.integers(0, 256, (stripes, k1, shard_ec), dtype=np.uint8)),
        ("ec6p6msr_encode", msr.encode_rows(k2, total2, d2),
         rng.integers(0, 256, (stripes, k2 * alpha, beta), dtype=np.uint8)),
        ("ec6p6msr_repair", msr.repair_rows(k2, total2, d2, 0, helpers),
         rng.integers(0, 256, (stripes, d2, beta), dtype=np.uint8)),
    ]

    saved_dead = os.environ.get("CUBEFS_CODEC_DEAD")
    saved_door = os.environ.get("CUBEFS_CODEC_XOR")
    drill = "cuda,cpp,cpp-xor"
    requested = "cpp"  # a routed host request: the drill moves it down the chain
    walls: dict[str, dict[str, list[float]]] = {
        lbl: {"xor": [], "naive": []} for lbl, _, _ in workloads}
    outs: dict[str, dict[str, np.ndarray]] = {lbl: {} for lbl, _, _ in
                                              workloads}
    served: dict[str, str] = {}
    try:
        os.environ["CUBEFS_CODEC_DEAD"] = drill
        codec = BatchCodec(enabled=True, max_wait_ms=wait_ms)
        # warm both legs outside the timed window: program compiles,
        # lib loads, crossover read — none of it is drill throughput
        for door in ("1", "0"):
            os.environ["CUBEFS_CODEC_XOR"] = door
            for lbl, coeff, data in workloads:
                codec.submit_apply(None, coeff, data[:1], engine=requested)
        # ABBA pair ordering: monotone host drift cancels per pair
        order: list[bool] = []
        for i in range(rounds):
            order += [True, False] if i % 2 == 0 else [False, True]
        for use_xor in order:
            os.environ["CUBEFS_CODEC_XOR"] = "1" if use_xor else "0"
            leg = "xor" if use_xor else "naive"
            for lbl, coeff, data in workloads:
                t0 = time.perf_counter()
                out = codec.submit_apply(None, coeff, data, engine=requested)
                walls[lbl][leg].append(time.perf_counter() - t0)
                outs[lbl][leg] = out
                served[f"{lbl}:{leg}"] = eng.last_dispatch["served"]
    finally:
        for key, val in (("CUBEFS_CODEC_DEAD", saved_dead),
                         ("CUBEFS_CODEC_XOR", saved_door)):
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val

    bit_identical = True
    per_workload = {}
    agg_bytes = agg_xor_s = agg_naive_s = 0.0
    for lbl, coeff, data in workloads:
        golden = np.stack([gf256.gf_matmul(coeff, b) for b in data])
        same = (np.array_equal(outs[lbl]["xor"], golden)
                and np.array_equal(outs[lbl]["naive"], golden))
        bit_identical = bit_identical and same
        prog = xorprog.program_for(np.ascontiguousarray(coeff,
                                                        dtype=np.uint8))
        mx, mn = _median(walls[lbl]["xor"]), _median(walls[lbl]["naive"])
        nbytes = float(data.nbytes)
        agg_bytes += nbytes
        agg_xor_s += mx
        agg_naive_s += mn
        per_workload[lbl] = {
            "input_mib": round(nbytes / 2**20, 2),
            "xor": {"median_wall_s": round(mx, 4),
                    "gibs": round(nbytes / mx / 2**30, 4),
                    "served_leg": served[f"{lbl}:xor"]},
            "naive": {"median_wall_s": round(mn, 4),
                      "gibs": round(nbytes / mn / 2**30, 4),
                      "served_leg": served[f"{lbl}:naive"]},
            "speedup_x": round(mn / mx, 2),
            "bit_identical": bool(same),
            "schedule_digest": prog.schedule_digest,
            "schedule": prog.stats(),
        }
    return {
        "mode": "fallback-ab",
        "drill": {"dead_engines": drill.split(","),
                  "requested_engine": requested,
                  "note": "transient drill deaths — no quarantine; the "
                          "door picks which surviving numpy leg serves"},
        "rounds": rounds,
        "stripes": stripes,
        "workloads": per_workload,
        "aggregate": {
            "total_input_mib": round(agg_bytes / 2**20, 2),
            "xor_gibs": round(agg_bytes / agg_xor_s / 2**30, 4),
            "naive_gibs": round(agg_bytes / agg_naive_s / 2**30, 4),
            "speedup_x": round(agg_naive_s / agg_xor_s, 2),
        },
        "bit_identical": bool(bit_identical),
    }


def _blob_cluster(tmpdir: str, n_nodes: int = 4, disks_per_node: int = 3,
                  device="cuda"):
    """Fresh in-process blob cluster (the test_blob_e2e shape) — one per
    obs-tail leg, since the repair phase breaks a disk. Its codec runs on
    ``device`` through engine ``cuda``."""
    from ..blob.access import AccessConfig, AccessHandler, NodePool
    from ..blob.blobnode import BlobNode
    from ..blob.clustermgr import ClusterMgr
    from ..blob.mq import MessageQueue
    from ..blob.scheduler import Scheduler
    from ..blob.worker import RepairWorker
    from ..utils import rpc

    os.makedirs(tmpdir, exist_ok=True)
    cm = ClusterMgr()
    cm_client = rpc.Client(cm)
    pool = NodePool()
    nodes = []
    for nn in range(n_nodes):
        node = BlobNode(
            node_id=nn,
            disk_paths=[os.path.join(tmpdir, f"n{nn}d{d}")
                        for d in range(disks_per_node)],
            cm_client=cm_client, addr=f"node{nn}", device=device, engine="cuda")
        node.register()
        node.send_heartbeat()
        pool.bind(f"node{nn}", node)
        nodes.append(node)
    rq, dq = MessageQueue(), MessageQueue()
    access = AccessHandler(cm_client, pool,
                           AccessConfig(blob_size=64 << 10, engine="cuda", device=device),
                           repair_queue=rq, delete_queue=dq)
    sched = Scheduler(cm, repair_queue=rq, delete_queue=dq, node_pool=pool,
                      device=device, engine="cuda")
    worker = RepairWorker(rpc.Client(sched), cm_client, pool, engine="cuda", device=device)
    return cm, nodes, access, sched, worker


def run_obs_tail(workdir: str, puts: int = 48, payload_kb: int = 256,
                 rounds: int = 5, device="cuda") -> dict:
    """Blob-plane observability A/B (the blob section of the
    observability record). The trace door is read per request, so the A/B
    interleaves CUBEFS_TRACE=1 / =0 PUT+GET batches against ONE
    cluster — per-cluster construction variance and host drift cancel
    instead of landing on one leg. Reports per-batch medians, the
    per-stage tails for blob.put / blob.get / blob.repair (repair runs
    once, instrumented, at the end: it breaks a disk), and one
    rendered example PUT trace."""
    from ..codec import codemode as cmode
    from ..utils import slo as slolib
    from ..utils import trace as tracelib

    saved = os.environ.get("CUBEFS_TRACE")
    put_on: list[float] = []
    put_off: list[float] = []
    example = ""
    try:
        os.environ["CUBEFS_TRACE"] = "1"
        cm, nodes, access, sched, worker = _blob_cluster(
            os.path.join(workdir, "ab"), device=device)
        rng = np.random.default_rng(0x0B5)
        data = [rng.integers(0, 256, payload_kb << 10,
                             dtype=np.uint8).tobytes()
                for _ in range(puts)]
        # warm up outside the timed batches: engine load, crossover
        # table, volume allocation
        warm = access.put(data[0], codemode=cmode.CodeMode.EC6P3)
        assert access.get(warm) == data[0]
        tracelib.reset_collector()
        mib = puts * payload_kb / 1024.0
        # ABBA pair ordering: a monotone drift (cache warming, log
        # growth) would otherwise always tax the same leg
        order: list[bool] = []
        for i in range(rounds):
            order += [True, False] if i % 2 == 0 else [False, True]
        first_locs = None
        for on in order:
            os.environ["CUBEFS_TRACE"] = "1" if on else "0"
            t0 = time.perf_counter()
            locs = [access.put(d, codemode=cmode.CodeMode.EC6P3)
                    for d in data]
            pw = time.perf_counter() - t0
            (put_on if on else put_off).append(round(mib / pw, 2))
            if on and first_locs is None:
                first_locs = locs
        # correctness + blob.get stage tails, instrumented, outside
        # the timed A/B (gets are read-path bound and would separate
        # the paired batches)
        os.environ["CUBEFS_TRACE"] = "1"
        t0 = time.perf_counter()
        ok = all(access.get(loc) == d
                 for loc, d in zip(first_locs, data))
        get_wall = time.perf_counter() - t0
        roots = [s for s in tracelib.finished_spans()
                 if s["op"] == "access.put" and s["parent_id"] is None]
        if roots:
            example = tracelib.render_tree(
                tracelib.trace_tree(roots[0]["trace_id"]))
        # one full disk repair, instrumented, so blob.repair stages
        # land in the histogram (destructive: runs after the A/B)
        vol = cm.get_volume(first_locs[0].slices[0].vid)
        victim = vol.units[1]
        next(n for n in nodes
             if n.addr == victim.node_addr).break_disk(victim.disk_id)
        sched.mark_disk_broken(victim.disk_id)
        t0 = time.perf_counter()
        # enough drains to fill the blob.repair stage histogram — a
        # full-disk drain would dwarf the A/B (reads stay correct
        # either way: one lost unit degrades, it doesn't fail)
        for _ in range(64):
            if not worker.run_once():
                break
        repair_wall = time.perf_counter() - t0
        ok = ok and access.get(first_locs[0]) == data[0]
        tails = slolib.quantiles_from_histogram()
    finally:
        if saved is None:
            os.environ.pop("CUBEFS_TRACE", None)
        else:
            os.environ["CUBEFS_TRACE"] = saved
    med_on, med_off = _median(put_on), _median(put_off)
    # per-pair ratios: pair i contributed put_on[i] and put_off[i]
    # back-to-back, so the store-growth drift that dominates absolute
    # throughput cancels inside each pair
    pair_overheads = [round((off_v / on_v - 1.0) * 100, 2)
                      for on_v, off_v in zip(put_on, put_off)]
    return {
        "paths": ["blob.put", "blob.get", "blob.repair"],
        "puts_per_batch": puts,
        "payload_kb": payload_kb,
        "batches_per_leg": rounds,
        "interleaved": True,
        "trace_on": {"median_put_mibs": med_on, "put_mibs": put_on},
        "trace_off": {"median_put_mibs": med_off,
                      "put_mibs": put_off},
        "get_mibs": round(mib / get_wall, 2),
        "overhead_pct": _median(pair_overheads),
        "pair_overheads_pct": pair_overheads,
        "repair_wall_s": round(repair_wall, 3),
        "roundtrip_identical": bool(ok),
        "stage_tails": {p: t for p, t in tails.items()
                        if p.startswith("blob.")},
        "example_trace": example,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="cubefs-tpu-torch-bench-codec")
    ap.add_argument("--repair-ab", action="store_true",
                    help="run the MSR sub-shard vs conventional k-shard "
                         "repair-traffic A/B instead of the encode bench")
    ap.add_argument("--fallback-ab", action="store_true",
                    help="degraded-mode XOR-door A/B: encode+repair on "
                         "the surviving numpy leg under a device-loss "
                         "drill, CUBEFS_CODEC_XOR on vs off")
    ap.add_argument("--obs-tail", action="store_true",
                    help="blob-plane instrumentation overhead A/B "
                         "(CUBEFS_TRACE=1 vs 0) + per-stage tails; "
                         "merges into --out")
    ap.add_argument("--puts", type=int, default=48,
                    help="obs-tail: PUTs per round")
    ap.add_argument("--payload-kb", type=int, default=256,
                    help="obs-tail: payload size per PUT")
    ap.add_argument("--stripes", type=int, default=96,
                    help="repair-ab: stripes repaired per leg")
    ap.add_argument("--d", type=int, default=11,
                    help="repair-ab: MSR helper count")
    ap.add_argument("--az-count", type=int, default=3)
    ap.add_argument("--failed", type=int, default=0,
                    help="repair-ab: unit index to lose")
    ap.add_argument("--submitters", type=int, default=32)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--n", type=int, default=6)
    ap.add_argument("--m", type=int, default=3)
    ap.add_argument("--shard-size", type=int, default=2048)
    ap.add_argument("--engine", default="cuda",
                    help="cuda (tensors on --device; kernel A) or a host "
                         "engine's name, or auto")
    ap.add_argument("--device", default="cuda",
                    help="the card (cuda, the default) or cpu")
    ap.add_argument("--wait-ms", type=float, default=0.25,
                    help="admission max-wait (latency/occupancy knob)")
    ap.add_argument("--depth", type=int, default=4,
                    help="per-submitter async pipeline depth")
    ap.add_argument("--rounds", type=int, default=3,
                    help="alternating leg rounds; medians reported")
    ap.add_argument("--out", default=None,
                    help="write the record's JSON here")
    args = ap.parse_args(argv)
    if args.obs_tail:
        import tempfile

        workdir = tempfile.mkdtemp(prefix="cubefs-bench-obscodec-")
        result = run_obs_tail(workdir, puts=args.puts,
                              payload_kb=args.payload_kb,
                              rounds=args.rounds, device=args.device)
        print(json.dumps(result, indent=1))
        if args.out:
            merge_artifact(args.out, "blob", result)
        return
    if args.fallback_ab:
        result = run_fallback_ab(rounds=args.rounds,
                                 wait_ms=args.wait_ms)
        text = json.dumps(result, indent=1)
        print(text)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                f.write(text + "\n")
        return
    if args.repair_ab:
        # repair-ab defaults to the EC6P6MSR production geometry; the
        # encode bench's 6+3/2048 defaults don't carry over
        shard = args.shard_size if args.shard_size != 2048 else 12288
        m_ = args.m if args.m != 3 else 6
        result = run_repair_ab(
            stripes=args.stripes, k=args.n, m=m_, d=args.d,
            az_count=args.az_count, shard_size=shard, engine=args.engine,
            failed=args.failed, wait_ms=args.wait_ms, rounds=args.rounds,
            device=args.device)
    else:
        result = run_ab(args.submitters, args.iters, args.n, args.m,
                        args.shard_size, args.engine, wait_ms=args.wait_ms,
                        depth=args.depth, rounds=args.rounds, device=args.device)
    text = json.dumps(result, indent=2)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
