#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port, ``cubefs_tpu_torch``.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout,
holds each against its plain PyTorch version at the width of the
production EC12P4 codemode (RS(12+4), 4 MiB shards), at the LRC and MSR
shapes (EC16P20L2's composed 22x16 rows, EC6P6MSR's 36x36 rows, helper
row and repair rows at beta = 699,051) and on the edges of their
designs (ragged and unaligned shards, parity written in place, strided
and unaligned CRC blocks of odd lengths), times each whole call with
CUDA events (``ms``) and each kernel alone from the profiler's CUDA
trace (``device_ms``, host work excluded), then drives the port's main
path through its public entry points (encode and reconstruct of a
48 MiB payload, the pinned RS(12+4) fixture, the repair step with a
corrupted survivor, blob frame verification) and checks that the path
launched both of its kernels. Then the codec families (EC16P20L2 and
EC6P6MSR stripes at full width, the pinned EC16P20L2 fixture, the MSR
sub-shard repair of every slot with a corrupted helper symbol) and the
codec batcher (concurrent small PUTs from 32 threads, of one size and
of mixed sizes), each held against the plain version and the unbatched
launches, with the launch
counts of each path read from zero. It times the entry points end to
end. Then it drives the GF tuning path (``tuning/gf_tuning.py``, both
rounds), which runs the bit-matrix tensor-core kernels, and checks that
it launched them. Last, the sharded codec step (``parallel/``): 8 ranks
spawned on the card (gloo, or NCCL where 8 cards are visible) run the
encode, repair and CRC on a mixed (2, 2, 2) mesh at the repair case's
width and on a dp-only (8, 1, 1) fleet, each rank on its own block
through A and B, every block held exactly against the plain version,
the single-rank path, the lost shards and zlib. Before it, the codec
service: the server's ``codec`` role started as its users start it
(``python -m cubefs_tpu_torch.cmd``) in a process of its own, driven
over its wire with ``http.client`` (8 MiB blobs over the body, 4 MiB
shards through ``/dev/shm``, CRCs, verify, 32 concurrent clients, four
refusals), every reply held against the plain versions and zlib, the
coalescing and byte counts read from its ``/metrics``. Each phase
prints one JSON line; any failure, in any rank, raises.

The last lines are the kernels' record, the card's name and power limit
as nvidia-smi reports them, and ``{"ok": true, "device": {...}}``.
Without a CUDA device, or outside a checkout of the repository, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import functools
import http.client
import itertools
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SEED = 20261016
MIB = 1 << 20
SHARD = 4 * MIB  # EC12P4 production shard size
MSR_PAYLOAD = 24 * MIB  # an EC6P6MSR blob: shards of 4 MiB + 2, beta = 699,051
PUT = MIB  # a small blob PUT, as the access layer sends them concurrently
# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
KERNEL_REPS = 10
PLAIN_REPS = 3
MAIN_KERNELS = ("gf_apply", "crc32_blocks")  # repair_step and Encoder run these
# the sharded step's meshes on 8 ranks: the mixed mesh at the repair case's
# width, then the reference dryrun's dp-only fleet (192 MiB of survivors)
SHARDED_RUNS = (
    {"name": "mixed", "dims": {"dp": 2, "tp": 2, "sp": 2}, "seed": SEED, "b": 4, "n": 12,
     "m": 4, "s": SHARD, "bad": [1, 7]},
    {"name": "dp_only", "dims": {"dp": 8, "tp": 1, "sp": 1}, "seed": SEED + 1, "b": 64,
     "n": 12, "m": 4, "s": 256 << 10, "bad": [2, 13]},
)
# phase service: the codec role as its users start it ("listen_port": 0 takes
# a free port), an access-layer blob (blob_size = 8 MiB: EC12P4 shards of
# 699,051 bytes, A's byte-load path) and the timed calls a case makes
SERVICE_CFG = {"role": "codec", "listen_port": 0}
BLOB = 8 * MIB
SERVICE_REPS = 5
# phase engines: the five legs of the codec engine layer, the stripe sizes
# of the crossover's classes, the beyond-table step and the concurrent PUTs
LEGS = ("cuda", "cpp", "cpp-xor", "numpy-xor", "numpy")
BEYOND_TABLE = 64 * MIB
ENGINE_THREADS, ENGINE_PUTS = 32, 8
ENGINES_CFG = {"role": "codec", "listen_port": 0, "ec_engine": "auto"}
# the C and D instantiations the kernels' record reports: (case, extract, probe, grid)
RECORDED_BM = (("tuning_rows_2x12_B4", "bcast", None, "flat"),
               ("tuning_rows_2x12_B4", "bcast", "nodot", "stripe"))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def ptxas_registers(log: str) -> dict[str, int]:
    """Mangled kernel name -> registers per thread, from the ``-Xptxas -v``
    report nvcc wrote while building a source (none if the library was
    built without it)."""
    regs, name = {}, None
    if not os.path.exists(log):
        return regs
    with open(log) as f:
        for ln in f:
            m = re.search(r"Compiling entry function '([^']+)'", ln)
            if m:
                name = m.group(1)
            m = re.search(r"Used (\d+) registers", ln)
            if m and name:
                regs[name], name = int(m.group(1)), None
    return regs


def sharded_summary(run: dict, per_rank: list[dict]) -> dict:
    """One mesh's record from its ranks' ``dryrun.multichip`` summaries:
    every check on every rank, each rank's launches of A and B in the
    sharded calls, the slowest rank's medians and rank 0's kernel times.
    ``held``: every check true, every rank launched A and B, nothing else."""
    launched = [s["launches"] for s in per_rank]
    res = {"run": run["name"], "dims": per_rank[0]["dims"], "B": run["b"], "N": run["n"],
           "M": run["m"], "S": run["s"], "bad": run["bad"], "block": per_rank[0]["block"],
           "equal": {c: all(s["checks"][c] for s in per_rank) for c in per_rank[0]["checks"]},
           "launches": {k: [c[k] for c in launched] for k in MAIN_KERNELS},
           "other_launches": sum(v for c in launched for k, v in c.items()
                                 if k not in MAIN_KERNELS)}
    for key in ("step_ms", "encode_ms", "collective_ms"):
        res[key] = max(s[key] for s in per_rank)
    res["step_ms_by_rank"] = [s["step_ms"] for s in per_rank]
    res["rank0_device_ms"] = per_rank[0]["kernel_ms"]
    res["held"] = (all(res["equal"].values()) and res["other_launches"] == 0
                   and all(x > 0 for k in MAIN_KERNELS for x in res["launches"][k]))
    return res


def rpc_post(addr: str, method: str, args: dict, body: bytes = b"",
             headers: dict | None = None) -> tuple[int, dict, bytes]:
    """One call of the codec service's wire over a fresh connection, as
    its native client makes it: (status, meta, payload)."""
    host, port = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=300)
    try:
        conn.request("POST", f"/{method}", body=body,
                     headers={"X-Rpc-Args": json.dumps(args), **(headers or {})})
        resp = conn.getresponse()
        payload = resp.read()
        return resp.status, json.loads(resp.headers.get("X-Rpc-Resp") or "{}"), payload
    finally:
        conn.close()


def scrape(addr: str) -> dict[str, float]:
    """The server's ``GET /metrics`` as {series (name and labels): value}."""
    host, port = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    try:
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
    finally:
        conn.close()
    return {ln.rsplit(" ", 1)[0]: float(ln.rsplit(" ", 1)[1])
            for ln in text.splitlines() if ln and not ln.startswith("#")}


def start_server(root: str, cfg: dict, workdir: str) -> tuple[subprocess.Popen, str]:
    """The port's codec role as its users start it, ``python -m
    cubefs_tpu_torch.cmd -c <cfg>``; returns (process, address) once it
    prints its listening line, or kills it and raises."""
    path = os.path.join(workdir, "codec.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    err = open(os.path.join(workdir, "codec.err"), "w")
    proc = subprocess.Popen([sys.executable, "-m", "cubefs_tpu_torch.cmd", "-c", path],
                            cwd=root, stdout=subprocess.PIPE, stderr=err, text=True)
    err.close()
    line: list[str] = []
    reader = threading.Thread(target=lambda: line.append(proc.stdout.readline()), daemon=True)
    reader.start()
    reader.join(180.0)
    m = re.fullmatch(r"\[codec\] listening on (\S+)\n", line[0]) if line else None
    if m is None:
        proc.kill()
        proc.wait(30)
        with open(os.path.join(workdir, "codec.err")) as f:
            raise AssertionError(f"the codec role did not start: {line} {f.read()[-4000:]}")
    return proc, m.group(1)


def cpu_model() -> str:
    """The host CPU as /proc/cpuinfo gives its first processor: the model
    name, then vendor, family, model and stepping (a sandboxed kernel may
    report the name as "unknown"), and the SIMD flags the host legs use."""
    info = {}
    with open("/proc/cpuinfo") as f:
        for ln in f:
            if not ln.strip():
                break
            key, _, value = ln.partition(":")
            info[key.strip()] = value.strip()
    flags = [f for f in ("ssse3", "avx2", "avx512f", "avx512bw", "gfni")
             if f in info.get("flags", "").split()]
    return (f"{info.get('model name', '?')} ({info.get('vendor_id', '?')} family "
            f"{info.get('cpu family', '?')} model {info.get('model', '?')} stepping "
            f"{info.get('stepping', '?')}, {info.get('cpu MHz', '?')} MHz; "
            f"{' '.join(flags)})")


def engines_phase(root: str, dev, card: str, *, shard: int = SHARD, blob: int = BLOB,
                  beyond: int = BEYOND_TABLE, put: int = PUT, sizes=None,
                  server_cfg: dict = ENGINES_CFG, crc_rows: tuple = (1024, 128 << 10)) -> dict:
    """Phase ``engines``: the codec engine layer on this host and card.

    The five legs agree byte for byte on the EC12P4 encode at ``shard``
    and at the shard size of a ``blob``, the (2, 12) recovery rows of
    shards 1 and 7, the composed EC16P20L2 rows and an EC6P6MSR repair
    matrix; ``measure_crossover`` times the legs at the reference's sizes
    and persists the table; ``auto`` routes a 64 KiB stripe to the
    table's leg and a step beyond the table to ``cuda`` (kernel A, one
    launch); the ``CUBEFS_CODEC_DEAD=cuda`` drill serves it by ``cpp``,
    logged, and clearing it restores ``cuda``; 32 threads of numpy PUTs
    go through the batcher under ``auto``; and a second codec role with
    ``ec_engine: auto`` answers encode and crc32 from the table just
    persisted. Every leg's time is its whole call, numpy in to numpy out
    (the ``cuda`` leg's copies in and out included), and its GiB/s the
    stripe's input bytes over that time. Returns the phase's record with
    ``checks``; the caller fails on any false one."""
    import logging

    from cubefs_tpu_torch.codec import codemode as cm
    from cubefs_tpu_torch.codec import engine as engines
    from cubefs_tpu_torch.codec.batcher import AdmittedEngine, BatchCodec
    from cubefs_tpu_torch.codec.encoder import CodecConfig, new_encoder
    from cubefs_tpu_torch.ops import _build, gf256, gfcpu, msr, rs_kernel
    from cubefs_tpu_torch.utils import metrics

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 9)
    host = {"card": card, "cpu_model": cpu_model(), "gf_cpu_level": gfcpu.cpu_level(),
            "cpu_count": os.cpu_count()}
    print(json.dumps({"phase": "engines", "host": host}), flush=True)
    os.environ.pop("CUBEFS_CODEC_DEAD", None)
    os.environ.pop("CUBEFS_CODEC_XOR", None)
    _build.reset_launches()

    def call(leg: str, coeff, x) -> tuple[np.ndarray, float]:
        t = time.perf_counter()
        y = engines.host_call(leg, "matrix_apply", dev, coeff, x)
        return y, time.perf_counter() - t

    # -- the five legs agree --------------------------------------------------
    n, m = 12, 4
    blob_s = -(-blob // n)
    present = [i for i in range(n + m) if i not in (1, 7)]
    lrc_rows = new_encoder(CodecConfig(cm.CodeMode.EC16P20L2, engine="numpy"))._encode_rows
    msr_t = cm.tactic(cm.CodeMode.EC6P6MSR)
    helpers = tuple(range(1, msr_t.total))
    beta = new_encoder(CodecConfig(cm.CodeMode.EC6P6MSR, engine="numpy")).shard_size(
        3 * blob) // msr_t.alpha
    agree_cases = [  # (label, coeff, shards)
        ("encode_EC12P4_4MiB", gf256.parity_matrix(n, m), (n, shard)),
        ("encode_EC12P4_S699051", gf256.parity_matrix(n, m), (n, blob_s)),
        ("recover_2x12_shards_1_7", rs_kernel.reconstruct_rows(n, n + m, present, [1, 7]),
         (n, shard)),
        ("lrc_rows_22x16_EC16P20L2", lrc_rows, (16, shard // 4)),
        ("msr_repair_6x11_EC6P6MSR", msr.repair_rows(msr_t.n, msr_t.total, msr_t.d, 0, helpers),
         (msr_t.d, beta)),
    ]
    agree = []
    for label, coeff, shape in agree_cases:
        x = rng.integers(0, 256, shape, dtype=np.uint8)
        for leg in LEGS:  # warm: the build, the program, the device's tables
            call(leg, coeff, x[:, :4096])
        outs, secs = {}, {}
        for leg in LEGS:
            outs[leg], secs[leg] = call(leg, coeff, x)
        equal = all(np.array_equal(outs[leg], outs["numpy"]) for leg in LEGS)
        moved = x.nbytes  # GiB/s of stripe bytes in, as the crossover's classes count them
        agree.append({"case": label, "R": int(coeff.shape[0]), "C": int(coeff.shape[1]),
                      "S": int(shape[1]), "equal": equal,
                      "ms": {leg: secs[leg] * 1e3 for leg in LEGS},
                      "gib_s": {leg: moved / secs[leg] / 2**30 for leg in LEGS}})
        del x, outs

    # -- the crossover on this host and card, persisted --------------------
    kw = {} if sizes is None else {"sizes": sizes}
    table = engines.measure_crossover(device=dev, **kw)
    with open(engines._policy_path()) as f:
        saved = json.load(f)
    per_size = {size: {leg: {"s": t, "gib_s": int(size) / t / 2**30}
                       for leg, t in per.items()} for size, per in saved["timings_s"].items()}
    engines._policy = None  # what a later process loads
    loaded = engines._load_policy(dev)

    # -- routing, no drill ----------------------------------------------------
    auto = engines.AutoEngine(dev)
    golden_leg = engines.get_engine("cpp")
    small = rng.integers(0, 256, (6, table[0][0] // 6), dtype=np.uint8)
    big = rng.integers(0, 256, (6, beyond // 6), dtype=np.uint8)
    big_want = golden_leg.encode_parity(big, 3)
    routes = {}

    def routed(label: str, x: np.ndarray, want: np.ndarray, served: str, reps: int) -> None:
        a0 = _build.LAUNCHES["gf_apply"]
        got = auto.encode_parity(x, 3)
        a1 = _build.LAUNCHES["gf_apply"]
        disp = dict(engines.last_dispatch)
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            auto.encode_parity(x, 3)
            times.append((time.perf_counter() - t) * 1e3)
        routes[label] = {"bytes": int(x.nbytes), "last_dispatch": disp,
                         "served_want": served, "equal": bool(np.array_equal(got, want)),
                         "a_launches": a1 - a0, "ms": statistics.median(times), "ms_runs": times}

    small_leg = engines.resolve_leg(table[0][1])
    routed("stripe_64KiB", small, golden_leg.encode_parity(small, 3), small_leg, 5)
    routed("beyond_table_64MiB", big, big_want, "cuda", 3)

    # -- the drill ----------------------------------------------------------
    caught: list[str] = []

    class _Catch(logging.Handler):
        def emit(self, record):
            caught.append(record.getMessage())

    handler = _Catch(logging.WARNING)
    logging.getLogger("cubefs.codec").addHandler(handler)
    os.environ["CUBEFS_CODEC_DEAD"] = "cuda"
    try:
        routed("drill_dead_cuda_64MiB", big, big_want, "cpp", 1)
    finally:
        os.environ.pop("CUBEFS_CODEC_DEAD")
        logging.getLogger("cubefs.codec").removeHandler(handler)
    routed("drill_cleared_64MiB", big, big_want, "cuda", 1)
    drill_warned = [msg for msg in caught if "CUBEFS_CODEC_DEAD" in msg]
    del big, big_want

    # -- the batcher under auto: 32 threads of numpy PUTs ---------------------
    bc = BatchCodec(enabled=True)
    put_enc = new_encoder(CodecConfig(cm.CodeMode.EC12P4, engine="auto", device=dev))
    put_enc.engine = AdmittedEngine(bc, dev, engine="auto")
    put_s = put_enc.shard_size(put)
    n_puts = ENGINE_THREADS * ENGINE_PUTS
    payloads = rng.integers(0, 256, (n_puts, put), dtype=np.uint8)
    stripes = [None] * n_puts
    start = threading.Barrier(ENGINE_THREADS)

    def putter(i: int) -> None:
        start.wait(60.0)
        pend = []
        for j in range(ENGINE_PUTS):
            k = i * ENGINE_PUTS + j
            stripes[k] = put_enc.split(payloads[k].tobytes())
            pend.append(put_enc.encode_async(stripes[k]))
        for p in pend:
            p.wait()

    def steps_by_leg() -> dict[str, float]:
        return {leg: metrics.codec_batch_steps.value(op="encode", engine=leg) for leg in LEGS}

    s0 = steps_by_leg()
    t = time.perf_counter()
    with ThreadPoolExecutor(ENGINE_THREADS) as pool:
        for f in [pool.submit(putter, i) for i in range(ENGINE_THREADS)]:
            f.result()
    put_wall = time.perf_counter() - t
    s1 = steps_by_leg()
    got = np.stack(stripes)
    want = engines.get_engine("numpy").encode_parity(np.ascontiguousarray(got[:, :n]), m)
    batcher = {"threads": ENGINE_THREADS, "puts": n_puts, "shard_size": put_s,
               "steps": {leg: s1[leg] - s0[leg] for leg in LEGS if s1[leg] != s0[leg]},
               "submissions": bc.submissions, "seconds": put_wall,
               "gib_s": n_puts * put / put_wall / 2**30,
               "equal": bool(np.array_equal(got[:, n:], want))}
    del payloads, stripes, got, want

    # -- the service under auto: a second codec role -----------------------
    workdir = tempfile.mkdtemp(prefix="cubefs-smoke-auto-")
    proc, addr = start_server(root, server_cfg, workdir)
    service = {"server": addr, "cases": []}
    try:
        m0 = scrape(addr)
        status, meta, _ = rpc_post(addr, "engine", {})
        service["engine_reply"] = {"status": status, "meta": meta}
        blobs = rng.integers(0, 256, (4, n, blob_s), dtype=np.uint8)
        want_parity = engines.get_engine("numpy").encode_parity(blobs, m).tobytes()
        rows, block = crc_rows
        crc_body = rng.integers(0, 256, rows * block, dtype=np.uint8).tobytes()
        want_crc = np.asarray([zlib.crc32(crc_body[i:i + block])
                               for i in range(0, len(crc_body), block)], dtype="<u4").tobytes()
        for label, method, args, body, want_meta, want_payload in (
                ("encode_EC12P4_8MiB_blobs_B4", "encode",
                 {"n": n, "m": m, "shard_size": blob_s, "batch": 4}, blobs.tobytes(),
                 {"shape": [4, m, blob_s]}, want_parity),
                (f"crc32_{rows}x{block}", "crc32", {"block_len": block}, crc_body,
                 {"count": rows}, want_crc)):
            times, ok = [], True
            for _ in range(1 + SERVICE_REPS):
                t = time.perf_counter()
                status, meta, payload = rpc_post(addr, method, args, body)
                times.append((time.perf_counter() - t) * 1e3)
                ok = ok and (status, meta, payload) == (200, want_meta, want_payload)
            service["cases"].append({"case": label, "equal": ok, "ms_first": times[0],
                                     "ms": statistics.median(times[1:]), "ms_runs": times[1:],
                                     "bytes_in": len(body)})
        m1 = scrape(addr)
        service["delta"] = {k: m1[k] - m0.get(k, 0.0) for k in m1
                            if k.startswith(("cubefs_codec_batch_steps_total",
                                             "cubefs_codec_kernel_launches_total"))
                            and m1[k] != m0.get(k, 0.0)}
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            service["server_exit"] = proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)
            service["server_exit"] = None
        shutil.rmtree(workdir, ignore_errors=True)

    launches = dict(_build.LAUNCHES)
    d = service["delta"]
    checks = {
        **{f"agree.{c['case']}": c["equal"] for c in agree},
        "table_persisted": saved["table"] == table and saved["platform"] == "cuda"
        and loaded == table,
        "table_has_every_size": [row[0] for row in table] == list(
            sizes or engines._POLICY_SIZES),
        **{f"route.{k}": (r["equal"] and r["last_dispatch"]["served"] == r["served_want"])
           for k, r in routes.items()},
        "beyond_table_is_one_launch_of_a": routes["beyond_table_64MiB"]["a_launches"] == 1,
        "drill_launches_no_a": routes["drill_dead_cuda_64MiB"]["a_launches"] == 0,
        "drill_cleared_is_one_launch_of_a": routes["drill_cleared_64MiB"]["a_launches"] == 1,
        "drill_requested_cuda": routes["drill_dead_cuda_64MiB"]["last_dispatch"]["requested"]
        == "cuda",
        "drill_warned_once": drill_warned == ["CUBEFS_CODEC_DEAD=cuda: 'cuda' served by 'cpp'"],
        "batcher_equal": batcher["equal"] and batcher["submissions"] == n_puts,
        "batcher_fewer_steps_than_puts": 0 < sum(batcher["steps"].values()) < n_puts,
        "service_equal": all(c["equal"] for c in service["cases"]),
        "service_reports_auto": service["engine_reply"] == {
            "status": 200, "meta": {"engine": "auto", "shm": True}},
        "service_encode_on_cuda": d.get(
            'cubefs_codec_batch_steps_total{op="encode",engine="cuda"}', 0) > 0,
        "service_launched_a_and_b": d.get(
            'cubefs_codec_kernel_launches_total{kernel="gf_apply"}', 0) > 0
        and d.get('cubefs_codec_kernel_launches_total{kernel="crc32_blocks"}', 0) > 0,
        "server_exit_0": service["server_exit"] == 0,
        "launched_a_only": launches["gf_apply"] > 0
        and all(v == 0 for k, v in launches.items() if k != "gf_apply"),
    }
    return {"phase": "engines", "host": host, "seconds": time.perf_counter() - t_phase,
            "agree": agree, "table": table, "loaded": loaded,
            "device_crossover_bytes": saved["device_crossover_bytes"], "timings": per_size,
            "routes": routes, "drill_warnings": drill_warned, "batcher": batcher,
            "service": service, "launches": launches, "checks": checks}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from cubefs_tpu_torch.codec import codemode as cm
    from cubefs_tpu_torch.codec import crc32block
    from cubefs_tpu_torch.codec import hostio
    from cubefs_tpu_torch.codec.batcher import AdmittedEngine, BatchCodec
    from cubefs_tpu_torch.codec.encoder import CodecConfig, new_encoder
    from cubefs_tpu_torch.codec.engine import CudaEngine
    from cubefs_tpu_torch.models import repair
    from cubefs_tpu_torch.ops import (_build, crc32_kernel, crc_cuda, gf256, gf_bitmajor,
                                      gf_cuda, rs_kernel)
    from cubefs_tpu_torch.parallel import dryrun, launch
    from cubefs_tpu_torch.tuning import gf_tuning
    from cubefs_tpu_torch.utils.benchtime import device_ms, kernel_ms
    from cubefs_tpu_torch.utils.benchtime import timed_ms as time_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    rng = np.random.default_rng(SEED)

    def rand(*shape) -> torch.Tensor:
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)

    # The least time of a function: the larger of its bytes (inputs read
    # once, outputs written once) over the HBM rate and its operations over
    # the peak of their type. A GF(2^8) multiply-add, or one byte's step of
    # a table CRC, has no unit of its own on the card; each is counted as
    # two int8 operations at the int8 peak, which credits the function with
    # the fastest integer rate the card has.
    def bound(nbytes: int, int8_ops: int) -> tuple[float, str]:
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = int8_ops / INT8_OPS_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0

    # -- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    build_s = _build.build()
    ptxas = {}
    for name in build_s:  # one library per source
        log = _build.log_path(name)
        if os.path.exists(log):
            with open(log) as f:
                ptxas[name] = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "per_kernel_s": {k: round(v, 3) for k, v in build_s.items()},
          "ptxas": ptxas, "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0)})

    # -- 2. gf_apply vs plain ------------------------------------------------
    # ms is the whole wrapper call between CUDA events; device_ms the
    # kernel's own time from the profiler's CUDA trace (host excluded),
    # and bound_share is taken from device_ms.
    n, m = 12, 4
    plan = repair.make_plan(n, m, [1, 7])
    step_rows = repair._step_rows(plan)  # recovery + extra-survivor rows, as repair_step applies them
    surviving = rand(4, len(plan.present), SHARD)
    in_place = rand(8, n + m, SHARD)  # encode straight into the stripes' parity rows
    unaligned = rand(3 * (SHARD + 5) + 1)[1:].view(3, 1, SHARD + 5)  # base 1 byte off
    # the LRC and MSR families' shapes of A, each in place where the codec writes in place
    lrc_enc = new_encoder(CodecConfig(cm.CodeMode.EC16P20L2))
    lrc_gf = rand(4, lrc_enc.t.total, SHARD)
    msr_t = cm.tactic(cm.CodeMode.EC6P6MSR)
    msr_k, msr_total, msr_d, alpha = msr_t.n, msr_t.total, msr_t.d, msr_t.alpha
    msr_s = new_encoder(CodecConfig(cm.CodeMode.EC6P6MSR)).shard_size(MSR_PAYLOAD)
    beta = msr_s // alpha
    msr_gf = rand(4, msr_total, msr_s)
    repair_helpers = tuple(range(1, msr_total))
    blob_s = -(-BLOB // n)
    svc_rows = rs_kernel.reconstruct_rows(n, n + m, list(plan.present), [1, 7])
    gf_cases = [  # (label, coeff, shards, out)
        ("repair_rs12p4_bad1_7_B4", step_rows, surviving[:, :n, :], None),
        ("encode_rs12p4_B8", gf256.parity_matrix(n, m), rand(8, n, SHARD), None),
        ("encode_rs12p4_in_place_B8", gf256.parity_matrix(n, m), in_place[:, :n],
         in_place[:, n:]),
        ("encode_rs12p4_ragged_B2", gf256.parity_matrix(n, m), rand(2, n, SHARD + 123), None),
        ("random_36x36_B1", rng.integers(0, 256, (36, 36), dtype=np.uint8), rand(1, 36, SHARD),
         None),
        ("one_row_one_col_ragged_unaligned_B3", rng.integers(1, 256, (1, 1), dtype=np.uint8),
         unaligned, None),
        ("lrc_rows_22x16_EC16P20L2_in_place_B4", lrc_enc._encode_rows, lrc_gf[:, :16],
         lrc_gf[:, 16:]),
        ("msr_encode_36x36_EC6P6MSR_in_place_B4",
         rs_kernel.msr_encode_rows(msr_k, msr_total, msr_d),
         rs_kernel.msr_subshards(msr_gf[:, :msr_k], alpha),
         rs_kernel.msr_subshards(msr_gf[:, msr_k:], alpha)),
        ("msr_helper_1x6_every_node_B4", rs_kernel.msr_helper_rows(msr_k, msr_total, msr_d, 0),
         msr_gf.view(4, msr_total, alpha, beta), None),
        ("msr_repair_6x11_B4",
         rs_kernel.msr_repair_rows(msr_k, msr_total, msr_d, 0, repair_helpers),
         rand(4, msr_d, beta), None),
        # phase service's shapes: 8 MiB blobs (S = 699,051, byte loads) over
        # the HTTP body, 4 MiB shards through /dev/shm; encode, and the rows
        # of shards 1 and 7 for reconstruct
        ("service_encode_S699051_B4", gf256.parity_matrix(n, m), rand(4, n, blob_s), None),
        ("service_reconstruct_2x12_S699051_B4", svc_rows, rand(4, n, blob_s), None),
        ("service_encode_shm_B4", gf256.parity_matrix(n, m), rand(4, n, SHARD), None),
        ("service_reconstruct_shm_2x12_B4", svc_rows, rand(4, n, SHARD), None),
    ]
    coeff_36x36 = gf_cases[4][1]
    gf_results = []
    for label, coeff, x, out in gf_cases:
        r, c = coeff.shape
        s = x.shape[-1]
        b = x.numel() // (c * s)
        w = torch.from_numpy(rs_kernel.coeff_bits(coeff))
        call = functools.partial(gf_cuda.gf_apply, coeff, x, out=out)
        x_before = x.clone() if out is not None else None
        got = call()
        want = rs_kernel.gf_apply_bits(w, x)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        if out is not None:  # written in place, the input rows untouched
            equal = equal and got is out and bool(torch.equal(x, x_before))
        err = max_abs_err(got, want)
        del got, want, x_before
        ms = time_ms(call, KERNEL_REPS)
        dev_ms = device_ms(call, KERNEL_REPS, "gf_apply_kernel")
        plain_ms = time_ms(lambda: rs_kernel.gf_apply_bits(w, x), PLAIN_REPS)
        nbytes = (c + r) * s * b
        bound_ms, bound_by = bound(nbytes, 2 * r * c * s * b)
        res = {"case": label, "R": r, "C": c, "B": b, "S": s, "out_view": out is not None,
               "equal": equal, "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "gib_s": nbytes / (dev_ms / 1e3) / 2**30, "bound_share": bound_ms / dev_ms}
        gf_results.append(res)
        if not equal:
            raise AssertionError(f"gf_apply disagrees with its plain version: {res}")
    emit({"phase": "gf_apply", "cases": gf_results})
    del surviving, gf_cases, in_place, unaligned, lrc_gf, msr_gf

    # -- 3. crc32_blocks vs plain and zlib -------------------------------
    frame_rows = rand(512, 4, 64 << 10)  # blob frames: payloads 4 bytes into their blocks
    crc_cases = [  # (label, blocks)
        ("blocks_10000x128KiB", rand(10000, 128 << 10)),
        ("blob_payloads_2048x65532", rand(2048, (64 << 10) - 4)),
        ("repair_shards_8x4MiB", rand(8, SHARD)),
        ("frame_payload_views_512x4x65532", frame_rows[:, :, 4:]),
        ("odd_blocks_1000x1001", rand(1000, 1001)),
        ("short_blocks_4096x15", rand(4096, 15)),
        ("service_blocks_1024x128KiB", rand(1024, 128 << 10)),
    ]
    crc_results = []
    for label, blocks in crc_cases:
        block_len = blocks.shape[-1]
        b = blocks.numel() // block_len
        got = crc_cuda.crc32_blocks(blocks)
        want = crc32_kernel.crc32_blocks_plain(blocks)
        equal = bool(torch.equal(got, want))
        rows = np.sort(rng.choice(b, size=min(b, 256), replace=False))
        host = blocks.reshape(b, block_len)[torch.from_numpy(rows).to(dev)].cpu().numpy()
        got_rows = got.reshape(b).cpu().numpy()[rows]
        zlib_equal = all(int(g) == zlib.crc32(row.tobytes()) for g, row in zip(got_rows, host))
        err = max_abs_err(got, want)
        del got, want, host
        call = functools.partial(crc_cuda.crc32_blocks, blocks)
        ms = time_ms(call, KERNEL_REPS)
        dev_ms = device_ms(call, KERNEL_REPS, "crc32_span_kernel")
        plain_ms = time_ms(lambda: crc32_kernel.crc32_blocks_plain(blocks), PLAIN_REPS)
        span = crc_cuda.plan(block_len)
        nbytes = b * block_len + 4 * b
        bound_ms, bound_by = bound(nbytes, 2 * b * block_len)
        res = {"case": label, "B": b, "block_len": block_len, "rows": span.rows,
               "n_spans": span.n_spans, "strides": list(blocks.stride()),
               "equal": equal, "zlib_rows_checked": int(len(rows)), "zlib_equal": zlib_equal,
               "max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "gb_s": nbytes / (dev_ms / 1e3) / 1e9, "bound_share": bound_ms / dev_ms}
        crc_results.append(res)
        if not (equal and zlib_equal):
            raise AssertionError(f"crc32_blocks disagrees: {res}")
    emit({"phase": "crc32_blocks", "cases": crc_results})
    del crc_cases, frame_rows
    torch.cuda.empty_cache()

    # -- 4. gf_bitmajor / gf_bitmajor_probe (kernels C, D) vs plain ------
    # Every instantiation: extraction x grid for the apply and nodot, grid
    # for noext (it extracts nothing). The bound is the function's, as for
    # gf_apply; mma_floor_ms is the bit-matrix form's own int8 work,
    # 2 * 8R * 8C * S * B at the int8 peak, which is not a bound. device_ms
    # for the bcast/flat apply and probes of every case and the recorded
    # instantiations; beside each, ptxas' registers of its template
    # instantiation and the blocks an SM holds (the persistent grid is that
    # times the SMs).
    tile = gf_bitmajor.DEFAULT_TILE
    bm_regs = ptxas_registers(_build.log_path("gf_bitmajor"))
    bm_x = rand(4, n, SHARD)
    bm_cases = [
        ("tuning_rows_2x12_B4", np.ascontiguousarray(plan.rows, dtype=np.uint8), bm_x),
        ("repair_step_rows_4x12_B4", step_rows, bm_x),
        ("step_rows_ragged_B2", step_rows, rand(2, n, SHARD + 123)),
        ("random_36x36_B1", coeff_36x36, rand(1, 36, SHARD)),
    ]
    bm_results, bm_bad = [], []
    for label, coeff, x in bm_cases:
        r, c = coeff.shape
        b, s = x.shape[0], x.shape[-1]
        nbytes = (c + r) * s * b
        bound_ms, bound_by = bound(nbytes, 2 * r * c * s * b)
        mma_floor_ms = 2 * 8 * r * 8 * c * s * b / INT8_OPS_PER_S * 1e3
        for probe in (None, "nodot", "noext"):
            want = gf_bitmajor.plain(coeff, x, probe)
            plain_ms = time_ms(lambda: gf_bitmajor.plain(coeff, x, probe), PLAIN_REPS)
            extracts = ("bcast",) if probe == "noext" else ("loop", "bcast", "bool")
            for extract, grid in itertools.product(extracts, gf_bitmajor.GRIDS):
                kw = {"tile": tile, "extract": extract, "grid": grid}
                fn = (functools.partial(gf_bitmajor.bitmajor_apply, coeff, x, **kw)
                      if probe is None else
                      functools.partial(gf_bitmajor.bitmajor_probe, coeff, x, probe=probe, **kw))
                got = fn()
                torch.cuda.synchronize()
                equal = bool(torch.equal(got, want))
                err = max_abs_err(got, want)
                del got
                ms = time_ms(fn, KERNEL_REPS)
                e, p = gf_bitmajor.EXTRACTS[extract], gf_bitmajor.PROBES.get(probe, 0)
                res = {"case": label, "kernel": "gf_bitmajor_probe" if probe else "gf_bitmajor",
                       "extract": extract, "grid": grid, "probe": probe, "tile": tile,
                       "R": r, "C": c, "B": b, "S": s, "equal": equal, "max_abs_err": err,
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "mma_floor_ms": mma_floor_ms,
                       "gib_s": nbytes / (ms / 1e3) / 2**30, "bound_share": bound_ms / ms,
                       "registers": next((v for k, v in bm_regs.items()
                                          if f"gf_bitmajor_kernelILi{e}ELi{p}EE" in k), None),
                       "blocks_per_sm": gf_bitmajor.blocks_per_sm(r, c, tile, extract, probe),
                       "ring_stages": gf_bitmajor.ring_stages(r, c, tile),
                       "smem_bytes": gf_bitmajor.smem_bytes(r, c, tile)}
                if ((extract, grid) == ("bcast", "flat")
                        or (label, extract, probe, grid) in RECORDED_BM):
                    res["device_ms"] = device_ms(fn, KERNEL_REPS, "gf_bitmajor")
                    res["device_bound_share"] = bound_ms / res["device_ms"]
                bm_results.append(res)
                if not equal:
                    bm_bad.append(res)
            del want
    emit({"phase": "gf_bitmajor", "cases": bm_results})
    if bm_bad:
        raise AssertionError(f"bit-matrix kernels disagree with their plain versions: {bm_bad}")
    del bm_x, bm_cases
    torch.cuda.empty_cache()

    # -- 5. the main path, through the entry points --------------------------
    _build.reset_launches()
    t_main = time.perf_counter()
    path = {}

    enc = new_encoder(CodecConfig(cm.CodeMode.EC12P4))
    payload = rng.integers(0, 256, 48 * MIB, dtype=np.uint8).tobytes()
    stripe = enc.split(payload)
    enc.encode(stripe)
    golden = stripe.clone()
    stripe[1] = 0
    stripe[7] = 0
    enc.reconstruct(stripe, [1, 7])
    path["encoder_shape"] = list(stripe.shape)
    path["encoder_verify"] = enc.verify(stripe)
    path["encoder_roundtrip"] = bool(torch.equal(stripe, golden)) and enc.join(
        stripe, len(payload)) == payload
    del stripe, golden

    with open(os.path.join(root, "tests", "fixtures", "rs12p4.bin"), "rb") as f:
        fixture = np.frombuffer(f.read(), dtype=np.uint8).reshape(16, 512)
    fx = torch.zeros((16, 512), dtype=torch.uint8, device=dev)
    fx[:n] = torch.from_numpy(fixture[:n].copy()).to(dev)
    enc.encode(fx)
    path["fixture_parity"] = bool(np.array_equal(fx.cpu().numpy(), fixture))
    fx[[1, 7, 14]] = 0
    enc.reconstruct(fx, [1, 7, 14])
    path["fixture_reconstruct"] = bool(np.array_equal(fx.cpu().numpy(), fixture))

    data = rand(4, n, SHARD)
    stripes = torch.cat([data, enc.engine.encode_parity(data, m)], dim=1)
    surviving = stripes[:, list(plan.present)].contiguous()
    recovered, crcs, ok = repair.repair_step(plan, surviving)
    lost = data[:, [1, 7]].cpu().numpy()
    crcs_host = crcs.cpu().numpy()
    path["repair_recovered"] = bool(torch.equal(recovered, data[:, [1, 7]]))
    path["repair_crcs_zlib"] = all(
        int(crcs_host[i, j]) == zlib.crc32(lost[i, j].tobytes())
        for i in range(lost.shape[0]) for j in range(lost.shape[1]))
    path["repair_ok"] = ok.tolist()
    surviving[2, n + 1, 12345] ^= 0x5A  # bit-rot in an extra survivor of stripe 2
    _, _, ok_bad = repair.repair_step(plan, surviving)
    path["repair_ok_corrupt"] = ok_bad.tolist()
    del data, stripes, surviving, recovered, lost

    frames = np.stack([
        np.frombuffer(crc32block.encode(rng.integers(0, 256, 4 * ((64 << 10) - 4),
                                                     dtype=np.uint8).tobytes()), np.uint8)
        for _ in range(64)])
    frames[5, 3 * (64 << 10) + 100] ^= 1  # a payload byte of frame 5's last block
    valid = crc32block.verify_batch(torch.from_numpy(frames).to(dev)).tolist()
    path["frames_valid"] = valid
    torch.cuda.synchronize()
    path["seconds"] = time.perf_counter() - t_main
    path["launches"] = dict(_build.LAUNCHES)
    emit({"phase": "main_path", **path})

    checks = {
        "encoder_verify": path["encoder_verify"],
        "encoder_roundtrip": path["encoder_roundtrip"],
        "fixture_parity": path["fixture_parity"],
        "fixture_reconstruct": path["fixture_reconstruct"],
        "repair_recovered": path["repair_recovered"],
        "repair_crcs_zlib": path["repair_crcs_zlib"],
        "repair_ok": path["repair_ok"] == [True] * 4,
        "repair_detects_corrupt": path["repair_ok_corrupt"] == [True, True, False, True],
        "frames": valid == [i != 5 for i in range(64)],
        "launched_both_kernels": all(_build.LAUNCHES[k] > 0 for k in MAIN_KERNELS),
        "no_bitmajor_kernel_on_main_path": all(
            v == 0 for k, v in _build.LAUNCHES.items() if k not in MAIN_KERNELS),
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"main path checks failed: {failed}")
    launches = dict(_build.LAUNCHES)

    def plain(coeff: np.ndarray, x: torch.Tensor) -> torch.Tensor:
        return rs_kernel.gf_apply_bits(torch.from_numpy(rs_kernel.coeff_bits(coeff)), x)

    def only_gf_apply(counts: dict[str, int]) -> bool:
        return counts["gf_apply"] > 0 and all(v == 0 for k, v in counts.items() if k != "gf_apply")

    # -- 6. the LRC and MSR codec families, through the entry points --------
    # Every result is held against the plain version on the same inputs, or
    # against stripes that were; any mismatch fails the run.
    _build.reset_launches()
    t_fam = time.perf_counter()
    fam = {}

    # EC16P20L2 (two AZs): 4 stripes of 4 MiB shards from 64 MiB payloads
    lt = lrc_enc.t
    lrc_payloads = rand(4, lt.n * SHARD)
    lrc = torch.stack([lrc_enc.split(p) for p in lrc_payloads])
    before = _build.LAUNCHES["gf_apply"]
    lrc_enc.encode(lrc)
    fam["lrc_encode_launches"] = _build.LAUNCHES["gf_apply"] - before
    fam["lrc_encode_plain"] = bool(torch.equal(
        lrc[:, lt.n:], plain(lrc_enc._encode_rows, lrc[:, :lt.n])))
    fam["lrc_verify"] = lrc_enc.verify(lrc)
    lrc_golden = lrc.clone()
    bad = [1, 7, lt.n + lt.m]  # two data shards and AZ 0's local parity
    lrc[:, bad] = 0
    fam["lrc_verify_damaged"] = lrc_enc.verify(lrc)
    lrc_enc.reconstruct(lrc, bad)
    fam["lrc_reconstruct"] = bool(torch.equal(lrc, lrc_golden))
    fam["lrc_join"] = lrc_enc.join(lrc[0], lt.n * SHARD) == lrc_payloads[0].cpu().numpy().tobytes()
    idx, _, _ = lt.local_stripe_in_az(1)
    local = lrc_golden[:, idx].clone()  # a bare local stripe, one shard lost
    local[:, 3] = 0
    lrc_enc.reconstruct(local, [3])
    fam["lrc_local_stripe_repair"] = (bool(torch.equal(local, lrc_golden[:, idx]))
                                      and lrc_enc.verify(local))
    rows = lrc_golden[:, : lt.n + lt.m].clone()  # the degraded GET's (N+M) rows
    rows[:, [0, lt.n - 1]] = 0
    lrc_enc.reconstruct_data(rows, [0, lt.n - 1])
    fam["lrc_reconstruct_data_global_rows"] = bool(torch.equal(rows, lrc_golden[:, : lt.n + lt.m]))
    del lrc, lrc_golden, local, rows, lrc_payloads
    with open(os.path.join(root, "tests", "fixtures", "ec16p20l2.bin"), "rb") as f:
        lrc_fixture = np.frombuffer(f.read(), dtype=np.uint8).reshape(lt.total, 512)
    fx = torch.zeros((lt.total, 512), dtype=torch.uint8, device=dev)
    fx[: lt.n] = torch.from_numpy(lrc_fixture[: lt.n].copy()).to(dev)
    lrc_enc.encode(fx)
    fam["lrc_fixture_parity"] = bool(np.array_equal(fx.cpu().numpy(), lrc_fixture))

    # EC6P6MSR (three AZs, d = 11): 4 stripes from 24 MiB payloads
    msr_enc = new_encoder(CodecConfig(cm.CodeMode.EC6P6MSR))
    msr_payloads = rand(4, MSR_PAYLOAD)
    msr = torch.stack([msr_enc.split(p) for p in msr_payloads])
    before = _build.LAUNCHES["gf_apply"]
    msr_enc.encode(msr)
    fam["msr_encode_launches"] = _build.LAUNCHES["gf_apply"] - before
    fam["msr_shard"] = [msr_s, beta]
    fam["msr_encode_plain"] = bool(torch.equal(
        rs_kernel.msr_subshards(msr[:, msr_k:], alpha),
        plain(rs_kernel.msr_encode_rows(msr_k, msr_total, msr_d),
              rs_kernel.msr_subshards(msr[:, :msr_k], alpha))))
    fam["msr_verify"] = msr_enc.verify(msr)
    msr_golden = msr.clone()
    msr_bad = sorted(rng.choice(msr_total, msr_total - msr_k, replace=False).tolist())
    msr[:, msr_bad] = 0
    msr_enc.reconstruct(msr, msr_bad)
    fam["msr_reconstruct_bad"] = msr_bad
    fam["msr_reconstruct"] = bool(torch.equal(msr, msr_golden))
    fam["msr_join"] = all(msr_enc.join(msr[i], MSR_PAYLOAD)
                          == msr_payloads[i].cpu().numpy().tobytes() for i in range(4))
    del msr, msr_payloads

    def repair_every_slot(enc_, stripes: torch.Tensor, with_verify: bool) -> dict[str, bool]:
        """Each slot lost in turn: d helper symbols (one apply of the
        helper row over every node) rebuild it through msr_repair_shard;
        with an extra survivor, its verify row predicts that survivor's
        symbol, and one corrupted helper symbol must break the prediction
        of its stripe only."""
        t = enc_.t
        b_, s_ = stripes.shape[0], stripes.shape[-1]
        nodes = stripes.view(b_, t.total, t.alpha, s_ // t.alpha)
        out = {"rebuilt": True, "plain": True, "predicted": True, "corrupt_caught": True}
        for failed in range(t.total):
            order = [i for i in range(t.total) if i != failed]
            helpers = tuple(order[: t.d])
            row = rs_kernel.msr_helper_rows(t.n, t.total, t.d, failed)
            syms = rs_kernel.gf_matrix_apply(row, nodes)[:, :, 0]
            payloads = syms[:, list(helpers)]
            rebuilt = rs_kernel.msr_repair_shard(payloads, t.n, t.total, t.d, failed, helpers)
            out["rebuilt"] &= bool(torch.equal(rebuilt, stripes[:, failed]))
            rep = rs_kernel.msr_repair_rows(t.n, t.total, t.d, failed, helpers)
            out["plain"] &= (bool(torch.equal(syms, plain(row, nodes)[:, :, 0]))
                             and bool(torch.equal(rebuilt, plain(rep, payloads).view(b_, s_))))
            if with_verify:
                extra = order[t.d]
                vrow = rs_kernel.msr_verify_rows(t.n, t.total, t.d, failed, helpers, extra)
                pred = rs_kernel.gf_matrix_apply(vrow, payloads)[:, 0]
                out["predicted"] &= (bool(torch.equal(pred, syms[:, extra]))
                                     and bool(torch.equal(pred, plain(vrow, payloads)[:, 0])))
                payloads[2, failed % t.d, (s_ // t.alpha) // 2] ^= 0x5A
                pred = rs_kernel.gf_matrix_apply(vrow, payloads)[:, 0]
                out["corrupt_caught"] &= [bool(torch.equal(pred[i], syms[i, extra]))
                                          for i in range(b_)] == [True, True, False, True]
        return out

    fam["msr_repair_EC6P6MSR_d11"] = repair_every_slot(msr_enc, msr_golden, False)
    del msr_golden
    one_az_enc = new_encoder(CodecConfig(cm.CodeMode.EC6P6MSROneAZ))
    one_az = torch.stack([one_az_enc.split(p) for p in rand(4, MSR_PAYLOAD)])
    one_az_enc.encode(one_az)
    fam["msr_repair_EC6P6MSROneAZ_d10"] = repair_every_slot(one_az_enc, one_az, True)
    del one_az
    torch.cuda.synchronize()
    fam["seconds"] = time.perf_counter() - t_fam
    fam["launches"] = dict(_build.LAUNCHES)
    emit({"phase": "codec_families", **fam})
    fam_checks = {
        "lrc_encode_one_launch": fam["lrc_encode_launches"] == 1,
        "lrc_encode_plain": fam["lrc_encode_plain"],
        "lrc_verify": fam["lrc_verify"] and not fam["lrc_verify_damaged"],
        "lrc_reconstruct": fam["lrc_reconstruct"],
        "lrc_join": fam["lrc_join"],
        "lrc_local_stripe_repair": fam["lrc_local_stripe_repair"],
        "lrc_reconstruct_data_global_rows": fam["lrc_reconstruct_data_global_rows"],
        "lrc_fixture_parity": fam["lrc_fixture_parity"],
        "msr_encode_one_launch": fam["msr_encode_launches"] == 1,
        "msr_encode_plain": fam["msr_encode_plain"],
        "msr_verify": fam["msr_verify"],
        "msr_reconstruct": fam["msr_reconstruct"],
        "msr_join": fam["msr_join"],
        **{f"{k}.{c}": v for k in ("msr_repair_EC6P6MSR_d11", "msr_repair_EC6P6MSROneAZ_d10")
           for c, v in fam[k].items()},
        "launched_only_gf_apply": only_gf_apply(fam["launches"]),
    }
    failed = [k for k, v in fam_checks.items() if not v]
    if failed:
        raise AssertionError(f"codec family checks failed: {failed}")

    # -- 7. the codec batcher: concurrent small PUTs and an MSR mix --------
    # 32 threads each admit 8 EC12P4 encodes of 1 MiB payloads before
    # collecting them, as the blob access layer's concurrent PUTs do; every
    # fourth thread also admits two EC6P6MSR encodes (another key). Then
    # the same threads with payloads of mixed sizes: the batcher coalesces
    # only submissions of one shard size S, so that run shows what it does
    # with traffic it cannot coalesce. Every stripe's parity is held against
    # the plain version and against a launch of its own.
    _build.reset_launches()
    bc = BatchCodec(enabled=True)
    put_enc = new_encoder(CodecConfig(cm.CodeMode.EC12P4))
    put_enc.engine = AdmittedEngine(bc, dev)
    mix_enc = new_encoder(CodecConfig(cm.CodeMode.EC6P6MSR))
    mix_enc.engine = AdmittedEngine(bc, dev)
    n_threads, per_thread, mix_per = 32, 8, 2
    n_puts = n_threads * per_thread
    put_rows = gf256.parity_matrix(n, m)
    msr_rows = rs_kernel.msr_encode_rows(msr_k, msr_total, msr_d)

    def run_puts(payloads: list, mix_payloads: list) -> tuple[list, list, float]:
        """32 threads admit their PUTs (and the MSR mix) and collect them."""
        stripes, mixed = [None] * len(payloads), [None] * len(mix_payloads)
        start = threading.Barrier(n_threads)

        def worker(i: int) -> None:
            start.wait(60.0)
            pending = []
            for j in range(per_thread):
                k = i * per_thread + j
                stripes[k] = put_enc.split(payloads[k])
                pending.append(put_enc.encode_async(stripes[k]))
                if len(mix_payloads) and i % 4 == 0 and j < mix_per:
                    q = i // 4 * mix_per + j
                    mixed[q] = mix_enc.split(mix_payloads[q])
                    pending.append(mix_enc.encode_async(mixed[q]))
            for p in pending:
                p.wait()

        t = time.perf_counter()
        with ThreadPoolExecutor(n_threads) as pool:
            for f in [pool.submit(worker, i) for i in range(n_threads)]:
                f.result()  # re-raises a worker's failure
        torch.cuda.synchronize()
        return stripes, mixed, time.perf_counter() - t

    def equals_plain(rows: np.ndarray, xs: list, ys: list) -> bool:
        """ys[i] == plain(rows, xs[i]) for every stripe, 32 at a time."""
        return all(bool(torch.equal(torch.stack(ys[i:i + 32]),
                                    plain(rows, torch.stack(xs[i:i + 32]))))
                   for i in range(0, len(xs), 32))

    def puts_hold(stripes: list) -> dict[str, bool]:
        by_s = {}  # the plain version takes one S at a time
        for st in stripes:
            by_s.setdefault(st.shape[-1], []).append(st)
        return {
            "plain": all(equals_plain(put_rows, [st[:n] for st in g], [st[n:] for st in g])
                         for g in by_s.values()),
            "unbatched": all(bool(torch.equal(st[n:], rs_kernel.encode_parity(st[:n], m)))
                             for st in stripes)}

    put_stripes, mix_stripes, secs = run_puts(
        rand(n_puts, PUT), rand(n_threads // 4 * mix_per, PUT))
    bat = {"seconds": secs, "threads": n_threads, "submissions": bc.submissions,
           "steps": bc.steps, "put_shard": put_enc.shard_size(PUT),
           "launches": dict(_build.LAUNCHES)}
    bat["puts"] = puts_hold(put_stripes)
    bat["msr_mix"] = {
        "plain": equals_plain(msr_rows,
                              [rs_kernel.msr_subshards(st[:msr_k], alpha) for st in mix_stripes],
                              [rs_kernel.msr_subshards(st[msr_k:], alpha) for st in mix_stripes]),
        "unbatched": all(bool(torch.equal(
            st[msr_k:], rs_kernel.msr_encode_parity(st[:msr_k], msr_k, msr_total, msr_d)))
            for st in mix_stripes)}
    n_uniform = len(put_stripes) + len(mix_stripes)
    del put_stripes, mix_stripes
    sizes = rng.integers(PUT // 2, 2 * PUT + 1, n_puts)
    before = (bc.submissions, bc.steps)
    mixed_stripes, _, secs = run_puts([rand(int(z)) for z in sizes], [])
    bat["mixed_sizes"] = {
        "seconds": secs, "submissions": bc.submissions - before[0],
        "steps": bc.steps - before[1],
        "distinct_s": len({put_enc.shard_size(int(z)) for z in sizes}),
        **puts_hold(mixed_stripes)}
    bat["queues_left"] = len(bc._queues)  # an idle key's queue is dropped
    st = put_enc.split(rand(PUT))
    data = st[:n].clone()
    before = _build.LAUNCHES["gf_apply"]
    put_enc.encode(st)  # uncontended: one launch, parity written into the stripe
    bat["uncontended_launches"] = _build.LAUNCHES["gf_apply"] - before
    bat["uncontended_plain"] = (bool(torch.equal(st[:n], data)) and bool(
        torch.equal(st[n:], plain(put_rows, data))))
    bat["launches_all_runs"] = dict(_build.LAUNCHES)
    emit({"phase": "batcher", **bat})
    mx = bat["mixed_sizes"]
    bat_checks = {
        **{f"{run}.{c}": v for run in ("puts", "msr_mix") for c, v in bat[run].items()},
        "mixed_sizes.plain": mx["plain"],
        "mixed_sizes.unbatched": mx["unbatched"],
        "all_submitted": bat["submissions"] == n_uniform and mx["submissions"] == n_puts,
        "fewer_steps_than_submissions": 0 < bat["steps"] < bat["submissions"],
        "mixed_sizes_at_most_a_step_each": mx["distinct_s"] <= mx["steps"] <= n_puts,
        "idle_queues_dropped": bat["queues_left"] == 0,
        "uncontended_encode_one_launch": bat["uncontended_launches"] == 1
        and bat["uncontended_plain"],
        "launched_only_gf_apply": only_gf_apply(bat["launches_all_runs"]),
    }
    failed = [k for k, v in bat_checks.items() if not v]
    if failed:
        raise AssertionError(f"batcher checks failed: {failed}")
    del mixed_stripes
    torch.cuda.empty_cache()

    # -- 8. the entry points end to end, timed ------------------------------
    # Each ms covers the whole call (host work, kernels, views, compares).
    e2e = []

    # Beside the whole call, the device time of each kernel it ran (from
    # the profiler's CUDA trace), their sum, and the share of the call the
    # device was busy.
    def e2e_case(label: str, fn, moved: int, least: int) -> None:
        ms = time_ms(fn, KERNEL_REPS)
        kernels = kernel_ms(fn, KERNEL_REPS)
        busy_ms = sum(kernels.values())
        bound_ms = least / HBM_BYTES_PER_S * 1e3
        e2e.append({"case": label, "ms": ms, "gib_s": moved / (ms / 1e3) / 2**30,
                    "bound_ms": bound_ms, "bound_share": bound_ms / ms,
                    "device_ms": busy_ms, "device_busy_share": busy_ms / ms,
                    "kernels_ms": {name[:80]: t for name, t in
                                   sorted(kernels.items(), key=lambda kv: -kv[1])}})

    stripes = rand(8, n + m, SHARD)
    e2e_case("Encoder.encode_EC12P4_B8", lambda: enc.encode(stripes),
             moved=8 * n * SHARD, least=8 * (n + m) * SHARD)
    # the same launch without the admission layer: the difference is what
    # the batcher costs an uncontended caller
    raw = CudaEngine(dev)
    e2e_case("CudaEngine.encode_parity_EC12P4_B8_unadmitted",
             lambda: raw.encode_parity(stripes[:, :n], m, out=stripes[:, n:]),
             moved=8 * n * SHARD, least=8 * (n + m) * SHARD)
    del stripes
    data = rand(4, n, SHARD)
    surviving = torch.cat([data, rs_kernel.encode_parity(data, m)], dim=1)[:, list(plan.present)]
    surviving = surviving.contiguous()
    w = len(plan.wanted)
    e2e_case("repair_step_rs12p4_bad1_7_B4", lambda: repair.repair_step(plan, surviving),
             moved=surviving.numel(), least=(len(plan.present) + w) * SHARD * 4)
    del data, surviving
    many = torch.from_numpy(frames).to(dev).repeat(16, 1)  # 1024 frames of 4 blocks
    e2e_case("verify_batch_1024x256KiB", lambda: crc32block.verify_batch(many),
             moved=many.numel(), least=many.numel())
    del many
    stripes = rand(4, lt.total, SHARD)
    e2e_case("LrcEncoder.encode_EC16P20L2_B4", lambda: lrc_enc.encode(stripes),
             moved=4 * lt.n * SHARD, least=4 * lt.total * SHARD)
    stripes = rand(4, msr_total, msr_s)
    e2e_case("MsrEncoder.encode_EC6P6MSR_B4", lambda: msr_enc.encode(stripes),
             moved=4 * msr_k * msr_s, least=4 * msr_total * msr_s)
    del stripes
    ot = one_az_enc.t
    one_az_s = one_az_enc.shard_size(MSR_PAYLOAD)
    payloads = rand(4, ot.d, one_az_s // ot.alpha)
    helpers = tuple(range(1, ot.d + 1))
    e2e_case("msr_repair_shard_EC6P6MSROneAZ_B4",
             lambda: rs_kernel.msr_repair_shard(payloads, ot.n, ot.total, ot.d, 0, helpers),
             moved=payloads.numel(), least=payloads.numel() + 4 * one_az_s)
    del payloads
    # the same 48 PUT-sized encodes through the batcher and as 48 launches
    # one by one, parity written into each caller's stripe: 1 MiB each (one
    # S, one coalesced step), then of mixed sizes (an S each, a step each)
    e2e_bc = BatchCodec(enabled=True)
    put_s = put_enc.shard_size(PUT)
    mixed_s = [put_enc.shard_size(int(z)) for z in rng.integers(PUT // 2, 2 * PUT + 1, 48)]
    for tag, shard_sizes, want_steps in (("1MiB", [put_s] * 48, 1),
                                         ("mixed_sizes", mixed_s, len(set(mixed_s)))):
        puts = [rand(1, n + m, z) for z in shard_sizes]

        def admitted(puts=puts):
            futs = [e2e_bc.submit_encode_async(dev, p[:, :n], m, out=p[:, n:]) for p in puts]
            for f in futs:
                f.result()

        def one_by_one(puts=puts):
            for p in puts:
                rs_kernel.encode_parity(p[:, :n], m, out=p[:, n:])

        steps = e2e_bc.steps
        admitted()
        got = [p[:, n:].clone() for p in puts]
        one_by_one()
        if e2e_bc.steps != steps + want_steps or not all(
                bool(torch.equal(g, p[:, n:])) and bool(torch.equal(g, plain(put_rows, p[:, :n])))
                for g, p in zip(got, puts)):
            raise AssertionError(f"the batcher's steps ({tag}) disagree with the launches one "
                                 f"by one or the plain version")
        moved = sum(n * z for z in shard_sizes)
        for label, fn in ((f"batcher_EC12P4_{tag}_x48", admitted),
                          (f"one_by_one_EC12P4_{tag}_x48", one_by_one)):
            e2e_case(label, fn, moved=moved, least=moved * (n + m) // n)
        del puts, got
    emit({"phase": "end_to_end", "cases": e2e})

    # -- 9. the GF tuning path: both rounds of tuning/gf_tuning.py ----------
    _build.reset_launches()
    tuning = {}
    for round_ in (1, 2):
        records = gf_tuning.sweep(round_, dev)
        best = gf_tuning.best(records)
        tuning[round_] = records
        emit({"phase": "gf_tuning", "round": round_, "records": records, "best": best})
        print("BEST:", json.dumps(best), flush=True)
        errors = [rec for rec in records if "error" in rec]
        if errors or best is None:
            raise AssertionError(f"tuning round {round_} had failing variants: {errors}")
    tuning_launches = dict(_build.LAUNCHES)
    if not (tuning_launches["gf_bitmajor"] > 0 and tuning_launches["gf_bitmajor_probe"] > 0):
        raise AssertionError(f"the tuning path did not launch both bit-matrix kernels: "
                             f"{tuning_launches}")

    # -- 10. the codec service: the codec role, driven over its wire --------
    # The server runs as its users start it, a process of its own on the
    # card. This process drives it with http.client as the native client
    # does (a connection a call, no body CRC) and holds every reply exactly
    # against the plain versions on the card and zlib. ms: the whole RPC on
    # the client's clock, median of SERVICE_REPS after one checked call.
    # The server's device time for a case: its kernel's device_ms at the
    # same shape (phases gf_apply and crc32_blocks, from the profiler) and
    # the copies in and out (codec/hostio.py) between CUDA events in this
    # process on the same request. (Profiler traces taken this late in the
    # run lost the first record of most sessions, in a probe and in this
    # phase, so none is taken here.) Launches: the server's
    # cubefs_codec_kernel_launches_total, read from its /metrics.
    torch.cuda.empty_cache()
    t_svc = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="cubefs-smoke-")
    proc, addr = start_server(root, SERVICE_CFG, workdir)
    svc_cases, shm_paths = [], []
    kernel_case = {r["case"]: r for r in gf_results + crc_results}

    def server_launches() -> dict[str, int]:
        got = scrape(addr)
        return {k: int(got.get(f'cubefs_codec_kernel_launches_total{{kernel="{k}"}}', 0))
                for k in _build.KERNELS}

    def svc_case(label: str, method: str, args: dict, body: bytes, moved: int, check,
                 kernel: str | None, y: torch.Tensor, src, shape: tuple, out=None) -> None:
        """One checked call, then SERVICE_REPS timed ones; the device time
        of the ``kernel`` case at its shape, and the service's copy in
        (``src`` to ``shape``) and copy out (of its result ``y``, into
        ``out`` or a new pinned tensor) in this process."""
        before = server_launches()
        status, meta, payload = rpc_post(addr, method, args, body)
        ok = status == 200 and bool(check(meta, payload))
        times = []
        for _ in range(SERVICE_REPS):
            t = time.perf_counter()
            ok = rpc_post(addr, method, args, body)[0] == 200 and ok
            times.append((time.perf_counter() - t) * 1e3)
        after = server_launches()
        ms = statistics.median(times)
        res = {"case": label, "method": method, "args": {k: v for k, v in args.items()
                                                         if k != "shm"},
               "bytes_in": moved, "equal": ok, "ms": ms, "ms_runs": times,
               "gib_s": moved / (ms / 1e3) / 2**30, "calls": 1 + SERVICE_REPS,
               "launches": {k: after[k] - before[k] for k in after if after[k] != before[k]},
               "to_device_ms": time_ms(lambda: hostio.to_device(src, shape, dev), KERNEL_REPS),
               "to_host_ms": time_ms(lambda: hostio.to_host(y, out=out), KERNEL_REPS)}
        if kernel is not None:
            k = kernel_case[kernel]
            res.update({"kernel_case": kernel, "kernel_device_ms": k["device_ms"],
                        "kernel_bound_ms": k["bound_ms"], "kernel_bound_share": k["bound_share"]})
        svc_cases.append(res)

    def to_bytes(x: torch.Tensor) -> bytes:
        return x.cpu().numpy().tobytes()

    def shm_file(nbytes: int, data: bytes) -> str:
        fd, path = tempfile.mkstemp(prefix="cubefs-codec-", dir="/dev/shm")
        shm_paths.append(path)
        os.ftruncate(fd, nbytes)
        os.close(fd)
        mm = shm_view(path)
        mm[: len(data)] = np.frombuffer(data, np.uint8)
        mm.flush()
        return path

    def shm_view(path: str) -> np.memmap:
        return np.memmap(path, dtype=np.uint8, mode="r+")

    def shm_tail(path: str, nbytes: int) -> bytes:
        with open(path, "rb") as f:
            f.seek(-nbytes, os.SEEK_END)
            return f.read()

    try:
        # encode and reconstruct of 8 MiB blobs over the HTTP body, B = 4
        enc_rows = gf256.parity_matrix(n, m)
        blob = rand(4, n + m, blob_s)
        blob[:, n:] = plain(enc_rows, blob[:, :n])
        data_b = to_bytes(blob[:, :n])
        geo = {"n": n, "m": m, "shard_size": blob_s, "batch": 4}
        want = to_bytes(blob[:, n:])
        svc_case("encode_EC12P4_8MiB_blobs_B4", "encode", geo, data_b, len(data_b),
                 lambda meta, p: meta == {"shape": [4, m, blob_s]} and p == want,
                 "service_encode_S699051_B4", blob[:, n:].contiguous(), data_b, (4, n, blob_s))
        present = list(plan.present)
        rec_args = {"n": n, "total": n + m, "present": present, "wanted": [1, 7],
                    "shard_size": blob_s, "batch": 4}
        surv = blob[:, present[:n]].contiguous()
        want_rec = to_bytes(plain(svc_rows, surv))
        lost = to_bytes(blob[:, [1, 7]])
        surv_b = to_bytes(surv)
        svc_case("reconstruct_EC12P4_8MiB_blobs_bad1_7_B4", "reconstruct", rec_args, surv_b,
                 surv.numel(), lambda meta, p: meta == {"shape": [4, 2, blob_s]}
                 and p == want_rec == lost, "service_reconstruct_2x12_S699051_B4",
                 blob[:, [1, 7]], surv_b, surv.shape)
        vstripes = blob.clone()
        vstripes[1, n + 2, blob_s // 3] ^= 0x5A
        vplain = [bool(torch.equal(plain(enc_rows, vstripes[i:i + 1, :n]), vstripes[i:i + 1, n:]))
                  for i in range(4)]
        vs_b = to_bytes(vstripes)
        svc_case("verify_EC12P4_8MiB_blobs_B4_one_corrupt", "verify", geo, vs_b,
                 vstripes.numel(), lambda meta, p: meta == {"ok": vplain}
                 and vplain == [True, False, True, True],
                 "service_encode_S699051_B4", torch.zeros(4, dtype=torch.bool, device=dev),
                 vs_b, vstripes.shape)
        del blob, surv, vstripes, data_b, surv_b, vs_b

        # the same math through /dev/shm, 4 MiB shards, B = 4
        need = 4 * (n + m) * SHARD
        shm_fs = os.statvfs("/dev/shm")
        free = shm_fs.f_bavail * shm_fs.f_frsize
        if free < need:
            raise AssertionError(f"/dev/shm has {free} bytes free; the shm cases need {need}")
        x = rand(4, n, SHARD)
        want = to_bytes(plain(enc_rows, x))
        path = shm_file(need, to_bytes(x))
        mm = shm_view(path)
        svc_case("encode_shm_EC12P4_4MiB_B4", "encode_shm",
                 {"n": n, "m": m, "shard_size": SHARD, "batch": 4, "shm": path}, b"", x.numel(),
                 lambda meta, p: meta == {"shape": [4, m, SHARD], "offset": x.numel()}
                 and shm_tail(path, len(want)) == want,
                 "service_encode_shm_B4", plain(enc_rows, x), mm[:x.numel()], x.shape,
                 mm[x.numel():])
        del mm
        os.unlink(path)
        want = to_bytes(plain(svc_rows, x))
        path = shm_file(4 * (n + 2) * SHARD, to_bytes(x))
        mm = shm_view(path)
        svc_case("reconstruct_shm_EC12P4_4MiB_bad1_7_B4", "reconstruct_shm",
                 dict(rec_args, shard_size=SHARD, shm=path), b"", x.numel(),
                 lambda meta, p: meta == {"shape": [4, 2, SHARD], "offset": x.numel()}
                 and shm_tail(path, len(want)) == want,
                 "service_reconstruct_shm_2x12_B4", plain(svc_rows, x), mm[:x.numel()],
                 x.shape, mm[x.numel():])
        del mm
        os.unlink(path)
        del x

        # CRCs: datanode packets, and odd rows on B's byte path
        for label, blocks, kernel in (
                ("crc32_1024x128KiB", rand(1024, 128 << 10), "service_blocks_1024x128KiB"),
                ("crc32_1000x1001", rand(1000, 1001), "odd_blocks_1000x1001")):
            b_, block_len = blocks.shape
            body = to_bytes(blocks)
            want_crc = crc32_kernel.crc32_blocks_plain(blocks).cpu().numpy().astype("<u4")
            zl = np.asarray([zlib.crc32(body[i * block_len:(i + 1) * block_len])
                             for i in range(b_)], dtype="<u4")
            svc_case(label, "crc32", {"block_len": block_len}, body, len(body),
                     lambda meta, p, b_=b_, w=want_crc, z=zl: meta == {"count": b_}
                     and p == w.tobytes() == z.tobytes() and int(z.max()) >= 1 << 31,
                     kernel, crc32_kernel.crc32_blocks_plain(blocks), body, blocks.shape)
            del blocks, body

        # 32 threads x 8 encodes of a 1 MiB blob each, all at once
        n_threads, per_thread = 32, 8
        small_s = -(-PUT // n)
        small = rand(n_threads * per_thread, n, small_s)
        small_want = [to_bytes(plain(enc_rows, small[i:i + 32])) for i in range(0, len(small), 32)]
        small_want = [w[j * m * small_s:(j + 1) * m * small_s]
                      for w in small_want for j in range(32)]
        bodies = [to_bytes(small[i]) for i in range(len(small))]
        replies, call_ms = [None] * len(bodies), [0.0] * len(bodies)
        start = threading.Barrier(n_threads)
        small_args = {"n": n, "m": m, "shard_size": small_s}

        def client(i: int) -> None:
            start.wait(60.0)
            for j in range(per_thread):
                k = i * per_thread + j
                t = time.perf_counter()
                replies[k] = rpc_post(addr, "encode", small_args, bodies[k])
                call_ms[k] = (time.perf_counter() - t) * 1e3

        keys = {"steps": 'cubefs_codec_batch_steps_total{op="encode",engine="cuda"}',
                "submissions": 'cubefs_codec_batch_submissions_total{op="encode"}',
                "bytes": 'cubefs_codec_bytes_total{op="encode",engine="cuda"}',
                "launches": 'cubefs_codec_kernel_launches_total{kernel="gf_apply"}'}
        m0 = scrape(addr)
        t = time.perf_counter()
        with ThreadPoolExecutor(n_threads) as pool:
            for f in [pool.submit(client, i) for i in range(n_threads)]:
                f.result()
        wall = time.perf_counter() - t
        m1 = scrape(addr)
        conc = {k: m1.get(v, 0.0) - m0.get(v, 0.0) for k, v in keys.items()}
        sent = sum(len(b) for b in bodies)
        conc.update({
            "threads": n_threads, "calls": len(bodies), "shard_size": small_s,
            "bytes_sent": sent, "seconds": wall, "gib_s": sent / wall / 2**30,
            "ms": statistics.median(call_ms), "ms_max": max(call_ms),
            "equal": all(r == (200, {"shape": [1, m, small_s]}, w)
                         for r, w in zip(replies, small_want))})
        conc["held"] = (conc["equal"] and conc["submissions"] == len(bodies)
                        and 0 < conc["steps"] < conc["submissions"]
                        and conc["bytes"] == sent and conc["launches"] == conc["steps"])
        del small, small_want, bodies, replies

        # refusals: the server says no, and touches nothing
        refusals = {
            "unsorted_present": rpc_post(addr, "reconstruct",
                                         dict(rec_args, present=present[::-1]))[:2],
            "shm_path_escape": rpc_post(addr, "encode_shm", dict(
                geo, shm="/dev/shm/cubefs-codec-x/../../etc/passwd"))[:2],
            "shm_outside_prefix": rpc_post(addr, "encode_shm", dict(geo, shm="/etc/passwd"))[:2],
            "body_crc_mismatch": rpc_post(addr, "crc32", {"block_len": 4}, bytes(8),
                                          {"X-Rpc-Crc": "1"})[:2],
        }
        svc_launches = server_launches()
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            server_exit = proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)
            server_exit = None
        for path in shm_paths:
            if os.path.exists(path):
                os.unlink(path)
        shutil.rmtree(workdir, ignore_errors=True)
    service = {"server": addr, "seconds": time.perf_counter() - t_svc, "cases": svc_cases,
               "concurrency": conc, "refusals": refusals, "launches": svc_launches,
               "server_exit": server_exit}
    emit({"phase": "service", **service})
    svc_checks = {
        **{f"{c['case']}.equal": c["equal"] for c in svc_cases},
        "concurrency": conc["held"],
        "refusals_400": all(st_ == 400 for st_, _ in refusals.values()),
        "launched_a_and_b_only": (svc_launches["gf_apply"] > 0 and svc_launches["crc32_blocks"] > 0
                                  and all(v == 0 for k, v in svc_launches.items()
                                          if k not in MAIN_KERNELS)),
        "server_exit_0": server_exit == 0,
    }
    failed = [k for k, v in svc_checks.items() if not v]
    if failed:
        raise AssertionError(f"service checks failed: {failed}")

    # -- 11. the codec engine layer: host legs, XOR programs, auto ---------
    # Counts from 0 (this process's): A only. The second codec role's
    # launches come from its /metrics.
    torch.cuda.empty_cache()
    eng_phase = engines_phase(root, dev, card)
    emit(eng_phase)
    failed = [k for k, v in eng_phase["checks"].items() if not v]
    if failed:
        raise AssertionError(f"engines checks failed: {failed}")

    # -- 12. the sharded step: 8 ranks over torch.distributed ----------------
    # Built above, in this process: the ranks find the libraries and run
    # no nvcc. Every rank runs A and B on its own block; the collectives
    # go through gloo, which stages CUDA buffers through host memory and
    # lets the 8 ranks share one card (NCCL does not); NCCL only where 8
    # cards are visible. Every block of every result is held exactly
    # against the plain version, the single-rank path, the lost shards
    # and zlib in the rank, and each rank's partial applies against the
    # plain version on the same block.
    torch.cuda.empty_cache()
    world = 8
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    t_sh = time.perf_counter()
    ranks = launch.launch(dryrun.multichip, world, backend=backend, device=None,
                          args=(SHARDED_RUNS, KERNEL_REPS), deadline=480.0, timeout=300.0)
    sharded = [sharded_summary(run, [r.result[i] for r in ranks])
               for i, run in enumerate(SHARDED_RUNS)]
    emit({"phase": "sharded", "backend": backend, "world": world,
          "seconds": time.perf_counter() - t_sh, "runs": sharded})
    sh_bad = [res for res in sharded if not res["held"]]
    if sh_bad:
        raise AssertionError(f"sharded step checks failed: {sh_bad}")

    # -- 13. the kernels' record --------------------------------------------
    gf_main, crc_main = gf_results[0], crc_results[0]
    bm_main, probe_main = (next(x for x in bm_results
                                if (x["case"], x["extract"], x["probe"], x["grid"]) == key)
                           for key in RECORDED_BM)
    emit({"kernels": [
        {"name": "gf_apply", "route": "cuda", "source": "cubefs_tpu_torch/csrc/gf_apply.cu",
         "replaces": "cubefs_tpu/ops/pallas_gf.py:46", "shape": gf_main["case"],
         "launches": launches["gf_apply"], "service_launches": svc_launches["gf_apply"],
         "engines_launches": eng_phase["launches"]["gf_apply"],
         "equal": gf_main["equal"],
         "max_abs_err": gf_main["max_abs_err"], "ms": gf_main["ms"],
         "device_ms": gf_main["device_ms"], "plain_ms": gf_main["plain_ms"],
         "bound_ms": gf_main["bound_ms"],
         "bound_by": gf_main["bound_by"], "library_ms": None},
        {"name": "crc32_blocks", "route": "cuda",
         "source": "cubefs_tpu_torch/csrc/crc32_blocks.cu",
         "replaces": "cubefs_tpu/ops/pallas_crc.py:44", "shape": crc_main["case"],
         "launches": launches["crc32_blocks"],
         "service_launches": svc_launches["crc32_blocks"], "equal": crc_main["equal"],
         "max_abs_err": crc_main["max_abs_err"], "ms": crc_main["ms"],
         "device_ms": crc_main["device_ms"], "plain_ms": crc_main["plain_ms"],
         "bound_ms": crc_main["bound_ms"],
         "bound_by": crc_main["bound_by"], "library_ms": None},
        *({"name": rec["kernel"], "route": "cuda",
           "source": "cubefs_tpu_torch/csrc/gf_bitmajor.cu", "replaces": replaces,
           "shape": f'{rec["case"]} {rec["extract"]}/{rec["grid"]}/{rec["probe"]} tile {tile}',
           "path": "gf_tuning", "launches": tuning_launches[rec["kernel"]],
           "equal": rec["equal"], "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
           "device_ms": rec["device_ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
           "bound_by": rec["bound_by"], "library_ms": None}
          for rec, replaces in ((bm_main, "benchmarks/pallas_tuning.py:41"),
                                (probe_main, "benchmarks/pallas_tuning2.py:56"))),
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
