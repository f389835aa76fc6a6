#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port, ``cubefs_tpu_torch``.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout,
holds each against its plain PyTorch version at the width of the
production EC12P4 codemode (RS(12+4), 4 MiB shards) and on the edges
of their designs (ragged and unaligned shards, parity written in place,
strided and unaligned CRC blocks of odd lengths), times each whole call
with CUDA events (``ms``) and each kernel alone from the profiler's CUDA
trace (``device_ms``, host work excluded), then drives the port's main path
through its public entry points (encode and reconstruct of a 48 MiB
payload, the pinned RS(12+4) fixture, the repair step with a corrupted
survivor, blob frame verification), checks that the path launched
both of its kernels, and times the path's entry points end to end.
Last it drives the GF tuning path (``tuning/gf_tuning.py``, both
rounds), which runs the bit-matrix tensor-core kernels, and checks that
it launched them. Each phase prints one JSON line; any failure raises.

The last lines are the kernels' record, the card's name and power limit
as nvidia-smi reports them, and ``{"ok": true, "device": {...}}``.
Without a CUDA device, or outside a checkout of the repository, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import functools
import itertools
import json
import os
import re
import subprocess
import sys
import time
import zlib

import numpy as np

SEED = 20261016
MIB = 1 << 20
SHARD = 4 * MIB  # EC12P4 production shard size
# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
KERNEL_REPS = 10
PLAIN_REPS = 3
MAIN_KERNELS = ("gf_apply", "crc32_blocks")  # repair_step and Encoder run these
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from cubefs_tpu_torch.codec import codemode as cm
    from cubefs_tpu_torch.codec import crc32block
    from cubefs_tpu_torch.codec.encoder import CodecConfig, new_encoder
    from cubefs_tpu_torch.models import repair
    from cubefs_tpu_torch.ops import (_build, crc32_kernel, crc_cuda, gf256, gf_bitmajor,
                                      gf_cuda, rs_kernel)
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
    in_place_data = in_place[:, :n].clone()
    unaligned = rand(3 * (SHARD + 5) + 1)[1:].view(3, 1, SHARD + 5)  # base 1 byte off
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
    ]
    coeff_36x36 = gf_cases[4][1]
    gf_results = []
    for label, coeff, x, out in gf_cases:
        r, c = coeff.shape
        b, s = x.shape[0], x.shape[-1]
        w = torch.from_numpy(rs_kernel.coeff_bits(coeff))
        call = functools.partial(gf_cuda.gf_apply, coeff, x, out=out)
        got = call()
        want = rs_kernel.gf_apply_bits(w, x)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        if out is not None:  # written in place, the data rows untouched
            equal = equal and got is out and bool(torch.equal(in_place[:, :n], in_place_data))
        err = max_abs_err(got, want)
        del got, want
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
    del surviving, gf_cases, in_place, in_place_data, unaligned

    # -- 3. crc32_blocks vs plain and zlib -------------------------------
    frame_rows = rand(512, 4, 64 << 10)  # blob frames: payloads 4 bytes into their blocks
    crc_cases = [  # (label, blocks)
        ("blocks_10000x128KiB", rand(10000, 128 << 10)),
        ("blob_payloads_2048x65532", rand(2048, (64 << 10) - 4)),
        ("repair_shards_8x4MiB", rand(8, SHARD)),
        ("frame_payload_views_512x4x65532", frame_rows[:, :, 4:]),
        ("odd_blocks_1000x1001", rand(1000, 1001)),
        ("short_blocks_4096x15", rand(4096, 15)),
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

    # -- 6. the entry points end to end, timed ------------------------------
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
    emit({"phase": "end_to_end", "cases": e2e})

    # -- 7. the GF tuning path: both rounds of tuning/gf_tuning.py ----------
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

    # -- 8. the kernels' record ---------------------------------------------
    gf_main, crc_main = gf_results[0], crc_results[0]
    bm_main, probe_main = (next(x for x in bm_results
                                if (x["case"], x["extract"], x["probe"], x["grid"]) == key)
                           for key in RECORDED_BM)
    emit({"kernels": [
        {"name": "gf_apply", "route": "cuda", "source": "cubefs_tpu_torch/csrc/gf_apply.cu",
         "replaces": "cubefs_tpu/ops/pallas_gf.py:46", "shape": gf_main["case"],
         "launches": launches["gf_apply"], "equal": gf_main["equal"],
         "max_abs_err": gf_main["max_abs_err"], "ms": gf_main["ms"],
         "device_ms": gf_main["device_ms"], "plain_ms": gf_main["plain_ms"],
         "bound_ms": gf_main["bound_ms"],
         "bound_by": gf_main["bound_by"], "library_ms": None},
        {"name": "crc32_blocks", "route": "cuda",
         "source": "cubefs_tpu_torch/csrc/crc32_blocks.cu",
         "replaces": "cubefs_tpu/ops/pallas_crc.py:44", "shape": crc_main["case"],
         "launches": launches["crc32_blocks"], "equal": crc_main["equal"],
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
