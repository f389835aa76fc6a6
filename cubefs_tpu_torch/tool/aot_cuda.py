"""Build check of the port's CUDA kernels for Hopper (``sm_90a``), no card.

The port's counterpart of ``cubefs_tpu/tool/aot_tpu.py``, which compiles
the judged graphs for a TPU target without a chip. This tool compiles the
three kernel sources (``csrc/{gf_apply,crc32_blocks,gf_bitmajor}.cu``)
with ``nvcc`` alone, with the flags the port builds them with
(``ops/_build.NVCC_FLAGS``, which carry ``-Xptxas -v``), once as the
shared library the port loads and once as a bare ``.cubin``, all started
together. From ptxas' report it records, for every ``__global__``
function of ``_build.SYMBOLS`` and each of its instantiations, the
registers per thread, the static shared memory, the constant memory, the
stack frame and the spill stores and loads; beside them, the size of its
source's cubin.

Outputs, under ``--out-dir`` (default ``cubefs_tpu_torch/_build/aot_sm90a/``,
which is not committed):

  AOT_sm90a.json   one record per kernel symbol, and one per source
  ROOFLINE.md      the least time of the judged shapes of ``bench.py``
                   configs 2-4 on an H100, by bytes and by operations
  lib<src>.so, <src>.cubin, <src>.log   the builds and nvcc's output

    python -m cubefs_tpu_torch.tool.aot_cuda [--out-dir DIR]

It prints the summary as one JSON line. Without ``nvcc``, or when a source
does not compile or a symbol is missing from its report, it exits 1 with
the compiler's message on standard error and reports no kernel it did not
build. It imports no torch.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

from ..ops import _build

# The peaks the bound is taken against: the HBM3 rate and the dense int8
# tensor-core rate of the NVIDIA H100 SXM data sheet, at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

# the flags of the library build that do not apply to a bare cubin
_LINK_FLAGS = ("-shared", "-Xcompiler", "-fPIC")


def bound(nbytes: int, int8_ops: int) -> tuple[float, str]:
    """The least time of a function, in ms: the larger of its bytes
    (inputs read once, outputs written once) over the HBM rate and its
    operations over the peak of their type. A GF(2^8) multiply-add, or
    one byte's step of a table CRC, has no unit of its own on the card;
    each is counted as two int8 operations at the int8 peak, which credits
    the function with the fastest integer rate the card has."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = int8_ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gf_apply_work(r: int, c: int, s: int, b: int) -> tuple[int, int]:
    """Bytes and int8 operations of an (R, C) GF(2^8) apply to B stripes
    of C shards of S bytes: C + R rows of S moved, R * C multiply-adds a
    byte column."""
    return (c + r) * s * b, 2 * r * c * s * b


def crc_work(b: int, block_len: int) -> tuple[int, int]:
    """Bytes and int8 operations of the CRC32 of B blocks: each block read
    once, a 4-byte CRC written for each, one table step a byte."""
    return b * block_len + 4 * b, 2 * b * block_len


def ptxas_registers(log: str) -> dict[str, int]:
    """Mangled kernel name -> registers per thread, from the ``-Xptxas -v``
    report nvcc wrote while building a source (none if the file is missing
    or the library was built without it)."""
    if not os.path.exists(log):
        return {}
    with open(log) as f:
        return {name: e["registers"] for name, e in parse_ptxas(f.read()).items()}


def parse_ptxas(text: str) -> dict[str, dict]:
    """Every entry function ptxas compiled, from its ``-v`` report: mangled
    name -> registers per thread, static shared memory, constant memory
    (summed over banks), stack frame, spill stores and spill loads, in
    bytes where not a count. An entry whose report lacks a line keeps 0
    there."""
    entries: dict[str, dict] = {}
    frames: dict[str, tuple[int, int, int]] = {}  # any function's stack and spills
    current = props = None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            current = m.group(1)
            entries[current] = {"registers": 0, "smem_bytes": 0, "cmem_bytes": 0,
                                "stack_bytes": 0, "spill_store_bytes": 0,
                                "spill_load_bytes": 0}
            continue
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and props is not None:
            frames[props] = tuple(map(int, m.groups()))
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and current is not None:
            e = entries[current]
            e["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            e["smem_bytes"] = int(sm.group(1)) if sm else 0
            e["cmem_bytes"] = sum(int(x) for x in re.findall(r"(\d+) bytes cmem\[\d+\]", ln))
            current = None
    for name, (stack, stores, loads) in frames.items():
        if name in entries:
            entries[name].update(stack_bytes=stack, spill_store_bytes=stores,
                                 spill_load_bytes=loads)
    return entries


def symbol_entries(symbol: str, entries: dict[str, dict]) -> dict[str, dict]:
    """The entries of one ``__global__`` function: its mangled name carries
    the symbol's length and name (``_Z15gf_apply_kernel...``), once per
    template instantiation."""
    tag = f"{len(symbol)}{symbol}"
    return {name: e for name, e in entries.items() if tag in name}


def sources() -> list[str]:
    """The kernel sources, one per library, in ``_build.KERNELS`` order."""
    out: list[str] = []
    for src, _, _ in _build.KERNELS.values():
        if src not in out:
            out.append(src)
    return out


def compile_sources(out_dir: str) -> dict[str, dict]:
    """One library and one cubin per source, every nvcc started at once.
    Returns, per source, whether both compiled, the seconds from the start
    of every build until its two were collected, the cubin's size and
    ptxas' entries (from the library build); raises RuntimeError with
    nvcc's output where a source failed."""
    nvcc = _build.nvcc()
    cubin_flags = tuple(f for f in _build.NVCC_FLAGS if f not in _LINK_FLAGS)
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for src in sources():
        stem = os.path.splitext(src)[0]
        path = os.path.join(_build.SRC_DIR, src)
        lib = os.path.join(out_dir, f"lib{stem}.so")
        cubin = os.path.join(out_dir, f"{stem}.cubin")
        procs[src] = [(kind, subprocess.Popen(
            [nvcc, *flags, "-o", out, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for kind, flags, out in (("library", _build.NVCC_FLAGS, lib),
                                     ("cubin", (*cubin_flags, "-cubin"), cubin))]
    records, failed = {}, []
    for src, runs in procs.items():
        stem = os.path.splitext(src)[0]
        rec = {"source": f"cubefs_tpu_torch/csrc/{src}", "compiled": True}
        logs = {}
        for kind, proc in runs:
            logs[kind], _ = proc.communicate()
            if proc.returncode:
                rec["compiled"] = False
                failed.append(f"{src} ({kind}): nvcc exited {proc.returncode}\n{logs[kind]}")
        rec["seconds"] = round(time.perf_counter() - t0, 3)
        with open(os.path.join(out_dir, f"{stem}.log"), "w") as f:
            f.write(logs["library"])
        if rec["compiled"]:
            rec["cubin_bytes"] = os.path.getsize(os.path.join(out_dir, f"{stem}.cubin"))
            rec["entries"] = parse_ptxas(logs["library"])
        records[src] = rec
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return records


def kernel_records(by_source: dict[str, dict]) -> list[dict]:
    """One record per symbol of ``_build.SYMBOLS``: its source, its cubin's
    size and every instantiation's ptxas figures; raises if a symbol is in
    no compiled source's report."""
    out = []
    for symbol in _build.SYMBOLS:
        hits = [(src, symbol_entries(symbol, rec.get("entries", {})))
                for src, rec in by_source.items()]
        hits = [(src, e) for src, e in hits if e]
        if not hits:
            raise RuntimeError(f"{symbol}: in no source's ptxas report; not built")
        src, entries = hits[0]
        out.append({
            "symbol": symbol, "source": by_source[src]["source"], "compiled": True,
            "cubin_bytes": by_source[src]["cubin_bytes"],
            "instantiations": len(entries),
            "max_registers": max(e["registers"] for e in entries.values()),
            "max_smem_bytes": max(e["smem_bytes"] for e in entries.values()),
            "spill_store_bytes": sum(e["spill_store_bytes"] for e in entries.values()),
            "spill_load_bytes": sum(e["spill_load_bytes"] for e in entries.values()),
            "entries": entries,
        })
    return out


def judged_shapes() -> list[dict]:
    """The judged shapes of ``bench.py`` configs 2-4 at full size, with
    their bytes, operations and bound on an H100."""
    shard = 4 << 20
    rows = []
    for config, what, kernel, (nbytes, ops) in (
            (2, "RS(12+4) encode, 8 stripes of 12 x 4 MiB", "gf_apply_kernel",
             gf_apply_work(4, 12, shard, 8)),
            (3, "RS(12+4) repair step rows R=4, C=12, 4 stripes of 4 MiB shards",
             "gf_apply_kernel", gf_apply_work(4, 12, shard, 4)),
            (4, "CRC32 of 10,000 x 128 KiB blocks", "crc32_span_kernel",
             crc_work(10_000, 128 << 10))):
        ms, by = bound(nbytes, ops)
        rows.append({"config": config, "shape": what, "kernel": kernel, "bytes": nbytes,
                     "int8_ops": ops, "bound_ms": ms, "bound_by": by})
    return rows


def roofline_md(kernels: list[dict], shapes: list[dict]) -> str:
    lines = [
        "# Least time of the judged shapes on an H100 (sm_90a)",
        "",
        f"Peaks: HBM3 {HBM_BYTES_PER_S / 1e12:.2f} TB/s, dense int8 "
        f"{INT8_OPS_PER_S / 1e12:.0f} TOP/s (H100 SXM5 80 GB). The bound is the "
        "larger of bytes over the HBM rate and int8 operations over the int8 "
        "peak, the rule `chip_smoke.py` uses. No time here is measured.",
        "",
        "| config | shape | kernel | bytes | int8 ops | bound ms | bound by |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in shapes:
        lines.append(f"| {r['config']} | {r['shape']} | `{r['kernel']}` | {r['bytes']:,} | "
                     f"{r['int8_ops']:,} | {r['bound_ms']:.4f} | {r['bound_by']} |")
    lines += [
        "",
        "## ptxas, per kernel instantiation",
        "",
        "| kernel | instantiation | registers | smem B | cmem B | stack B | spill st/ld B | cubin B |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for k in kernels:
        for name, e in k["entries"].items():
            lines.append(f"| `{k['symbol']}` | `{name}` | {e['registers']} | {e['smem_bytes']} | "
                         f"{e['cmem_bytes']} | {e['stack_bytes']} | "
                         f"{e['spill_store_bytes']}/{e['spill_load_bytes']} | {k['cubin_bytes']:,} |")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cubefs-tpu-torch-aot-cuda")
    ap.add_argument("--out-dir", default=os.path.join(_build.BUILD_DIR, "aot_sm90a"),
                    help="where the builds, AOT_sm90a.json and ROOFLINE.md go")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    try:
        by_source = compile_sources(args.out_dir)
        kernels = kernel_records(by_source)
    except RuntimeError as e:
        print(f"aot_cuda: {e}", file=sys.stderr)
        return 1
    shapes = judged_shapes()
    summary = {
        "target": "sm_90a", "nvcc_flags": list(_build.NVCC_FLAGS),
        "all_ok": True, "seconds": round(time.perf_counter() - t0, 3),
        "sources": {src: {k: v for k, v in rec.items() if k != "entries"}
                    for src, rec in by_source.items()},
        "kernels": kernels, "judged_shapes": shapes,
    }
    with open(os.path.join(args.out_dir, "AOT_sm90a.json"), "w") as f:
        f.write(json.dumps(summary, indent=1) + "\n")
    with open(os.path.join(args.out_dir, "ROOFLINE.md"), "w") as f:
        f.write(roofline_md(kernels, shapes))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
