"""The sm_90a build check (``cubefs_tpu_torch/tool/aot_cuda.py``), the port's
counterpart of ``cubefs_tpu/tool/aot_tpu.py``.

- ptxas' ``-v`` report, in nvcc's format, parsed per entry function:
  registers, static shared and constant memory, stack frame, spills;
  a device function's frame is not an entry's; a kernel symbol's entries
  are its template instantiations;
- the bound of the judged shapes (``bench.py`` configs 2-4) is the one
  ``PERF.md`` §6 gives: 0.0801 ms for the repair rows R=4, C=12, B=4 at
  4 MiB (268,435,456 bytes), 0.1603 ms for the encode at B=8, 0.3913 ms for
  the CRC32 of 10,000 x 128 KiB; ``chip_smoke.py`` takes its bound and its
  ptxas parser from the tool and keeps no copy;
- without nvcc the tool exits 1 with the compiler's message and writes no
  record, and a symbol missing from every report is refused;
- on the card's machine (``cuda`` marker, skipped without nvcc), the three
  sources compile for ``sm_90a`` and every symbol of ``_build.SYMBOLS`` is
  recorded with its registers and a cubin.
"""

import json
import os
import shutil

import pytest

from cubefs_tpu_torch.ops import _build
from cubefs_tpu_torch.tool import aot_cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

APPLY = "_Z15gf_apply_kernelPKhxPhxxS0_iixi"
BM0 = "_Z18gf_bitmajor_kernelILi0ELi0EEvPKhxPhPKjiixiii"
BM1 = "_Z18gf_bitmajor_kernelILi1ELi2EEvPKhxPhPKjiixiii"
LOG = f"""\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{APPLY}' for 'sm_90a'
ptxas info    : Function properties for {APPLY}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers, 400 bytes cmem[0]
ptxas info    : Function properties for _Z8fold_rowjj
    24 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '{BM0}' for 'sm_90a'
ptxas info    : Function properties for {BM0}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 1024 bytes smem, 432 bytes cmem[0]
ptxas info    : Compiling entry function '{BM1}' for 'sm_90a'
ptxas info    : Function properties for {BM1}
    16 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 2048 bytes smem, 432 bytes cmem[0], 8 bytes cmem[2]
"""


def test_ptxas_report_parsed_per_entry():
    got = aot_cuda.parse_ptxas(LOG)
    assert list(got) == [APPLY, BM0, BM1]  # the device function is no entry
    assert got[APPLY] == {"registers": 40, "smem_bytes": 0, "cmem_bytes": 400,
                          "stack_bytes": 0, "spill_store_bytes": 0, "spill_load_bytes": 0}
    assert got[BM1] == {"registers": 255, "smem_bytes": 2048, "cmem_bytes": 440,
                        "stack_bytes": 16, "spill_store_bytes": 8, "spill_load_bytes": 12}
    assert list(aot_cuda.symbol_entries("gf_bitmajor_kernel", got)) == [BM0, BM1]
    assert list(aot_cuda.symbol_entries("gf_apply_kernel", got)) == [APPLY]
    assert aot_cuda.symbol_entries("crc32_span_kernel", got) == {}


def test_ptxas_registers_reads_a_build_log(tmp_path):
    log = tmp_path / "libgf_bitmajor-0123.log"
    log.write_text(LOG)
    assert aot_cuda.ptxas_registers(str(log)) == {APPLY: 40, BM0: 96, BM1: 255}
    assert aot_cuda.ptxas_registers(str(tmp_path / "missing.log")) == {}


def test_the_judged_shapes_bounds_are_perf_mds():
    mib4 = 4 << 20
    nbytes, ops = aot_cuda.gf_apply_work(4, 12, mib4, 4)
    assert nbytes == 268_435_456 and ops == 2 * 4 * 12 * mib4 * 4
    ms, by = aot_cuda.bound(nbytes, ops)
    assert (round(ms, 4), by) == (0.0801, "bytes")
    assert round(aot_cuda.bound(*aot_cuda.gf_apply_work(4, 12, mib4, 8))[0], 4) == 0.1603
    ms, by = aot_cuda.bound(*aot_cuda.crc_work(10_000, 128 << 10))
    assert (round(ms, 4), by) == (0.3913, "bytes")
    # a function whose operations outweigh its bytes is bound by them
    assert aot_cuda.bound(1, 2 * 1979 * 10**9)[1] == "operations"
    shapes = aot_cuda.judged_shapes()
    assert [s["config"] for s in shapes] == [2, 3, 4]
    assert [round(s["bound_ms"], 4) for s in shapes] == [0.1603, 0.0801, 0.3913]
    md = aot_cuda.roofline_md([], shapes)
    assert "0.0801" in md and "0.3913" in md and "TPU" not in md and "v5e" not in md


def test_chip_smoke_keeps_no_copy_of_the_parser_or_the_bound():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        src = f.read()
    assert "def ptxas_registers(" not in src and "def bound(" not in src
    assert "from cubefs_tpu_torch.tool.aot_cuda import" in src
    assert "HBM_BYTES_PER_S = " not in src and "INT8_OPS_PER_S = " not in src


def test_the_sources_are_the_three_kernel_files():
    assert aot_cuda.sources() == ["gf_apply.cu", "crc32_blocks.cu", "gf_bitmajor.cu"]
    for src in aot_cuda.sources():
        assert os.path.exists(os.path.join(_build.SRC_DIR, src))


def test_without_nvcc_it_exits_1_and_writes_no_record(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    out = tmp_path / "out"
    assert aot_cuda.main(["--out-dir", str(out)]) == 1
    cap = capsys.readouterr()
    assert cap.out == "" and "nvcc not found" in cap.err
    assert not (out / "AOT_sm90a.json").exists()


def test_a_symbol_in_no_report_is_refused():
    by_source = {"gf_apply.cu": {"source": "s", "cubin_bytes": 10,
                                 "entries": aot_cuda.parse_ptxas(LOG)}}
    with pytest.raises(RuntimeError, match="crc32_span_kernel"):
        aot_cuda.kernel_records(by_source)


@pytest.fixture
def nvcc():
    try:
        return _build.nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc (the CUDA toolkit)")


@pytest.mark.cuda
def test_the_three_sources_compile_for_sm_90a(nvcc, tmp_path, capsys):
    assert aot_cuda.main(["--out-dir", str(tmp_path)]) == 0
    printed = json.loads(capsys.readouterr().out)
    with open(tmp_path / "AOT_sm90a.json") as f:
        rec = json.load(f)
    assert printed == rec and rec["all_ok"] and rec["target"] == "sm_90a"
    assert [k["symbol"] for k in rec["kernels"]] == list(_build.SYMBOLS)
    for k in rec["kernels"]:
        assert k["compiled"] and k["cubin_bytes"] > 0 and k["max_registers"] > 0
        assert all(e["registers"] > 0 for e in k["entries"].values())
    assert (tmp_path / "ROOFLINE.md").exists()
    shutil.rmtree(tmp_path)
