"""Package rules of the PyTorch port: it imports neither jax nor
cubefs_tpu, its entry points refuse to drop to the CPU on their own,
and its CUDA wrappers launch their kernel or raise. The tests that need
the card carry the ``cuda`` marker and skip here."""

import ast
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import cubefs_tpu_torch
from cubefs_tpu_torch import convert, device
from cubefs_tpu_torch.codec import codemode as tcm
from cubefs_tpu_torch.codec import engine
from cubefs_tpu_torch.codec.encoder import CodecConfig, new_encoder
from cubefs_tpu_torch.ops import _build, crc32_kernel, crc_cuda, gf256, gf_cuda, rs_kernel

PKG = os.path.dirname(os.path.abspath(cubefs_tpu_torch.__file__))
ROOT = os.path.dirname(PKG)
MODULES = sorted(
    "cubefs_tpu_torch." + os.path.relpath(os.path.join(d, f), PKG)[:-3].replace(os.sep, ".")
    for d, _, files in os.walk(PKG) for f in files
    if f.endswith(".py") and f != "__init__.py")


def _imported_roots(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", [
    *sorted(os.path.join(d, f) for d, _, files in os.walk(PKG) for f in files
            if f.endswith(".py")),
    os.path.join(ROOT, "chip_smoke.py"),
])
def test_sources_import_neither_jax_nor_the_jax_package(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "cubefs_tpu", "triton"}


def test_importing_every_module_loads_no_jax():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
              "('jax', 'jaxlib', 'cubefs_tpu'))\n"
            + "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        new_encoder(CodecConfig(tcm.CodeMode.EC12P4))
    with pytest.raises(RuntimeError):
        engine.get_engine("cuda")
    with pytest.raises(RuntimeError):
        convert.from_reference(np.zeros((1, 9, 8), np.uint8), 6, 3, [0])
    assert device.resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        device.resolve("meta")


def test_cuda_wrappers_refuse_cpu_tensors():
    """No fallback inside a wrapper: a CPU tensor given to a kernel
    wrapper is an error, never a quiet run of the plain version."""
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA kernel"):
        gf_cuda.gf_apply(gf256.parity_matrix(6, 3), torch.zeros((6, 64), dtype=torch.uint8))
    with pytest.raises(ValueError, match="CUDA kernel"):
        crc_cuda.crc32_blocks(torch.zeros((2, 64), dtype=torch.uint8))
    assert _build.LAUNCHES == before


def test_kernel_library_named_by_source_hash(monkeypatch):
    path = _build.lib_path("gf_apply")
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert path == _build.lib_path("gf_apply") != _build.lib_path("crc32_blocks")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.lib_path("gf_apply") != path
    monkeypatch.setenv("CUDA_HOME", os.path.join(ROOT, "no-such-toolkit"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [4096, 4096 + 5])
def test_gf_kernel_matches_plain_on_card(cuda_device, s):
    rng = np.random.default_rng(s)
    coeff = rng.integers(0, 256, (6, 12), dtype=np.uint8)
    x = torch.from_numpy(rng.integers(0, 256, (3, 12, s), dtype=np.uint8))
    before = _build.LAUNCHES["gf_apply"]
    got = rs_kernel.gf_matrix_apply(coeff, x.to(cuda_device)).cpu()
    assert _build.LAUNCHES["gf_apply"] == before + 1
    assert torch.equal(got, rs_kernel.gf_matrix_apply(coeff, x))


@pytest.mark.cuda
@pytest.mark.parametrize("block_len", [131072, 65532])
def test_crc_kernel_matches_zlib_on_card(cuda_device, block_len):
    rng = np.random.default_rng(block_len)
    blocks = rng.integers(0, 256, (5, block_len), dtype=np.uint8)
    got = crc32_kernel.crc32_blocks(torch.from_numpy(blocks).to(cuda_device)).cpu().numpy()
    assert got.tolist() == [zlib.crc32(r.tobytes()) for r in blocks]


@pytest.mark.cuda
def test_crc_kernel_reads_strided_views_on_card(cuda_device):
    rng = np.random.default_rng(9)
    stripes = rng.integers(0, 256, (3, 4, 4100), dtype=np.uint8)
    view = torch.from_numpy(stripes).to(cuda_device)[:, 1:3, 4:]
    got = crc32_kernel.crc32_blocks(view).cpu().numpy()
    assert got.tolist() == [[zlib.crc32(r.tobytes()) for r in s] for s in stripes[:, 1:3, 4:]]
