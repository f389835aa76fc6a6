"""The main-path kernels A (``csrc/gf_apply.cu``) and B
(``csrc/crc32_blocks.cu``) on the card, on the edge cases of their
designs: parity written in place through ``out=``, one row and one
column, ragged S and unaligned bases for A; strided views, unaligned
65,532-byte payloads and odd block lengths for B, held against zlib.

Every test needs a CUDA device (``cuda`` marker; the fixture skips
without one). The file imports no jax, so it runs on a machine that has
only the port's dependencies:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_kernels_card.py

Tolerance: exact equality (integer math end to end).
"""

import zlib

import numpy as np
import pytest
import torch

from cubefs_tpu_torch.codec import codemode as tcm
from cubefs_tpu_torch.codec.encoder import CodecConfig, new_encoder
from cubefs_tpu_torch.ops import _build, crc32_kernel, gf256, rs_kernel
from cubefs_tpu_torch.utils import benchtime


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _plain(coeff: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    return rs_kernel.gf_matrix_apply(coeff, x.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("s", [4096, 4096 + 3])
def test_encode_writes_parity_in_place_with_one_launch(cuda_device, s):
    rng = np.random.default_rng(s)
    stripes = torch.from_numpy(rng.integers(0, 256, (3, 16, s), dtype=np.uint8)).to(cuda_device)
    data = stripes[:, :12].clone()
    enc = new_encoder(CodecConfig(tcm.CodeMode.EC12P4))
    before = _build.LAUNCHES["gf_apply"]
    assert enc.encode(stripes) is stripes
    assert _build.LAUNCHES["gf_apply"] == before + 1
    assert torch.equal(stripes[:, :12], data)
    assert torch.equal(stripes[:, 12:].cpu(), _plain(gf256.parity_matrix(12, 4), data))


@pytest.mark.cuda
def test_out_view_leaves_other_rows_untouched(cuda_device):
    rng = np.random.default_rng(7)
    coeff = rng.integers(0, 256, (2, 5), dtype=np.uint8)
    x = torch.from_numpy(rng.integers(0, 256, (4, 5, 1024), dtype=np.uint8)).to(cuda_device)
    big = torch.full((4, 6, 1024), 0xA5, dtype=torch.uint8, device=cuda_device)
    assert rs_kernel.gf_matrix_apply(coeff, x, out=big[:, 2:4]) is not None
    assert torch.equal(big[:, 2:4].cpu(), _plain(coeff, x))
    assert bool((big[:, [0, 1, 4, 5]] == 0xA5).all())
    with pytest.raises(ValueError, match="out must be"):
        rs_kernel.gf_matrix_apply(coeff, x, out=big[:, 2:5])


@pytest.mark.cuda
@pytest.mark.parametrize("r,c,s,offset", [
    (1, 1, 1, 0), (1, 1, 4096 + 5, 0), (1, 1, 4096, 1), (4, 12, 999, 3), (36, 36, 4096, 0),
    (5, 9, 2048 + 16, 0), (8, 3, 1000, 0),
])
def test_gf_apply_edges_match_plain(cuda_device, r, c, s, offset):
    rng = np.random.default_rng(r * 100 + c + s + offset)
    coeff = rng.integers(0, 256, (r, c), dtype=np.uint8)
    flat = torch.from_numpy(rng.integers(0, 256, 2 * c * s + offset, dtype=np.uint8))
    x = flat.to(cuda_device)[offset:].view(2, c, s)  # base `offset` bytes past the allocation
    got = rs_kernel.gf_matrix_apply(coeff, x).cpu()
    assert torch.equal(got, _plain(coeff, x))


@pytest.mark.cuda
@pytest.mark.parametrize("block_len", [1, 15, 16, 762, 1001, 4096, 65532, 131072])
def test_crc_block_lengths_match_zlib(cuda_device, block_len):
    rng = np.random.default_rng(block_len)
    blocks = rng.integers(0, 256, (5, block_len), dtype=np.uint8)
    got = crc32_kernel.crc32_blocks(torch.from_numpy(blocks).to(cuda_device)).cpu()
    assert got.tolist() == [zlib.crc32(b.tobytes()) for b in blocks]


@pytest.mark.cuda
@pytest.mark.parametrize("head,block_len,row_len", [
    (4, 65532, 65536),  # blob frames: 16-byte loads aligned to the block end
    (1, 4095, 4096),    # the same, 15 bytes before the block masked
    (2, 1026, 1028),    # byte loads: 4-byte aligned, not 16
    (4, 65532, 65541), (1, 4095, 4105), (16, 4096, 4117), (3, 15, 23),  # byte loads
])
def test_crc_strided_unaligned_views_match_zlib(cuda_device, head, block_len, row_len):
    """(outer, inner) views a few bytes into their rows, as verify_batch
    reads blob payloads past their CRC words."""
    rng = np.random.default_rng(head * block_len + row_len)
    rows = rng.integers(0, 256, (3, 4, row_len), dtype=np.uint8)
    view = torch.from_numpy(rows).to(cuda_device)[:, 1:4, head:head + block_len]
    got = crc32_kernel.crc32_blocks(view).cpu()
    want = [[zlib.crc32(b.tobytes()) for b in r] for r in rows[:, 1:4, head:head + block_len]]
    assert got.tolist() == want


@pytest.mark.cuda
def test_device_ms_reads_the_kernel_from_the_profiler(cuda_device):
    x = torch.zeros((8, 1 << 20), dtype=torch.uint8, device=cuda_device)
    ms = benchtime.device_ms(lambda: crc32_kernel.crc32_blocks(x), 3, "crc32_span_kernel")
    assert 0 < ms < 100
    with pytest.raises(RuntimeError, match="no CUDA kernel"):
        benchtime.device_ms(lambda: crc32_kernel.crc32_blocks(x), 1, "no_such_kernel")
