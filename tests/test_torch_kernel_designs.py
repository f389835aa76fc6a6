"""The arithmetic of the port's two main-path CUDA kernels, emulated in
numpy on the CPU from the port's own host tables (the ones the
kernels copy to shared memory), against the JAX package, its Pallas
kernels in interpret mode and zlib. The kernels themselves run only on
the card (``test_torch_kernels_card.py``); these tests pin their
algorithms. Tolerance: exact equality (integer math end to end).

- ``gf_apply.cu``: SWAR bit masks (shift, then spread each byte's top
  bit) AND-ed with the products table ``gf_cuda.swar_table``.
- ``crc32_blocks.cu``: spans laid out from the block's end, lanes with a
  1024-byte stride, tables indexed by 5-bit fields for the piece's CRC
  and the stride, then the lane and span folds with their column masks.
"""

import zlib

import numpy as np
import pytest
import torch

from cubefs_tpu.ops import crc32_kernel as ref_crc
from cubefs_tpu.ops import gf256 as ref_gf256
from cubefs_tpu.ops import pallas_crc, pallas_gf
from cubefs_tpu.ops import rs_kernel as ref_rs
from cubefs_tpu_torch.codec import codemode as tcm
from cubefs_tpu_torch.codec.encoder import CodecConfig, new_encoder
from cubefs_tpu_torch.models import repair
from cubefs_tpu_torch.ops import crc32_kernel, crc_cuda, gf256, gf_cuda, rs_kernel

U32 = np.uint32


# -- gf_apply.cu -------------------------------------------------------------

def _spread_top_bits(t: np.ndarray) -> np.ndarray:
    """prmt.b32 with selector 0xBA98: each byte becomes 0xFF if its top
    bit is set, else 0."""
    out = np.zeros_like(t)
    for b in range(4):
        out |= np.where((t >> U32(8 * b + 7)) & U32(1), U32(0xFF << (8 * b)), U32(0))
    return out


def _emulate_gf(coeff: np.ndarray, shards: np.ndarray) -> np.ndarray:
    """(R, C) x (C, S) with S % 4 == 0, word by word as the kernel does."""
    prod = gf_cuda.swar_table(coeff)
    words = shards.view("<u4")  # (C, S / 4), little-endian as the card loads them
    acc = np.zeros((coeff.shape[0], words.shape[1]), dtype=U32)
    for c in range(coeff.shape[1]):
        masks = [_spread_top_bits(words[c] << U32(7 - k)) for k in range(8)]
        for r in range(coeff.shape[0]):
            for k in range(8):
                acc[r] ^= masks[k] & prod[r, c, k]
    return acc.view(np.uint8)


def test_swar_table_holds_products_in_every_byte():
    rng = np.random.default_rng(1)
    coeff = rng.integers(0, 256, (3, 5), dtype=np.uint8)
    prod = gf_cuda.swar_table(coeff)
    assert prod.shape == (3, 5, 8) and prod.dtype == U32
    for k in range(8):
        want = gf256.gf_mul(coeff, np.uint8(1 << k)).astype(np.uint64)
        assert np.array_equal(prod[:, :, k], (want * 0x01010101).astype(U32))
    assert np.array_equal(prod[:, :, 0] & U32(0xFF), coeff)


@pytest.mark.parametrize("r,c,s", [(4, 12, 512), (1, 1, 64), (2, 12, 96), (36, 36, 128),
                                   (3, 7, 20)])
def test_swar_mask_multiply_matches_jax_and_pallas(r, c, s):
    rng = np.random.default_rng(r * 1000 + c * 10 + s)
    coeff = rng.integers(0, 256, (r, c), dtype=np.uint8)
    shards = rng.integers(0, 256, (c, s), dtype=np.uint8)
    got = _emulate_gf(coeff, shards)
    assert np.array_equal(got, ref_gf256.gf_matmul(coeff, shards))
    assert np.array_equal(got, np.asarray(ref_rs.gf_matrix_apply(coeff, shards)))
    if s % 128 == 0:
        pallas = pallas_gf.gf_matrix_apply_pallas(coeff, shards[None], tile=128, interpret=True)
        assert np.array_equal(got, np.asarray(pallas)[0])


def test_swar_mask_multiply_on_the_repair_rows():
    """The main path's apply: recovery + extra-survivor rows of RS(12+4)
    with shards 1 and 7 lost, all 256 byte values in every column."""
    rows = repair._step_rows(repair.make_plan(12, 4, [1, 7]))
    shards = np.stack([np.roll(np.arange(256, dtype=np.uint8), 17 * c) for c in range(12)])
    assert np.array_equal(_emulate_gf(rows, shards), ref_gf256.gf_matmul(rows, shards))


# -- crc32_blocks.cu ---------------------------------------------------------

def _fields(tables: np.ndarray, words: np.ndarray) -> np.ndarray:
    """XOR of one entry per 5-bit field of the little-endian words
    (..., n_words) from the tables, a field that straddles two words
    joined as the kernel's funnel shift joins it."""
    n_words = words.shape[-1]
    out = np.zeros(words.shape[:-1], dtype=U32)
    for f in range(tables.shape[0]):
        q, o = divmod(crc_cuda.FIELD * f, 32)
        bits = words[..., q] >> U32(o)
        if o > 32 - crc_cuda.FIELD and q + 1 < n_words:
            bits |= words[..., q + 1] << U32(32 - o)
        out ^= tables[f][bits & U32(31)]
    return out


def _emulate_crc(block: np.ndarray) -> int:
    plan = crc_cuda.plan(block.size)
    span = crc_cuda.ROW * plan.rows
    padded = np.zeros(plan.n_spans * span, dtype=np.uint8)
    padded[padded.size - block.size:] = block  # bytes before the block read as zeros
    words = padded.view("<u4").reshape(plan.n_spans, plan.rows, crc_cuda.LANES, 8)
    data, gap, lanes = crc_cuda.data_tables(), crc_cuda.gap_tables(), crc_cuda.lane_columns()
    state = np.zeros((plan.n_spans, crc_cuda.LANES), dtype=U32)
    for r in range(plan.rows):
        state = _fields(gap, state[..., None]) ^ _fields(data, words[:, r])
    moved = np.stack([crc_cuda.apply_columns(lanes[:, lane], state[:, lane])
                      for lane in range(crc_cuda.LANES)], axis=1)
    span_crc = np.bitwise_xor.reduce(moved, axis=1)
    cols = crc32_kernel.shift_columns(span, plan.n_spans)
    crc = crc32_kernel.crc32_zeros(block.size)
    for s in range(plan.n_spans):
        crc ^= int(crc_cuda.apply_columns(cols[s], span_crc[s:s + 1])[0])
    return crc


@pytest.mark.parametrize("block_len", [1, 15, 762, 65532, 128 << 10])
def test_span_crc_matches_zlib_and_jax(block_len):
    rng = np.random.default_rng(block_len)
    blocks = rng.integers(0, 256, (2, block_len), dtype=np.uint8)
    got = [_emulate_crc(b) for b in blocks]
    assert got == [zlib.crc32(b.tobytes()) for b in blocks]
    assert got == np.asarray(ref_crc.crc32_blocks(blocks, 1024)).astype(np.int64).tolist()


def test_span_crc_matches_pallas_crc():
    rng = np.random.default_rng(4096)
    blocks = rng.integers(0, 256, (3, 4096), dtype=np.uint8)
    pallas = pallas_crc.crc32_blocks_pallas(blocks, chunk_len=1024, tile_blocks=8, interpret=True)
    assert [_emulate_crc(b) for b in blocks] == np.asarray(pallas).astype(np.int64).tolist()


@pytest.mark.parametrize("block_len,rows,n_spans", [
    (1, 1, 1), (15, 1, 1), (1024, 1, 1), (1025, 2, 1), (762, 1, 1), (8192, 8, 1),
    (8193, 8, 2), (65532, 8, 8), (128 << 10, 8, 16), (4 << 20, 8, 512),
])
def test_span_plan(block_len, rows, n_spans):
    """Spans cover each block with less than one span of leading zeros."""
    plan = crc_cuda.plan(block_len)
    assert (plan.rows, plan.n_spans) == (rows, n_spans)
    span = crc_cuda.ROW * plan.rows
    assert 0 <= plan.n_spans * span - block_len < span


def test_kernel_tables_are_the_matrices_they_stand_for():
    data, gap, lanes = crc_cuda.data_tables(), crc_cuda.gap_tables(), crc_cuda.lane_columns()
    assert data.shape == (52, 32) and gap.shape == (7, 32)
    table = crc32_kernel._byte_table()
    # field 0 is bits 0-4 of byte 0, which 31 bytes follow
    after = crc_cuda._columns(ref_crc.zeros_matrix(31))
    assert np.array_equal(data[0], crc_cuda.apply_columns(after, table[np.arange(32)]))
    # the last field holds bit 7 of byte 31 alone: the plain byte table's entry
    assert np.array_equal(data[51], np.where(np.arange(32) & 1, table[0x80], U32(0)))
    rng = np.random.default_rng(2)
    x = rng.integers(0, 1 << 32, 64, dtype=np.uint64).astype(U32)
    a1024 = crc_cuda._columns(ref_crc.zeros_matrix(1024))
    assert np.array_equal(_fields(gap, x[:, None]), crc_cuda.apply_columns(a1024, x))
    for lane in (0, 17, 31):
        want = crc_cuda._columns(ref_crc.zeros_matrix(32 * (31 - lane)))
        assert np.array_equal(lanes[:, lane], want)
    assert crc_cuda.consts().shape == (1664 + 224 + 1024,)


def test_fit_chunk_len_cache_returns_the_reference_values():
    crc32_kernel.fit_chunk_len.cache_clear()
    for total in (1, 762, 65532, 131072, 4 << 20, 5000):
        want = ref_crc.fit_chunk_len(1024, total)
        assert crc32_kernel.fit_chunk_len(1024, total) == want
        assert crc32_kernel.fit_chunk_len(1024, total) == want  # from the cache
    assert crc32_kernel.fit_chunk_len.cache_info().hits >= 6


def test_encoder_writes_parity_in_place_through_out():
    """Encoder.encode hands the stripe's parity rows to the apply as
    ``out``; the plain path fills them and leaves the data rows alone."""
    rng = np.random.default_rng(12)
    stripes = torch.from_numpy(rng.integers(0, 256, (3, 16, 256), dtype=np.uint8))
    data = stripes[:, :12].clone()
    enc = new_encoder(CodecConfig(tcm.CodeMode.EC12P4, device="cpu"))
    assert enc.encode(stripes) is stripes
    assert torch.equal(stripes[:, :12], data)
    assert np.array_equal(stripes[:, 12:].numpy(),
                          np.asarray(ref_rs.encode_parity(data.numpy(), 4)))
    out = torch.zeros((3, 4, 256), dtype=torch.uint8)
    assert rs_kernel.encode_parity(data, 4, out=out) is out
    assert torch.equal(out, stripes[:, 12:])
    with pytest.raises(ValueError, match="out must be"):
        rs_kernel.encode_parity(data, 4, out=torch.zeros((3, 5, 256), dtype=torch.uint8))
