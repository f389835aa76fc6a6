"""The port's batched CRC32 (plain PyTorch path on CPU) against zlib,
the JAX package's jnp CRC and its Pallas kernel in interpret mode, plus
the copied host matrix math and the blob frame verifier. Tolerance:
exact equality."""

import zlib

import numpy as np
import pytest
import torch

from cubefs_tpu.codec import crc32block as ref_block
from cubefs_tpu.ops import crc32_kernel as ref_crc
from cubefs_tpu.ops import pallas_crc
from cubefs_tpu_torch.codec import crc32block
from cubefs_tpu_torch.ops import crc32_kernel


def _zlib(blocks: np.ndarray) -> np.ndarray:
    return np.array([zlib.crc32(r.tobytes()) for r in blocks], dtype=np.int64)


@pytest.mark.parametrize("b,block_len,chunk", [
    (5, 4096, 1024),
    (3, 65532, 1024),  # blob payload: non-divisor fit 1024 -> 762
    (4, 5000, 1024),
    (2, 1000, 128),
    (1, 64, 1024),     # single chunk shorter than the target
])
def test_crc_blocks_match_zlib_jax_and_pallas(b, block_len, chunk):
    rng = np.random.default_rng(block_len + b)
    blocks = rng.integers(0, 256, (b, block_len), dtype=np.uint8)
    got = crc32_kernel.crc32_blocks_plain(torch.from_numpy(blocks), chunk).numpy()
    assert got.dtype == np.int64
    if chunk == crc32_kernel.CHUNK_LEN:
        assert np.array_equal(crc32_kernel.crc32_blocks(torch.from_numpy(blocks)).numpy(), got)
    assert np.array_equal(got, _zlib(blocks))
    assert np.array_equal(got, np.asarray(ref_crc.crc32_blocks(blocks, chunk)).astype(np.int64))
    pallas = np.asarray(pallas_crc.crc32_blocks_pallas(blocks, chunk_len=chunk, tile_blocks=8,
                                                       interpret=True))
    assert np.array_equal(got, pallas.astype(np.int64))


def test_crc_blocks_take_leading_dims_and_strided_views():
    """(B, W, block_len) and strided views (payloads past their CRC
    words, some rows of a stripe) give one CRC per block."""
    rng = np.random.default_rng(5)
    stripes = rng.integers(0, 256, (3, 4, 1028), dtype=np.uint8)
    view = torch.from_numpy(stripes)[:, 1:3, 4:]
    got = crc32_kernel.crc32_blocks(view).numpy()
    assert got.shape == (3, 2)
    assert np.array_equal(got.ravel(), _zlib(stripes[:, 1:3, 4:].reshape(-1, 1024)))


def test_blob_payload_chunk_fit():
    assert crc32_kernel.fit_chunk_len(1024, 65532) == 762
    for total in (1, 7, 762, 1000, 4096, 65532, 131072, 5000, 4 << 20):
        for target in (128, 1000, 1024, 3000):
            assert crc32_kernel.fit_chunk_len(target, total) == ref_crc.fit_chunk_len(target, total)


@pytest.mark.parametrize("b", [7, 8, 1])
def test_micro_batched_path(b, monkeypatch):
    """Batches past the unpack budget run in slices of whole blocks,
    including a last slice shorter than the others."""
    monkeypatch.setattr(crc32_kernel, "_UNPACK_BUDGET_BYTES", 3 * 32 * 2048)
    rng = np.random.default_rng(b)
    blocks = rng.integers(0, 256, (b, 2048), dtype=np.uint8)
    got = crc32_kernel.crc32_blocks_plain(torch.from_numpy(blocks), 512).numpy()
    assert np.array_equal(got, _zlib(blocks))


def test_combine_zeros_and_matrices_match_reference():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, 777, dtype=np.uint8).tobytes()
    b = rng.integers(0, 256, 4099, dtype=np.uint8).tobytes()
    got = crc32_kernel.crc32_combine(zlib.crc32(a), zlib.crc32(b), len(b))
    assert got == zlib.crc32(a + b)
    assert got == ref_crc.crc32_combine(zlib.crc32(a), zlib.crc32(b), len(b))
    for n in (0, 1, 762, 65532, 131072):
        assert crc32_kernel.crc32_zeros(n) == zlib.crc32(bytes(n)) == ref_crc.crc32_zeros(n)
    for length in (1, 16, 762):
        assert np.array_equal(crc32_kernel.chunk_matrix(length), ref_crc.chunk_matrix(length))
    assert np.array_equal(crc32_kernel.zeros_matrix(4096), ref_crc.zeros_matrix(4096))


def test_shift_columns_pack_shift_matrices():
    mats = crc32_kernel.shift_matrices(762, 86)
    cols = crc32_kernel.shift_columns(762, 86)
    k, i = 17, 5
    want = sum(int(mats[k, j, i]) << j for j in range(32))
    assert int(cols[k, i]) == want
    assert np.array_equal(mats[0], ref_crc.zeros_matrix(85 * 762))
    assert np.array_equal(mats[-1], np.eye(32, dtype=np.uint8))


def test_extent_combine_chain_over_block_crcs():
    rng = np.random.default_rng(11)
    blocks = rng.integers(0, 256, (6, 512), dtype=np.uint8)
    crcs = crc32_kernel.crc32_blocks_plain(torch.from_numpy(blocks), 128).tolist()
    combined = 0
    for c in crcs:
        combined = crc32_kernel.crc32_combine(combined, c, 512)
    assert combined == zlib.crc32(blocks.tobytes())


def test_frame_codec_and_verify_batch_match_reference():
    rng = np.random.default_rng(21)
    block = 4096
    data = rng.integers(0, 256, 3 * (block - 4), dtype=np.uint8).tobytes()
    frame = crc32block.encode(data, block)
    assert frame == ref_block.encode(data, block)
    assert crc32block.decode(frame, block) == data
    assert crc32block.encoded_size(len(data), block) == len(frame)
    assert crc32block.decoded_size(len(frame), block) == len(data)
    frames = np.stack([np.frombuffer(frame, np.uint8)] * 4)
    frames[2, block + 9] ^= 0x40
    got = crc32block.verify_batch(torch.from_numpy(frames), block).tolist()
    assert got == [True, True, False, True]
    assert got == ref_block.verify_batch(frames, block).tolist()
    with pytest.raises(crc32block.CrcFrameError):
        crc32block.decode(bytes(frames[2]), block)
    with pytest.raises(crc32block.CrcFrameError):
        crc32block.verify_batch(torch.from_numpy(frames[:, :-1].copy()), block)
