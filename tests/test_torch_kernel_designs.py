"""The arithmetic of the port's CUDA kernels, emulated in
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
- ``gf_bitmajor.cu`` (kernels C and D): the n-tile column map, the
  per-lane words after ``transpose4`` as B registers, the shuffle-OR
  repack's 8-byte runs, the whole apply and both probes item by item,
  the producer's own loads of unaligned rows (aligned words shifted into
  place), and the input ring's stage count and shared memory.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import pallas_tuning
from cubefs_tpu.ops import bitlin as ref_bitlin
from cubefs_tpu.ops import crc32_kernel as ref_crc
from cubefs_tpu.ops import gf256 as ref_gf256
from cubefs_tpu.ops import pallas_crc, pallas_gf
from cubefs_tpu.ops import rs_kernel as ref_rs
from cubefs_tpu_torch.codec import codemode as tcm
from cubefs_tpu_torch.codec.encoder import CodecConfig, new_encoder
from cubefs_tpu_torch.models import repair
from cubefs_tpu_torch.ops import crc32_kernel, crc_cuda, gf256, gf_bitmajor, gf_cuda, rs_kernel
from cubefs_tpu_torch.tuning import gf_tuning

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


# -- gf_bitmajor.cu ----------------------------------------------------------
# A work item is a (Cpad, T) row-major stage of raw shard bytes; warp group
# u takes tile columns 32u .. 32u+31, lane (g, t) of n-tile j column
# 32u + 4g + j. Lane arrays below are indexed [g, t].

_G, _T = np.arange(8)[:, None], np.arange(4)[None, :]


def _bm_column(u, g, j):
    """Tile column of n-tile j's column g in warp group u."""
    return 32 * u + 4 * g + j


def _transpose4(words):
    """transpose4: word j of the result holds byte j of each input word e
    at byte e."""
    out = []
    for j in range(4):
        w = np.zeros_like(words[0])
        for e in range(4):
            w |= ((words[e] >> U32(8 * j)) & U32(0xFF)) << U32(8 * e)
        out.append(w)
    return out


def _plane_bits(w, k, extract):
    k = np.asarray(k, dtype=U32)
    if extract == "loop":
        b = np.zeros(np.broadcast(w, k).shape, dtype=U32)
        for e in range(4):
            b |= (((w >> U32(8 * e)) & U32(0xFF)) >> k & U32(1)) << U32(8 * e)
        return b
    if extract == "bcast":
        return (w >> k) & U32(0x01010101)
    masked = w & (U32(0x01010101) << k)  # bool: __vcmpne4 against 0, & 0x01010101
    b = np.zeros(masked.shape, dtype=U32)
    for e in range(4):
        b |= np.where((masked >> U32(8 * e)) & U32(0xFF), U32(1) << U32(8 * e), U32(0))
    return b


def _lane_b_registers(stage, q, u, extract):
    """The four n-tiles' (b0, b1) registers of every lane for K chunk q,
    from one word of each of rows 4q .. 4q+3 at byte 32u + 4g."""
    words = [stage[4 * q + e, 32 * u: 32 * u + 32].copy().view("<u4")[:, None] for e in range(4)]
    x4 = _transpose4(words)  # each (8, 1): rows 4q .. 4q+3 of column 32u + 4g + j
    return [(_plane_bits(x4[j], _T, extract), _plane_bits(x4[j], 4 + _T, extract))
            for j in range(4)]


def _b_tile(b0, b1):
    """The (32, 8) B operand of m16n8k32 that lanes' s8 registers form:
    lane (g, t) holds K rows 4t .. 4t+3 (b0) and 16+4t .. 16+4t+3 (b1) of
    column g."""
    tile = np.zeros((32, 8), dtype=np.int64)
    for g in range(8):
        for t in range(4):
            for e in range(4):
                tile[4 * t + e, g] = (int(b0[g, t]) >> (8 * e)) & 0xFF
                tile[16 + 4 * t + e, g] = (int(b1[g, t]) >> (8 * e)) & 0xFF
    return tile


def _repack(d):
    """d[j]: n-tile j's (16, 8) accumulator. Lane (g, t) holds element e
    at row g + 8 (e // 2), column 2t + e % 2; for each e the prmt puts the
    four n-tiles' sums in bytes j, & 1 moves them to bit g, the shuffles OR
    over g -> {(row, first column): 8 bytes} that lane t of g = 0 stores."""
    v = []
    for e in range(4):
        rows, cols = _G + 8 * (e // 2), 2 * _T + e % 2
        lanes = sum(((d[j][rows, cols] & 1) << (8 * j)) for j in range(4)) << _G
        v.append(np.bitwise_or.reduce(lanes.astype(U32), axis=0))  # (4,) by t
    runs = {}
    for t in range(4):
        for half in (0, 1):
            runs[(half, 8 * t)] = np.array([v[2 * half][t], v[2 * half + 1][t]],
                                           dtype="<u4").view(np.uint8)
    return runs


def _emulate_bitmajor(coeff, x, tile, extract="bcast", probe=None):
    """(R, C) x (C, S) -> (R, S) as the kernel computes it, item by item."""
    r, c = coeff.shape
    rpad, cpad = gf_bitmajor.padded(r, c)
    w = gf_bitmajor.bitmajor_operand(coeff).astype(np.int64)
    s = x.shape[1]
    out = np.zeros((r, s), dtype=np.uint8)
    for col0 in range(0, s, tile):
        stage = np.zeros((cpad, tile), dtype=np.uint8)
        cols = min(tile, s - col0)
        stage[:c, :cols] = x[:, col0: col0 + cols]
        os_ = np.zeros((rpad, tile), dtype=np.uint8)
        for u in range(tile // 32):
            if col0 + 32 * u >= s:
                break
            if probe == "nodot":  # byte i of a column: plane-major rows 8i .. 8i+7
                for i in range(r):
                    for b in range(8):
                        k, cc = divmod(8 * i + b, c)
                        os_[i, 32 * u: 32 * u + 32] |= ((stage[cc, 32 * u: 32 * u + 32] >> k) & 1) << b
                continue
            d = [np.zeros((rpad // 2, 16, 8), dtype=np.int64) for _ in range(4)]
            for q in range(cpad // 4):
                regs = _lane_b_registers(stage, q, u, extract)
                for j in range(4):
                    if probe == "noext":  # x[0, column] as int8 in every K row
                        x0 = stage[0, _bm_column(u, np.arange(8), j)].view(np.int8).astype(np.int64)
                        b = np.broadcast_to(x0, (32, 8))
                    else:
                        b = _b_tile(*regs[j])
                    for mt in range(rpad // 2):
                        d[j][mt] += w[16 * mt: 16 * mt + 16, 32 * q: 32 * q + 32] @ b
            for mt in range(rpad // 2):
                for (half, c8), run in _repack([d[j][mt] for j in range(4)]).items():
                    os_[2 * mt + half, 32 * u + c8: 32 * u + c8 + 8] = run
        out[:, col0: col0 + cols] = os_[:r, :cols]
    return out


@pytest.mark.parametrize("tile", [32, 256, 1024])
def test_bitmajor_ntile_column_map_covers_each_column_once(tile):
    cols = [_bm_column(u, g, j) for u in range(tile // 32) for g in range(8) for j in range(4)]
    assert sorted(cols) == list(range(tile))
    # the 8 words a warp reads from one row are contiguous: 32 bytes, no bank conflict
    assert sorted({(_bm_column(0, g, 0) // 4) for g in range(8)}) == list(range(8))


@pytest.mark.parametrize("extract", ["loop", "bcast", "bool"])
def test_bitmajor_transposed_words_feed_reference_bits(extract):
    """After transpose4 each lane's registers are the K rows the operand's
    column order asks for: K row 4k + e of chunk q is plane k of shard row
    4q + e, as in the reference's plane-major bits (row k*C + c)."""
    rng = np.random.default_rng(7)
    c, tile = 12, 64
    stage = rng.integers(0, 256, (c, tile), dtype=np.uint8)
    planes = np.concatenate([(stage >> k) & 1 for k in range(8)])  # _kernel_bitmajor's bits
    for q in range(c // 4):
        for u in range(tile // 32):
            for j, (b0, b1) in enumerate(_lane_b_registers(stage, q, u, extract)):
                b = _b_tile(b0, b1)
                for g in range(8):
                    col = _bm_column(u, g, j)
                    want = [planes[k * c + 4 * q + e, col] for k in range(8) for e in range(4)]
                    assert list(b[:, g]) == want


def test_bitmajor_repack_runs_land_on_output_columns():
    rng = np.random.default_rng(8)
    d = [rng.integers(-300, 300, (16, 8)) for _ in range(4)]
    runs = _repack(d)
    for (half, c8), run in runs.items():
        for i in range(8):
            n, j = divmod(c8 + i, 4)  # tile column 4n + j (u = 0)
            want = sum(((d[j][8 * half + g, n] & 1) << g) for g in range(8))
            assert run[i] == want
    assert sorted(runs) == [(h, 8 * t) for h in (0, 1) for t in range(4)]


@pytest.mark.parametrize("probe", [None, "nodot", "noext"])
@pytest.mark.parametrize("name,r,c,s,tile", [("rows_2x12", 2, 12, 300, 128),
                                             ("random_5x9", 5, 9, 96, 64)])
def test_emulated_bitmajor_matches_reference(name, r, c, s, tile, probe):
    rng = np.random.default_rng(r * 100 + c)
    coeff = rng.integers(0, 256, (r, c), dtype=np.uint8)
    if name == "rows_2x12":
        coeff = np.ascontiguousarray(repair.make_plan(12, 4, [1, 7]).rows, dtype=np.uint8)
    x = rng.integers(0, 256, (c, s), dtype=np.uint8)
    got = _emulate_bitmajor(coeff, x, tile, probe=probe)
    if probe is None:  # the reference kernel body, on whole tiles (its grid is s // tile)
        whole = s // tile * tile
        out = np.zeros((r, whole), np.uint8)
        wb = jnp.asarray(ref_bitlin.w_to_bitmajor(ref_bitlin.gf_matrix_to_bits(coeff), r, c),
                         dtype=jnp.int8)
        pallas_tuning._kernel_bitmajor(True, wb, jnp.asarray(x[:, :whole]), out)
        assert np.array_equal(got[:, :whole], out)
        assert np.array_equal(got, ref_gf256.gf_matmul(coeff, x))
    want = gf_bitmajor.plain(coeff, torch.from_numpy(x), probe).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("extract", ["loop", "bool"])
def test_emulated_bitmajor_extractions_agree(extract):
    rng = np.random.default_rng(11)
    coeff = rng.integers(0, 256, (4, 12), dtype=np.uint8)
    x = rng.integers(0, 256, (12, 64), dtype=np.uint8)
    assert np.array_equal(_emulate_bitmajor(coeff, x, 64, extract),
                          ref_gf256.gf_matmul(coeff, x))


def _funnelshift_r(a, b, r):
    return ((int(b) << 32 | int(a)) >> r) & 0xFFFFFFFF


def _shift_out(lo, hi, sh):
    """shift_out: bytes sh .. sh+15 of the 32 bytes lo, hi (four words
    each), by whole-word selects, then funnel shifts."""
    v = [*lo, *hi]
    if sh & 8:
        v = v[2:]
    if sh & 4:
        v = v[1:]
    r = 8 * (sh & 3)
    return np.array([_funnelshift_r(v[m], v[m + 1], r) for m in range(4)], dtype="<u4")


def _load_tile(buf, base, s, c, tile, cols):
    """load_tile, lane by lane: the (c, tile) stage filled from rows
    buf[base + row * s:], the (row, piece) pairs taken, and the addresses
    of the aligned 16-byte words read."""
    stage = np.zeros((c, tile), dtype=np.uint8)
    taken, read = [], []
    pieces = -(-cols // 16)

    def word(a):
        read.append(a)
        return buf[a: a + 16].view("<u4")

    for lane in range(32):
        row, k = 0, lane
        while k >= pieces:
            k, row = k - pieces, row + 1
        while row < c:
            for _ in range(4):  # kBatch
                if row < c:
                    p = base + row * s + 16 * k
                    sh = p & 15
                    lo = word(p - sh)
                    hi = word(p - sh + 16) if sh and 16 * k + 16 - sh < cols else np.zeros(4, "<u4")
                    stage[row, 16 * k: 16 * k + 16] = _shift_out(lo, hi, sh).view(np.uint8)
                    taken.append((row, k))
                    k += 32
                    while k >= pieces:
                        k, row = k - pieces, row + 1
    return stage, taken, read


@pytest.mark.parametrize("s,base,cols,c", [
    (4096 + 123, 3 * 4096 + 1024, 1024, 12),   # S % 16 == 11: each row its own shift
    (4096 + 123, 4096, 123, 12),               # the ragged tail of a row, fewer pieces than lanes
    (4096, 5 * 16 + 5, 512, 5),                # a stripe stride that is not a multiple of 16
    (4096, 0, 1024, 4),                        # aligned rows: one word a piece
    (300, 7, 300, 3),                          # rows shorter than a warp's pieces
])
def test_bitmajor_unaligned_tile_load(s, base, cols, c):
    """The producer's own loads fill each row's first cols bytes, take
    each (row, piece) once, and read only aligned words that hold a byte
    of a row (such a word lies inside the row's allocation)."""
    rng = np.random.default_rng(s + base)
    buf = rng.integers(0, 256, base + c * s + 16, dtype=np.uint8)
    tile = -(-cols // 32) * 32
    stage, taken, read = _load_tile(buf, base, s, c, tile, cols)
    for row in range(c):
        assert np.array_equal(stage[row, :cols], buf[base + row * s: base + row * s + cols])
    assert sorted(taken) == [(row, k) for row in range(c) for k in range(-(-cols // 16))]
    for a in read:
        assert a % 16 == 0
        assert any(a < base + row * s + cols and a + 16 > base + row * s for row in range(c))


@pytest.mark.parametrize("r,c", [(2, 12), (4, 12), (36, 36)])
def test_bitmajor_ring_stages_and_shared_memory(r, c):
    """3 ring stages where they fit, else 2; the shared memory is the
    mbarriers, W in fragment order, the ring and two output stages."""
    rpad, cpad = gf_bitmajor.padded(r, c)
    for tile in gf_tuning.TILES:
        stages = gf_bitmajor.ring_stages(r, c, tile)
        fixed = 16 * 3 + 64 * rpad * cpad + 2 * rpad * tile
        assert (stages == 3) == (fixed + 3 * cpad * tile <= gf_bitmajor.MAX_SMEM_BYTES)
        assert stages in (2, 3)
        assert gf_bitmajor.smem_bytes(r, c, tile) == fixed + stages * cpad * tile
        fits = gf_bitmajor.smem_bytes(r, c, tile) <= gf_bitmajor.MAX_SMEM_BYTES
        if (r, c) == (36, 36):
            assert fits == (tile <= 1024)
            assert stages == (2 if tile >= 1024 else 3)
        else:
            assert fits and stages == 3
