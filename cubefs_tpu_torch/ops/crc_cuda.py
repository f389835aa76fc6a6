"""Wrapper of the batched CRC32 kernel (``csrc/crc32_blocks.cu``) and the
host half of its design.

The port's counterpart of ``cubefs_tpu/ops/pallas_crc.py`` (kernel and
fold in one launch). Its plain PyTorch version is
``crc32_kernel.crc32_blocks_plain``; ``crc32_kernel.crc32_blocks``
checks the blocks and chooses between them by the tensor's device. This
wrapper takes CUDA tensors only: it launches the kernel or raises.

The kernel's layout (the source note has the why): a warp owns a span of
``1024 * rows`` bytes of one block; lane l of the warp reads the 32-byte
pieces at span offsets ``32 l + 1024 i``, i < rows. Spans are laid out
from the END of the block, so the block's first span starts before its
first byte, and those bytes read as zeros (leading zeros leave the raw
CRC unchanged). Per piece a lane moves its raw CRC state across the
1024-byte stride and adds the piece's own raw CRC, both by tables
indexed by 5-bit fields (32 entries, one per shared-memory bank); at
the end each lane's state moves to the span end (per-lane column masks),
the warp XORs its lanes, and the span's CRC moves to the block end
(per-span column masks). Everything the kernel reads besides the blocks
is built here, with numpy, once per block length.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _build, crc32_kernel

LANES = 32
PIECE = 32  # bytes a lane reads per row, as two 16-byte loads
ROW = LANES * PIECE  # 1024: a warp's bytes per row, a lane's stride
MAX_ROWS = 8  # rows per span: 256 bytes a lane, 8 KiB a span
FIELD = 5  # bits per table index: a 32-word table spans the 32 banks


class Plan(NamedTuple):
    rows: int
    n_spans: int


def _columns(mat: np.ndarray) -> np.ndarray:
    """(32, 32) 0/1 GF(2) matrix -> its 32 column masks (uint32)."""
    shifted = mat.astype(np.uint64) << np.arange(32, dtype=np.uint64)[:, None]
    return shifted.sum(0).astype(np.uint32)


def apply_columns(cols: np.ndarray, x: np.ndarray) -> np.ndarray:
    """The matrix of column masks ``cols`` times each uint32 in ``x``."""
    x = np.asarray(x, dtype=np.uint32)
    out = np.zeros_like(x)
    for i in range(32):
        out ^= np.where((x >> np.uint32(i)) & np.uint32(1), cols[i], np.uint32(0))
    return out


def _field_tables(bit_images: np.ndarray) -> np.ndarray:
    """Image of each input bit (uint32) -> one 32-entry table per 5-bit
    field of the input: entry [f, n] is the XOR of the images of the set
    bits of n, bit k standing for input bit 5 f + k (bits past the end
    of the input are zero)."""
    n_fields = -(-len(bit_images) // FIELD)
    padded = np.zeros(n_fields * FIELD, dtype=np.uint32)
    padded[:len(bit_images)] = bit_images
    n = np.arange(1 << FIELD)
    out = np.zeros((n_fields, 1 << FIELD), dtype=np.uint32)
    for k in range(FIELD):
        out ^= np.where((n >> k) & 1, padded[k::FIELD][:, None], np.uint32(0))
    return out


@functools.cache
def data_tables() -> np.ndarray:
    """(52, 32) uint32: the raw CRC of a 32-byte piece is the XOR of one
    entry per 5-bit field of its 256 bits (little-endian words, field f
    = bits 5f..5f+4). Bit b of byte j maps to the byte table's entry for
    1 << b moved past the 31 - j bytes after it."""
    table = crc32_kernel._byte_table()
    images = np.zeros(8 * PIECE, dtype=np.uint32)
    for j in range(PIECE):
        after = _columns(crc32_kernel.zeros_matrix(PIECE - 1 - j))
        images[8 * j: 8 * j + 8] = apply_columns(after, table[1 << np.arange(8)])
    out = _field_tables(images)
    out.setflags(write=False)
    return out


@functools.cache
def gap_tables() -> np.ndarray:
    """(7, 32) uint32 field tables of A^1024: a lane's state moved across
    one row stride (its 32 bytes and the 992 of the other lanes)."""
    out = _field_tables(_columns(crc32_kernel.zeros_matrix(ROW)))
    out.setflags(write=False)
    return out


@functools.cache
def lane_columns() -> np.ndarray:
    """(32, 32) uint32, [bit i][lane l]: column i of A^(32 (31 - l)),
    which moves lane l's state from the end of its last piece to the end
    of the span. Bit-major, so a warp reading bit i hits 32 banks."""
    out = np.stack([_columns(crc32_kernel.zeros_matrix(PIECE * (LANES - 1 - lane)))
                    for lane in range(LANES)], axis=1)
    out.setflags(write=False)
    return out


@functools.cache
def consts() -> np.ndarray:
    """What every launch copies into shared memory, in the kernel's
    order: data tables (1664 words), gap tables (224), lane columns (1024)."""
    out = np.concatenate([data_tables().ravel(), gap_tables().ravel(), lane_columns().ravel()])
    out.setflags(write=False)
    return out


@functools.cache
def plan(block_len: int) -> Plan:
    """Rows per span and spans per block: 8 rows (8 KiB spans) for
    blocks of 8 KiB and up, fewer for shorter blocks."""
    n_pieces = -(-block_len // PIECE)
    rows = max(1, min(MAX_ROWS, -(-n_pieces // LANES)))
    return Plan(rows, -(-n_pieces // (LANES * rows)))


@functools.cache
def _device_consts(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(consts().view(np.int32).copy()).to(device)


@functools.lru_cache(maxsize=64)
def _device_span_cols(block_len: int, device: torch.device) -> torch.Tensor:
    p = plan(block_len)
    cols = crc32_kernel.shift_columns(ROW * p.rows, p.n_spans)  # span k -> block end
    return torch.from_numpy(cols.view(np.int32).copy()).to(device)


def crc32_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """(..., block_len) uint8 CUDA blocks -> (...) int64 holding each
    block's unsigned CRC32, bit-identical to zlib.crc32. Two leading dims
    of any stride are read in place (a block's own bytes must be
    contiguous); more are merged first."""
    if not blocks.is_cuda:
        raise ValueError(f"crc32_blocks launches a CUDA kernel; got a tensor on "
                         f"{blocks.device}")
    *lead, block_len = blocks.shape
    if not blocks.numel():  # no blocks, or empty ones: crc32(b"") == 0
        return torch.zeros(lead, dtype=torch.int64, device=blocks.device)
    x = blocks.reshape(-1, lead[-1], block_len) if len(lead) > 1 else blocks.unsqueeze(0)
    if x.stride(-1) != 1:
        x = x.contiguous()
    outer, inner = x.shape[0], x.shape[1]
    out = torch.zeros(outer * inner, dtype=torch.int64, device=blocks.device)
    p = plan(block_len)
    tables, cols = _device_consts(blocks.device), _device_span_cols(block_len, blocks.device)
    # a stride of a dim of size 1 is never followed; pass 0 so it cannot
    # spoil the kernel's alignment test
    strides = [st if n > 1 else 0 for st, n in zip(x.stride()[:2], x.shape[:2])]
    with torch.cuda.device(blocks.device):
        _build.launch("crc32_blocks", x.data_ptr(), outer, inner, *strides, out.data_ptr(),
                      tables.data_ptr(), cols.data_ptr(), crc32_kernel.crc32_zeros(block_len),
                      block_len, p.rows, p.n_spans, torch.cuda.current_stream().cuda_stream)
    return out.reshape(lead)  # the kernel XORs each CRC into the low half of its word
