"""Wrapper of the batched CRC32 kernel (``csrc/crc32_blocks.cu``).

The port's counterpart of ``cubefs_tpu/ops/pallas_crc.py`` (kernel and
fold in one launch). Its plain PyTorch version is
``crc32_kernel.crc32_blocks_plain``; ``crc32_kernel.crc32_blocks``
checks the blocks and chooses between them by the tensor's device. This
wrapper takes CUDA tensors only: it launches the kernel or raises.
"""

from __future__ import annotations

import functools

import torch

from . import _build, crc32_kernel


@functools.lru_cache(maxsize=64)
def _device_shift_cols(chunk_len: int, n_chunks: int, device: torch.device) -> torch.Tensor:
    cols = crc32_kernel.shift_columns(chunk_len, n_chunks)
    return torch.from_numpy(cols.view("int32").copy()).to(device)


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
    out = torch.zeros(outer * inner, dtype=torch.int32, device=blocks.device)
    chunk_len = crc32_kernel.fit_chunk_len(crc32_kernel.CHUNK_LEN, block_len)
    n_chunks = block_len // chunk_len
    cols = _device_shift_cols(chunk_len, n_chunks, blocks.device)
    # a stride of a dim of size 1 is never followed; pass 0 so it cannot
    # spoil the kernel's alignment test
    strides = [st if n > 1 else 0 for st, n in zip(x.stride()[:2], x.shape[:2])]
    with torch.cuda.device(blocks.device):
        _build.launch("crc32_blocks", x.data_ptr(), outer, inner, *strides,
                      out.data_ptr(), cols.data_ptr(), crc32_kernel.crc32_zeros(block_len),
                      n_chunks, chunk_len, torch.cuda.current_stream().cuda_stream)
    # the kernel writes uint32 bit patterns; widen them to non-negative int64
    return (out.to(torch.int64) & 0xFFFFFFFF).reshape(lead)
