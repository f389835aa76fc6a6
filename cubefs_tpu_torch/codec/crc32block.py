"""crc32block: per-64KiB-block CRC framing for blob payloads.

Role parity: blobstore/common/crc32block (block.go, encode.go/decode.go),
as in the JAX package's ``cubefs_tpu/codec/crc32block.py``. A block UNIT
is [crc32 LE u32][payload], and the block size (default 64KiB) INCLUDES
the 4 CRC bytes, so each full unit carries 64Ki-4 payload bytes.

``verify_batch`` re-CRCs many equal-sized frames in one batched call to
``crc32_kernel.crc32_blocks``: the CUDA kernel for frames on the card.
"""

from __future__ import annotations

import zlib

import torch

from ..ops import crc32_kernel

BLOCK = 64 << 10  # unit size INCLUDING the leading 4-byte CRC
CRC_LEN = 4


class CrcFrameError(Exception):
    pass


def encoded_size(n: int, block: int = BLOCK) -> int:
    payload = block - CRC_LEN
    return n + CRC_LEN * ((n + payload - 1) // payload) if n else 0


def decoded_size(n: int, block: int = BLOCK) -> int:
    blocks, rem = divmod(n, block)
    if rem == 0:
        return blocks * (block - CRC_LEN)
    if rem <= CRC_LEN:
        raise CrcFrameError(f"frame tail of {rem} bytes is not a block")
    return blocks * (block - CRC_LEN) + rem - CRC_LEN


def encode(data: bytes, block: int = BLOCK) -> bytes:
    payload = block - CRC_LEN
    out = bytearray()
    for off in range(0, len(data), payload):
        chunk = data[off : off + payload]
        out += zlib.crc32(chunk).to_bytes(4, "little")
        out += chunk
    return bytes(out)


def decode(frame: bytes, block: int = BLOCK) -> bytes:
    out = bytearray()
    if len(frame) % block and len(frame) % block <= CRC_LEN:
        raise CrcFrameError("truncated frame")
    for off in range(0, len(frame), block):
        rec = frame[off : off + block]
        crc_raw, chunk = rec[:CRC_LEN], rec[CRC_LEN:]
        if zlib.crc32(chunk) != int.from_bytes(crc_raw, "little"):
            raise CrcFrameError(f"crc mismatch in block at offset {off}")
        out += chunk
    return bytes(out)


def verify_batch(frames: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """frames: (B, frame_len) uint8 equal-length frames of FULL blocks
    -> (B,) bool per-frame validity, on the frames' device, from one
    batched CRC call."""
    b, frame_len = frames.shape
    if frame_len % block:
        raise CrcFrameError(f"frame length {frame_len} not whole blocks")
    recs = frames.reshape(b, frame_len // block, block)
    crcs = crc32_kernel.crc32_blocks(recs[:, :, CRC_LEN:])  # payloads, read in place
    le = recs[:, :, :CRC_LEN].to(torch.int64) << torch.arange(
        0, 32, 8, dtype=torch.int64, device=frames.device)
    return (crcs == le.sum(-1)).all(dim=1)
