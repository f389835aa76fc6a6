"""Pythonic facade over the native chunk-store engine (ctypes).

The blobnode disk engine (reference: blobstore/blobnode/core chunk files
+ shard meta KV) as a C++ runtime component; this wrapper adds typed
errors and numpy-friendly buffers.

The port's copy of ``cubefs_tpu/blob/chunkstore.py``. The engine is
built from the port's copies of the reference's native sources
(``csrc/host/chunkstore.cc``, ``bufpool.{h,cc}``, ``crc32cpu.cc``), so a
store directory written by either package opens in the other. g++
compiles them at first use into ``cubefs_tpu_torch/_build/`` (a
library named by a hash of the sources and flags); a failed build
raises. Every read checks the shard's CRC natively.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ..ops._build import SRC_DIR, build_host, host_lib_path
from ..utils import metrics

SOURCES = tuple(os.path.join(SRC_DIR, "host", f)
                for f in ("chunkstore.cc", "bufpool.cc", "crc32cpu.cc"))

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def lib_path() -> str:
    return host_lib_path("chunkstore", SOURCES)


def load() -> ctypes.CDLL:
    """The bound chunk-store library, built first if missing."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_host(lib_path(), SOURCES, "chunk store library"))
            c = ctypes
            lib.cs_open.restype = c.c_void_p
            lib.cs_open.argtypes = [c.c_char_p]
            lib.cs_close.argtypes = [c.c_void_p]
            lib.cs_last_error.restype = c.c_char_p
            lib.cs_last_error.argtypes = [c.c_void_p]
            lib.cs_create_chunk.argtypes = [c.c_void_p, c.c_uint64]
            lib.cs_put_shard.argtypes = [
                c.c_void_p, c.c_uint64, c.c_uint64,
                c.c_char_p, c.c_uint32, c.POINTER(c.c_uint32),
            ]
            lib.cs_get_shard.restype = c.c_int64
            lib.cs_get_shard.argtypes = [
                c.c_void_p, c.c_uint64, c.c_uint64,
                c.c_void_p, c.c_uint32, c.POINTER(c.c_uint32),
            ]
            lib.cs_delete_shard.argtypes = [c.c_void_p, c.c_uint64, c.c_uint64]
            lib.cs_list_shards.restype = c.c_int64
            lib.cs_list_shards.argtypes = [
                c.c_void_p, c.c_uint64,
                c.c_void_p, c.c_void_p, c.c_void_p, c.c_int64,
            ]
            lib.cs_shard_count.restype = c.c_int64
            lib.cs_shard_count.argtypes = [c.c_void_p, c.c_uint64]
            lib.cs_sync.argtypes = [c.c_void_p, c.c_uint64]
            lib.cs_crc32.restype = c.c_uint32
            lib.cs_crc32.argtypes = [c.c_char_p, c.c_uint64]
            lib.cs_compact_chunk.restype = c.c_int64
            lib.cs_compact_chunk.argtypes = [c.c_void_p, c.c_uint64]
            _lib = lib
        return _lib


class _ReadBuffer(threading.local):
    buf: ctypes.Array | None = None


_READ = _ReadBuffer()


def _read_buffer(n: int) -> ctypes.Array:
    """The calling thread's read buffer, at least ``n`` bytes: a read
    copies out only the shard's bytes, so the buffer is reused instead
    of a fresh ``max_size`` allocation (and its page faults) per read."""
    if _READ.buf is None or len(_READ.buf) < n:
        _READ.buf = ctypes.create_string_buffer(n)
    return _READ.buf


class ChunkStoreError(Exception):
    pass


class CrcMismatchError(ChunkStoreError):
    pass


class ShardNotFoundError(ChunkStoreError):
    pass


class ChunkStore:
    def __init__(self, directory: str):
        self._lib = load()
        self._h = self._lib.cs_open(directory.encode())
        if not self._h:
            raise ChunkStoreError(f"cannot open store at {directory}")
        self.directory = directory

    def _err(self) -> str:
        return (self._lib.cs_last_error(self._h) or b"").decode()

    def close(self) -> None:
        if self._h:
            self._lib.cs_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def create_chunk(self, chunk_id: int) -> None:
        if self._lib.cs_create_chunk(self._h, chunk_id) != 0:
            raise ChunkStoreError(self._err())

    def put_shard(self, chunk_id: int, bid: int, data: bytes | np.ndarray) -> int:
        buf = data.tobytes() if isinstance(data, np.ndarray) else bytes(data)
        crc = ctypes.c_uint32()
        rc = self._lib.cs_put_shard(
            self._h, chunk_id, bid, buf, len(buf), ctypes.byref(crc)
        )
        if rc != 0:
            raise ChunkStoreError(self._err())
        return crc.value

    def get_shard(self, chunk_id: int, bid: int, max_size: int = 16 << 20) -> tuple[bytes, int]:
        buf = _read_buffer(max_size)
        crc = ctypes.c_uint32()
        rc = self._lib.cs_get_shard(
            self._h, chunk_id, bid, buf, max_size, ctypes.byref(crc)
        )
        if rc == -2:
            raise CrcMismatchError(self._err())
        if rc == -3:
            raise ChunkStoreError(self._err())
        if rc < 0:
            raise ShardNotFoundError(self._err())
        return ctypes.string_at(buf, rc), crc.value

    def delete_shard(self, chunk_id: int, bid: int) -> None:
        if self._lib.cs_delete_shard(self._h, chunk_id, bid) != 0:
            raise ShardNotFoundError(self._err())

    def list_shards(self, chunk_id: int, cap: int = 1 << 20) -> list[tuple[int, int, int]]:
        n = self._lib.cs_shard_count(self._h, chunk_id)
        if n < 0:
            raise ChunkStoreError(self._err())
        n = min(n, cap)
        bids = (ctypes.c_uint64 * n)()
        sizes = (ctypes.c_uint32 * n)()
        crcs = (ctypes.c_uint32 * n)()
        got = self._lib.cs_list_shards(self._h, chunk_id, bids, sizes, crcs, n)
        if got < 0:
            raise ChunkStoreError(self._err())
        return [(bids[i], sizes[i], crcs[i]) for i in range(got)]

    def shard_count(self, chunk_id: int) -> int:
        n = self._lib.cs_shard_count(self._h, chunk_id)
        if n < 0:
            raise ChunkStoreError(self._err())
        return n

    def compact(self, chunk_id: int) -> int:
        """Rewrite live shards into fresh files (reclaims tombstoned and
        overwritten space); returns bytes reclaimed."""
        got = self._lib.cs_compact_chunk(self._h, chunk_id)
        if got < 0:
            raise ChunkStoreError(self._err())
        return got

    def sync(self, chunk_id: int) -> None:
        if self._lib.cs_sync(self._h, chunk_id) != 0:
            raise ChunkStoreError(self._err())


def verified_get_shard(store: ChunkStore, chunk_id: int, bid: int,
                       max_size: int = 16 << 20, *,
                       node_addr: str | None = None, disk_id: int = 0,
                       source: str = "read") -> tuple[bytes, int]:
    """The ONE sanctioned at-rest shard read outside this module: the
    native per-shard CRC check runs on every read, planted at-rest chaos
    faults (``faultinject.FaultPlan.plant_rot`` on ``node_addr`` and
    ``disk_id``) surface the same way, and every mismatch lands in
    cubefs_integrity_corruptions_detected_total{plane="blob"} before the
    CrcMismatchError propagates to the 409 EC-reconstruction path."""
    from ..utils import faultinject

    if node_addr is not None:
        plan = faultinject.current()
        if plan is not None:
            unit = f"c{chunk_id}:b{bid}"
            kind = plan.at_rest_fault(node_addr, disk_id, unit)
            if kind is not None:
                metrics.integrity_corruptions_detected.inc(
                    plane="blob", source=source)
                raise CrcMismatchError(
                    f"shard {unit}: at-rest {kind}")
    try:
        return store.get_shard(chunk_id, bid, max_size)
    except CrcMismatchError:
        metrics.integrity_corruptions_detected.inc(
            plane="blob", source=source)
        raise


def cpu_crc32(data: bytes) -> int:
    """The native store's CRC32 (zlib's), as it stamps every shard."""
    return load().cs_crc32(data, len(data))
