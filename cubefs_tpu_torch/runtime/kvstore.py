"""Pythonic facade over the native ordered-KV engine (ctypes).

The RocksDB choke point of the reference (blobstore/common/kvstorev2/
rocksdb.go, raftstore/raftstore_db/store_rocksdb.go) as a C++ runtime
component: crash-safe mutations (CRC-framed WAL + snapshot compaction)
and ordered range scans. Used by the shardnode's durable shards.

The port's copy of ``cubefs_tpu/runtime/kvstore.py``. The engine is
built from the port's copy of the reference's source
(``csrc/host/kvstore.cc``), so a store directory written by either
package opens in the other. g++ compiles it at first use into
``cubefs_tpu_torch/_build/`` (a library named by a hash of the source
and flags); a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import threading

from ..ops._build import SRC_DIR, build_host, host_lib_path

SOURCES = (os.path.join(SRC_DIR, "host", "kvstore.cc"),)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def lib_path() -> str:
    return host_lib_path("kvstore", SOURCES)


def load() -> ctypes.CDLL:
    """The bound KV library, built first if missing."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_host(lib_path(), SOURCES, "kv store library"))
            c = ctypes
            lib.kv_open.restype = c.c_void_p
            lib.kv_open.argtypes = [c.c_char_p]
            lib.kv_close.argtypes = [c.c_void_p]
            lib.kv_put.restype = c.c_int
            lib.kv_put.argtypes = [c.c_void_p, c.c_char_p, c.c_uint32,
                                   c.c_char_p, c.c_uint32]
            lib.kv_del.restype = c.c_int
            lib.kv_del.argtypes = [c.c_void_p, c.c_char_p, c.c_uint32]
            lib.kv_get.restype = c.c_int64
            lib.kv_get.argtypes = [c.c_void_p, c.c_char_p, c.c_uint32,
                                   c.c_void_p, c.c_uint32]
            lib.kv_count.restype = c.c_uint64
            lib.kv_count.argtypes = [c.c_void_p]
            lib.kv_scan.restype = c.c_int64
            lib.kv_scan.argtypes = [
                c.c_void_p, c.c_char_p, c.c_uint32, c.c_char_p, c.c_uint32,
                c.c_uint32, c.c_void_p, c.c_uint32,
                c.POINTER(c.c_uint32), c.POINTER(c.c_uint32)]
            lib.kv_median.restype = c.c_int64
            lib.kv_median.argtypes = [c.c_void_p, c.c_char_p, c.c_uint32,
                                      c.c_char_p, c.c_uint32, c.c_void_p,
                                      c.c_uint32]
            lib.kv_batch.restype = c.c_int64
            lib.kv_batch.argtypes = [c.c_void_p, c.c_char_p, c.c_uint64]
            lib.kv_compact.restype = c.c_int
            lib.kv_compact.argtypes = [c.c_void_p]
            lib.kv_clear.restype = c.c_int
            lib.kv_clear.argtypes = [c.c_void_p]
            lib.kv_wal_bytes.restype = c.c_uint64
            lib.kv_wal_bytes.argtypes = [c.c_void_p]
            lib.kv_snap_bytes.restype = c.c_uint64
            lib.kv_snap_bytes.argtypes = [c.c_void_p]
            _lib = lib
        return _lib


class KvError(Exception):
    pass


def _key(key: bytes | str) -> bytes:
    return key.encode() if isinstance(key, str) else key


class KvStore:
    def __init__(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        self._lib = load()
        self._h = self._lib.kv_open(directory.encode())
        if not self._h:
            raise KvError(f"cannot open kv store at {directory}")
        self.directory = directory

    def close(self) -> None:
        if self._h:
            self._lib.kv_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- mutations ----
    def put(self, key: bytes | str, value: bytes) -> None:
        k = _key(key)
        if self._lib.kv_put(self._h, k, len(k), value, len(value)) != 0:
            raise KvError(f"put {k!r} failed (WAL write error)")

    def delete(self, key: bytes | str) -> None:
        k = _key(key)
        r = self._lib.kv_del(self._h, k, len(k))
        if r == -1:
            raise KeyError(k)
        if r != 0:
            raise KvError(f"delete {k!r} failed (WAL write error)")

    # ---- reads ----
    def get(self, key: bytes | str) -> bytes:
        k = _key(key)
        cap = 4096
        while True:
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.kv_get(self._h, k, len(k), buf, cap)
            if n < 0:
                raise KeyError(k)
            if n <= cap:
                return buf.raw[:n]
            cap = int(n)  # value longer than the buffer: retry exact

    def __contains__(self, key: bytes | str) -> bool:
        try:
            self.get(key)
            return True
        except KeyError:
            return False

    def count(self) -> int:
        return int(self._lib.kv_count(self._h))

    def apply_batch(self, ops) -> None:
        """Atomically applies [(op, key, value)] — op "put"/"delete" —
        with a single WAL append + fsync (splits move ranges this way
        instead of paying a sync per key)."""
        blob = bytearray()
        for op, key, value in ops:
            k = _key(key)
            v = value or b""
            blob.append(1 if op == "put" else 2)
            blob += len(k).to_bytes(4, "little")
            blob += len(v).to_bytes(4, "little")
            blob += k
            blob += v
        if not blob:
            return
        n = self._lib.kv_batch(self._h, bytes(blob), len(blob))
        if n != len(ops):
            raise KvError(f"batch applied {n}/{len(ops)}")

    def scan(self, start: bytes = b"", end: bytes = b"",
             max_items: int = 1 << 30):
        """Yields (key, value) over [start, end) in key order, paging
        through the native boundary in bounded chunks. The page buffer
        grows when a single record exceeds it (a fat value must never
        silently truncate the scan — range moves and snapshots rely on
        completeness)."""
        remaining = max_items
        cap = 1 << 20
        buf = ctypes.create_string_buffer(cap)
        n_out = ctypes.c_uint32()
        more = ctypes.c_uint32()
        while remaining > 0:
            used = self._lib.kv_scan(
                self._h, start, len(start), end, len(end),
                min(remaining, 10_000), buf, cap,
                ctypes.byref(n_out), ctypes.byref(more))
            if used < 0:
                raise KvError("scan failed")
            if n_out.value == 0 and more.value:
                # first record alone exceeds the buffer: grow and retry
                if cap >= 1 << 31:
                    raise KvError("record exceeds 2 GiB scan buffer")
                cap *= 4
                buf = ctypes.create_string_buffer(cap)
                continue
            off = 0
            raw = buf.raw
            last_key = None
            for _ in range(n_out.value):
                klen = int.from_bytes(raw[off:off + 4], "little")
                vlen = int.from_bytes(raw[off + 4:off + 8], "little")
                off += 8
                key = raw[off:off + klen]
                off += klen
                val = raw[off:off + vlen]
                off += vlen
                last_key = key
                yield key, val
                remaining -= 1
            if not more.value or last_key is None:
                return
            start = last_key + b"\x00"

    def median_key(self, start: bytes = b"", end: bytes = b"") -> bytes | None:
        cap = 1 << 16
        buf = ctypes.create_string_buffer(cap)
        n = self._lib.kv_median(self._h, start, len(start), end, len(end),
                                buf, cap)
        return None if n < 0 else buf.raw[:n]

    # ---- maintenance ----
    def compact(self) -> None:
        if self._lib.kv_compact(self._h) != 0:
            raise KvError("compact failed")

    def clear(self) -> None:
        if self._lib.kv_clear(self._h) != 0:
            raise KvError("clear failed")

    def wal_bytes(self) -> int:
        return int(self._lib.kv_wal_bytes(self._h))

    def snap_bytes(self) -> int:
        return int(self._lib.kv_snap_bytes(self._h))
