"""Block cache: client-local read cache (bcache daemon role).

Role parity: client/blockcache — a local SSD LRU keyed by extent block
that accelerates repeated reads (bcache/manage.go LRU management). Here
a process-local tier in front of ExtentClient reads, optionally spilling
to a local directory.

The port's copy of ``cubefs_tpu/fs/blockcache.py``, with the same
behaviour.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import os

from ..utils import lockwitness
from collections import OrderedDict


class BlockCache:
    def __init__(self, capacity_bytes: int = 128 << 20,
                 spill_dir: str | None = None):
        self.capacity = capacity_bytes
        self.spill_dir = spill_dir
        self._lock = lockwitness.make_lock("BlockCache._lock")
        self._lru: OrderedDict[str, bytes | None] = OrderedDict()
        # spilled entries hold None in the LRU; their payload size is
        # tracked here so the capacity budget covers the spill dir too
        # (a laptop-local cache dir must not grow without bound)
        self._sizes: dict[str, int] = {}
        self._used = 0
        self.hits = 0
        self.misses = 0
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)

    def _path(self, key: str) -> str:
        h = hashlib.sha1(key.encode()).hexdigest()
        return os.path.join(self.spill_dir, h)

    def get(self, key: str) -> bytes | None:
        with self._lock:
            if key in self._lru:
                data = self._lru[key]
                self._lru.move_to_end(key)
                if data is None and self.spill_dir:  # spilled entry
                    data = self._load_spilled(key)
                    if data is None:
                        self.misses += 1
                        return None
                self.hits += 1
                return data
            self.misses += 1
            return None

    def _load_spilled(self, key: str) -> bytes | None:
        """Read a spill file back, verifying the stored digest — a
        truncated or bit-flipped file is dropped and reads as a miss,
        never served as data. Caller holds the lock."""
        try:
            raw = open(self._path(key), "rb").read()
            digest, data = raw[:20], raw[20:]
            if hashlib.sha1(data).digest() != digest:
                raise OSError("spill checksum mismatch")
            return data
        except OSError:
            del self._lru[key]
            self._used -= self._sizes.pop(key, 0)
            try:
                os.unlink(self._path(key))
            except OSError:
                pass
            return None

    def put(self, key: str, data: bytes) -> None:
        with self._lock:
            old = self._lru.pop(key, None)
            if old:
                self._used -= len(old)
            elif key in self._sizes:
                self._used -= self._sizes.pop(key)
            if self.spill_dir:
                with open(self._path(key), "wb") as f:
                    f.write(hashlib.sha1(data).digest())
                    f.write(data)
                self._lru[key] = None  # present on disk
                self._sizes[key] = len(data)
                self._used += len(data)
            else:
                self._lru[key] = data
                self._used += len(data)
            while self._used > self.capacity and self._lru:
                k, evicted = self._lru.popitem(last=False)
                if evicted:
                    self._used -= len(evicted)
                elif self.spill_dir:
                    self._used -= self._sizes.pop(k, 0)
                    try:
                        os.unlink(self._path(k))
                    except OSError:
                        pass

    def stats(self) -> dict:
        with self._lock:
            return {"items": len(self._lru), "bytes": self._used,
                    "hits": self.hits, "misses": self.misses}


class CachingExtentClient:
    """ExtentClient wrapper adding the local block cache on the read
    path (write path invalidates touched extents) plus sequential
    read-ahead (the streamer's stream_aheadread role): a cache miss on
    block k prefetches block k+1 in the background so streaming reads
    hide the fetch latency."""

    BLOCK = 128 << 10
    READAHEAD = 1  # blocks prefetched past a miss

    def __init__(self, inner, cache: BlockCache | None = None,
                 readahead: bool = True):
        self.inner = inner
        self.cache = cache or BlockCache()
        self.readahead = readahead
        self._prefetch_pool = concurrent.futures.ThreadPoolExecutor(2)
        # block -> in-flight Future so demand reads JOIN a running fetch
        # instead of re-issuing it; per-inode generation counters make a
        # racing fetch's put a no-op after a write invalidation
        self._inflight: dict[str, concurrent.futures.Future] = {}
        self._gen: dict[int, int] = {}
        self._pf_lock = lockwitness.make_lock("CachingExtentClient._pf_lock")

    def write(self, meta, ino: int, file_offset: int, data: bytes) -> None:
        self.inner.write(meta, ino, file_offset, data)
        # conservative invalidation: drop all cached blocks of this inode
        # and bump its generation so in-flight fetches can't repopulate
        # the cache with pre-write bytes
        with self._pf_lock:
            self._gen[ino] = self._gen.get(ino, 0) + 1
        with self.cache._lock:
            stale = [k for k in self.cache._lru if k.startswith(f"{ino}/")]
            for k in stale:
                v = self.cache._lru.pop(k)
                if v:
                    self.cache._used -= len(v)
                else:
                    self.cache._used -= self.cache._sizes.pop(k, 0)
                    if self.cache.spill_dir:
                        try:
                            os.unlink(self.cache._path(k))
                        except OSError:
                            pass

    def close_stream(self, ino: int) -> None:
        self.inner.close_stream(ino)

    def _dp_by_id(self, dp_id):
        return self.inner._dp_by_id(dp_id)

    def read(self, inode: dict, offset: int, length: int) -> bytes:
        size = inode["size"]
        if offset >= size:
            return b""
        length = min(length, size - offset)
        out = bytearray(length)
        pos = offset
        while pos < offset + length:
            block = pos // self.BLOCK
            in_block = pos % self.BLOCK
            take = min(offset + length - pos, self.BLOCK - in_block)
            key = f"{inode['ino']}/{block}"
            blk = self.cache.get(key)
            if blk is None:
                with self._pf_lock:
                    fut = self._inflight.get(key)
                if fut is not None:
                    try:  # join the running prefetch instead of re-reading
                        blk = fut.result()
                    except Exception:
                        blk = None
                if blk is None:
                    blk = self._fetch_block(inode, block, size)
                if self.readahead:
                    self._prefetch(inode, block + 1, size)
            out[pos - offset : pos - offset + take] = blk[in_block : in_block + take]
            pos += take
        return bytes(out)

    def _fetch_block(self, inode: dict, b: int, size: int) -> bytes:
        ino = inode["ino"]
        with self._pf_lock:
            gen = self._gen.get(ino, 0)
        data = self.inner.read(
            inode, b * self.BLOCK, min(self.BLOCK, size - b * self.BLOCK)
        )
        with self._pf_lock:
            fresh = self._gen.get(ino, 0) == gen
        if fresh:  # a write during the fetch means these bytes are stale
            self.cache.put(f"{ino}/{b}", data)
        return data

    def _prefetch(self, inode: dict, block: int, size: int) -> None:
        for b in range(block, block + self.READAHEAD):
            if b * self.BLOCK >= size:
                return
            key = f"{inode['ino']}/{b}"
            with self._pf_lock:
                if key in self._inflight or self.cache.get(key) is not None:
                    continue
                fut = concurrent.futures.Future()
                self._inflight[key] = fut

            def fetch(b=b, key=key, fut=fut):
                try:
                    fut.set_result(self._fetch_block(inode, b, size))
                except Exception as e:  # prefetch is best-effort
                    fut.set_exception(e)
                finally:
                    with self._pf_lock:
                        self._inflight.pop(key, None)

            self._prefetch_pool.submit(fetch)
