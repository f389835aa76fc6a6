"""Extent store facade (datanode disk engine, native-backed).

Role parity: datanode/storage — 128MiB extents, random-offset writes,
per-128KiB-block CRC32 headers, whole-extent crc-of-crcs
(extent_store.go:665 Write / Read:765, extent.go CRC header,
autoComputeExtentCrc:718). ``block_crcs()`` reads an extent's block CRC
table out; nothing in either package feeds it to the batched CRC kernel
yet (every block is checked on the host, natively, as it is read).

Every native call (and its error fetch) runs under a store-level lock
with a liveness check, so close() racing in-flight ops — e.g. a raft
apply arriving while the node shuts down — raises ExtentError instead
of handing the C engine a freed handle.

The port's copy of ``cubefs_tpu/fs/extent_store.py``. The engine is
the port's copy of the reference's (``csrc/host/extentstore.cc``, built
by ``runtime/fsnative.py``), so an extent directory written by either
package opens in the other; a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import time
import zlib

import numpy as np

from ..runtime import fsnative as rt
from ..utils import lockwitness

BLOCK_SIZE = 128 * 1024


class ExtentError(Exception):
    pass


class BlockCrcError(ExtentError):
    pass


class ExtentStore:
    def __init__(self, directory: str):
        self._lib = rt.load()
        self._lock = lockwitness.make_rlock("ExtentStore._lock")
        self._h = self._lib.es_open(directory.encode())
        if not self._h:
            raise ExtentError(f"cannot open extent store at {directory}")
        self.directory = directory

    def _err(self) -> str:
        # caller holds self._lock with the handle verified live
        return (self._lib.es_last_error(self._h) or b"").decode()

    def _handle(self):
        h = self._h
        if not h:
            raise ExtentError(f"extent store {self.directory} is closed")
        return h

    @property
    def handle(self):
        """Raw native store handle for the C++ read plane (dataserve.cc)
        — the registrar must ds_drop the partition BEFORE close()."""
        return self._h

    def close(self) -> None:
        with self._lock:
            if self._h:
                self._lib.es_close(self._h)
                self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def create(self, extent_id: int) -> None:
        with self._lock:
            if self._lib.es_create(self._handle(), extent_id) != 0:
                raise ExtentError(self._err())

    def write(self, extent_id: int, offset: int, data: bytes | np.ndarray) -> None:
        buf = data.tobytes() if isinstance(data, np.ndarray) else bytes(data)
        if not buf:
            return  # es_write dereferences the payload even at len 0
        with self._lock:
            if self._lib.es_write(self._handle(), extent_id, offset, buf,
                                  len(buf)) != 0:
                raise ExtentError(self._err())

    def read(self, extent_id: int, offset: int, length: int) -> bytes:
        buf = ctypes.create_string_buffer(length)
        with self._lock:
            rc = self._lib.es_read(self._handle(), extent_id, offset, buf,
                                   length)
            err = self._err() if rc < 0 else None
        if rc == -2:
            raise BlockCrcError(err)
        if rc < 0:
            raise ExtentError(err)
        return buf.raw[:rc]

    def size(self, extent_id: int) -> int:
        with self._lock:
            return self._lib.es_size(self._handle(), extent_id)

    def block_crcs(self, extent_id: int) -> np.ndarray:
        n = (self.size(extent_id) + BLOCK_SIZE - 1) // BLOCK_SIZE
        out = np.zeros(max(n, 1), dtype=np.uint32)
        with self._lock:
            got = self._lib.es_block_crcs(
                self._handle(), extent_id,
                out.ctypes.data_as(ctypes.c_void_p), out.size
            )
            err = self._err() if got < 0 else None
        if got < 0:
            raise ExtentError(err)
        return out[:got]

    def extent_crc(self, extent_id: int) -> int:
        """CRC-of-block-CRCs: the whole-extent fingerprint used for
        replica diffing (repair decides by comparing these)."""
        return zlib.crc32(self.block_crcs(extent_id).tobytes())

    def list_extents(self) -> list[int]:
        """Extent ids present on disk (replica-rebuild work list)."""
        import os

        out = []
        for name in os.listdir(self.directory):
            if name.startswith("e_") and name.endswith(".data"):
                out.append(int(name[2:-5], 16))
        return sorted(out)

    def extent_age(self, extent_id: int) -> float:
        """Seconds since the extent's data file was last written (orphan
        reclaim uses this as the in-flight-write grace signal)."""
        path = os.path.join(self.directory, f"e_{extent_id:016x}.data")
        try:
            return max(0.0, time.time() - os.stat(path).st_mtime)
        except OSError:
            return 0.0  # unknown: treat as brand new (never reclaim)

    def delete(self, extent_id: int) -> None:
        with self._lock:
            if self._lib.es_delete(self._handle(), extent_id) != 0:
                raise ExtentError(self._err())

    def sync(self, extent_id: int) -> None:
        with self._lock:
            if self._lib.es_sync(self._handle(), extent_id) != 0:
                raise ExtentError(self._err())


def verified_read(store: ExtentStore, extent_id: int, offset: int,
                  length: int, *, node_addr: str | None = None,
                  disk_id: int = 0, unit: str | None = None,
                  source: str = "read") -> bytes:
    """The ONE sanctioned at-rest payload read outside this module
    (lint family CFI): the native per-128KiB-block CRC check runs on
    every read, planted at-rest chaos faults surface the same way, and
    every mismatch lands in
    cubefs_integrity_corruptions_detected_total{plane="fs"} before the
    BlockCrcError propagates to the 409 failover path."""
    from ..utils import faultinject, metrics

    if node_addr is not None and unit is not None:
        plan = faultinject.current()
        if plan is not None:
            kind = plan.at_rest_fault(node_addr, disk_id, unit)
            if kind is not None:
                metrics.integrity_corruptions_detected.inc(
                    plane="fs", source=source)
                raise BlockCrcError(
                    f"extent {extent_id}: at-rest {kind} on {unit}")
    try:
        return store.read(extent_id, offset, length)
    except BlockCrcError:
        metrics.integrity_corruptions_detected.inc(
            plane="fs", source=source)
        raise
