"""Proxy: per-IDC allocation cache in front of clustermgr.

Role parity: blobstore/proxy (volume+BID allocator cache,
proxy/allocator/; async-message producer, proxy/mq — here the queues
are handed in directly). Access asks the proxy for (volume, bid-range)
leases; the proxy prefetches from clustermgr in batches so the hot PUT
path doesn't pay a control-plane round trip per blob.

The port's copy of ``cubefs_tpu/blob/proxy.py``, served by the role
``proxy`` of ``cubefs_tpu_torch/cmd.py``.
"""

from __future__ import annotations

import uuid

from ..utils import lockwitness, rpc
from .types import VolumeInfo


class ProxyAllocator:
    BID_BATCH = 1024
    VOLUME_REUSE = 64  # blobs per cached volume before rotating

    def __init__(self, cm_client: rpc.Client):
        self.cm = cm_client
        self._lock = lockwitness.make_lock("ProxyAllocator._lock")
        self._bid_next = 0
        self._bid_end = 0
        self._vols: dict[int, tuple[VolumeInfo, int]] = {}  # mode -> (vol, blobs)

    def alloc(self, codemode: int, blob_count: int) -> tuple[VolumeInfo, int]:
        """Returns (volume, first_bid) for blob_count consecutive bids.

        Control-plane RPCs happen OUTSIDE the mutex (double-checked
        install) — a slow clustermgr must not serialize the hot path."""
        return (self._vol(int(codemode), blob_count),
                self._bids(blob_count))

    def _vol(self, mode: int, blob_count: int) -> VolumeInfo:
        with self._lock:
            cached = self._vols.get(mode)
            if cached is not None:
                vol, used = cached
                if used + blob_count <= self.VOLUME_REUSE:
                    self._vols[mode] = (vol, used + blob_count)
                    return vol
        meta, _ = self.cm.call("alloc_volume", {"codemode": mode,
                                                "op_id": uuid.uuid4().hex})
        vol = VolumeInfo.from_dict(meta["volume"])
        with self._lock:
            # another thread may have installed a fresher volume; ours
            # still works (extra volume, no correctness issue)
            self._vols[mode] = (vol, blob_count)
        return vol

    def _bids(self, count: int) -> int:
        with self._lock:
            if self._bid_next + count <= self._bid_end:
                first = self._bid_next
                self._bid_next += count
                return first
        batch = max(self.BID_BATCH, count)
        meta, _ = self.cm.call("alloc_bids", {"count": batch,
                                              "op_id": uuid.uuid4().hex})
        with self._lock:
            # install the fresh lease; serve this request from its head
            self._bid_next = meta["start"] + count
            self._bid_end = meta["start"] + batch
            return meta["start"]

    def invalidate_volume(self, codemode: int) -> None:
        """Drop the cached volume (e.g. after write failures against it)."""
        with self._lock:
            self._vols.pop(int(codemode), None)

    # ---------------- RPC surface ----------------
    def rpc_alloc(self, args, body):
        vol, first = self.alloc(args["codemode"], args["count"])
        return {"volume": vol.to_dict(), "min_bid": first}

    def rpc_invalidate(self, args, body):
        self.invalidate_volume(args["codemode"])
        return {}
