"""TieringEngine: the crash-safe fs->blob cold-data bridge.

Role parity: sdk/data/blobstore (the reference's BlobStoreClient
wrapping access.API — the ONE place the fs plane stores payload bytes
through the blob plane) plus lcnode/lc_transition.go's storage-class
transition, rebuilt as a two-phase state machine that survives a kill
at any point.

This module is the SOLE sanctioned blob-plane caller in the fs plane
(lint family CFD, tool/lint/checkers/tiering_discipline.py): every
blob put/get/delete the filesystem ever issues goes through here, so
the fencing, verification, and deferred-deletion invariants cannot be
bypassed by a second code path.

Migration protocol (state persisted in inode xattrs, every step an
idempotent op_id-carrying metanode apply — see fs/metanode.py
`_apply_tiering_*`):

    hot --prepare--> PREPARE --blob put + CRC verify-->
    --blob_written--> BLOB_WRITTEN --commit--> COMMITTED
    --finish--> cold (cold.location pinned, extents on the freelist)

Crash/race matrix (the chaos drill in tests/test_tiering.py kills the
engine at every phase boundary via faultinject.gate and races
writes/renames/unlinks):

  * killed after PREPARE          -> rescan aborts; file stays hot
  * killed after BLOB_WRITTEN     -> rescan re-verifies and rolls
                                     FORWARD (gen unchanged) or aborts
                                     + queues the blob (gen bumped)
  * killed after COMMITTED        -> rescan finishes (bookkeeping only)
  * write/rename racing any phase -> gen bump fences the commit; the
                                     write wins, the blob is queued for
                                     the orphan reaper
  * unlink racing any phase       -> rm_inode queues cold.location AND
                                     tiering.pending; nothing leaks
  * residual window: a crash BETWEEN the blob put landing and the
    blob_written record landing strands one blob until bucket-level
    inventory reconciliation (documented in README); every OTHER crash
    point is covered by the deferred blob freelist.

The hot copy is released only at COMMITTED — and only after the blob
copy was read back and byte-compared against the hot extents — so no
crash or fault can lose bytes.

The port's copy of ``cubefs_tpu/fs/tiering.py``: the blob plane it
writes to is the port's, whose ``AccessHandler`` encodes a tier PUT and
rebuilds a degraded cold read with kernel A on the card (``device="cpu"``
runs the plain versions).
"""

from __future__ import annotations

import json
import os
import zlib
from collections import OrderedDict

from ..blob.access import AccessHandler
from ..blob.types import Location
from ..utils import faultinject, lockwitness, metrics, qos
from ..utils import trace as tracelib


class _AccessAdapter:
    """Dict-location shim so the engine drives a bare AccessHandler
    exactly like the embedded BlobClient (blob/sdk.py) — tests wire the
    handler straight in, deployments pass the SDK client."""

    def __init__(self, handler: AccessHandler):
        self._h = handler

    def put(self, data: bytes, codemode: int | None = None,
            priority: int | None = None) -> dict:
        return self._h.put(data, codemode, priority=priority).to_dict()

    def get(self, location: dict, priority: int | None = None) -> bytes:
        return self._h.get(Location.from_dict(location), priority=priority)

    def delete(self, location: dict, priority: int | None = None) -> None:
        self._h.delete(Location.from_dict(location), priority=priority)


def _loc_of(cold) -> dict:
    return json.loads(cold) if isinstance(cold, str) else cold


class TieringEngine:
    """Drives migrations, read-through, re-heat, and orphan reaping for
    one FileSystem against one blob client."""

    HEAT_TRACK = 4096  # per-inode cold-read counters kept (LRU-bounded)

    def __init__(self, fs, blob, *, codemode: int | None = None,
                 untier_threshold: int | None = None):
        self.fs = fs
        if isinstance(blob, AccessHandler):
            blob = _AccessAdapter(blob)
        self.blob = blob
        self.codemode = codemode
        if untier_threshold is None:
            try:
                untier_threshold = int(
                    os.environ.get("CUBEFS_UNTIER_HOT", "3") or "3")
            except ValueError:
                untier_threshold = 3
        self.untier_threshold = max(1, untier_threshold)
        self._lock = lockwitness.make_lock("TieringEngine._lock")
        # cold-read hotness, same discipline as CachedReader._heat: an
        # LRU-bounded counter per inode; crossing the threshold marks
        # the inode a re-heat candidate the lifecycle scan promotes
        self._heat: OrderedDict[int, int] = OrderedDict()
        self._hot: set[int] = set()

    # ------------------------------------------------------- migration
    def migrate(self, ino: int) -> str:
        """Run (or resume) one cold-tier migration; returns the outcome
        tag recorded in cubefs_tiering_transitions_total."""
        with tracelib.path_span("tiering.migrate", "tiering.migrate") as sp:
            sp.set_tag("svc", "lcnode").set_tag("ino", ino)
            try:
                out = self._migrate(ino)
            except faultinject.InjectedCrash:
                metrics.tiering_transitions.inc(outcome="error")
                raise
            sp.set_tag("outcome", out)
            metrics.tiering_transitions.inc(outcome=out)
            return out

    def _migrate(self, ino: int) -> str:
        inode = self.fs.meta.inode_get(ino)
        if inode["xattr"].get("tiering.state") is not None:
            return self.resume(ino, inode)
        if inode["xattr"].get("cold.location"):
            return "already_cold"
        if qos.scrub_suppressed():
            # brownout: skip BEFORE reading payload bytes — the gate
            # would shed the SCRUB-class blob put anyway
            return "deferred"
        prep = self.fs.meta.tiering_prepare(ino)
        gen, size = prep["gen"], prep["size"]
        faultinject.gate("lcnode", "phase:prepared")
        data = b""
        crc = 0
        if size == 0:
            # empty files ride the same FSM with a sentinel location,
            # so they are migrated ONCE instead of rescanned forever
            location = {"empty": True, "size": 0}
        else:
            inode = self.fs.meta.inode_get(ino)
            with tracelib.stage("hot_read", path="tiering.migrate"):
                data = self.fs.data.read(inode, 0, size)
            crc = zlib.crc32(data)
            try:
                with tracelib.stage("blob_put", path="tiering.migrate"):
                    location = self.blob.put(
                        data, self.codemode, priority=qos.SCRUB)
            except qos.QosRejected:
                self.fs.meta.tiering_abort(ino)
                return "deferred"
        res = self.fs.meta.tiering_blob_written(ino, gen, location)
        if not res.get("ok"):
            return "fenced"
        faultinject.gate("lcnode", "phase:blob_written")
        if size:
            # byte-verify the blob copy BEFORE the hot extents can be
            # released: read it back and compare against what we stored
            with tracelib.stage("verify", path="tiering.migrate"):
                copy = self.blob.get(location, priority=qos.SCRUB)
            if zlib.crc32(copy) != crc or copy != data:
                self.fs.meta.tiering_abort(ino)  # queues the bad blob
                return "verify_failed"
        return self._commit(ino, gen, inode, size)

    def _commit(self, ino: int, gen: int, inode: dict | None,
                size: int) -> str:
        res = self.fs.meta.tiering_commit(ino, gen)
        if not res.get("ok"):
            return "fenced"
        faultinject.gate("lcnode", "phase:committed")
        if self.fs.read_cache is not None and inode is not None:
            # the released extents may be mirrored in the flash tier
            self.fs.read_cache.invalidate(inode.get("extents") or [])
        self.fs.data.close_stream(ino)
        self.fs.meta.tiering_finish(ino)
        metrics.tiering_bytes.inc(size, direction="cold")
        return "migrated"

    def resume(self, ino: int, inode: dict | None = None) -> str:
        """Recovery entry point: a rescan found tiering.state set (the
        previous run died mid-migration). Roll forward past the commit
        point, roll back before it."""
        if inode is None:
            inode = self.fs.meta.inode_get(ino)
        xa = inode["xattr"]
        st = xa.get("tiering.state")
        if st is None:
            return "noop"
        if st == "PREPARE":
            # no blob location recorded: nothing durable to salvage
            self.fs.meta.tiering_abort(ino)
            return "aborted"
        if st == "BLOB_WRITTEN":
            gen = xa.get("tiering.gen")
            if inode.get("gen", 0) != gen:
                self.fs.meta.tiering_abort(ino)  # write won the race
                return "aborted"
            pending = xa.get("tiering.pending") or {}
            size = inode["size"]
            if size and not pending.get("empty"):
                copy = self.blob.get(pending, priority=qos.SCRUB)
                hot = self.fs.data.read(inode, 0, size)
                if copy != hot:
                    self.fs.meta.tiering_abort(ino)
                    return "verify_failed"
            out = self._commit(ino, gen, inode, size)
            return "resumed" if out == "migrated" else out
        # COMMITTED: the blob is the source of truth; just tidy up
        self.fs.meta.tiering_finish(ino)
        return "resumed"

    # ---------------------------------------------------- read-through
    def read_cold(self, inode: dict, offset: int, length: int) -> bytes:
        """Serve a cold file's bytes from the blob plane (AZ-local
        degraded reads happen inside the access GET path). Feeds the
        re-heat counters; length is already EOF-clamped by the caller."""
        ino = inode["ino"]
        metrics.tiering_cold_reads.inc()
        if self._heat_up(ino) >= self.untier_threshold:
            with self._lock:
                self._hot.add(ino)
        location = _loc_of(inode["xattr"]["cold.location"])
        if location.get("empty") or length <= 0:
            return b""
        with tracelib.stage("cold_read", path="fs.read"):
            data = self.blob.get(location)
        metrics.tiering_bytes.inc(length, direction="read")
        return data[offset:offset + length]

    def _heat_up(self, ino: int) -> int:
        with self._lock:
            n = self._heat.pop(ino, 0) + 1
            self._heat[ino] = n
            while len(self._heat) > self.HEAT_TRACK:
                self._heat.popitem(last=False)
            return n

    def hot_candidates(self) -> list[int]:
        """Inodes whose cold-read count crossed the un-tier threshold;
        the lifecycle scan promotes them back to datanode extents."""
        with self._lock:
            return sorted(self._hot)

    # --------------------------------------------------------- re-heat
    def untier(self, ino: int) -> str:
        """Promote a cold file back to hot extents: blob GET, write the
        payload to datanode extents WITHOUT registering them, then land
        the whole promotion through ONE fenced untier_commit apply — a
        racing write atomically rejects it and the orphan extents are
        reclaimed via the freelist."""
        inode = self.fs.meta.inode_get(ino)
        cold = inode["xattr"].get("cold.location")
        if cold is None or inode["extents"]:
            self._forget(ino)
            return "noop"
        location = _loc_of(cold)
        gen = inode.get("gen", 0)
        size = inode["size"]
        extents: list[dict] = []
        if size and not location.get("empty"):
            data = self.blob.get(location, priority=qos.SCRUB)
            extents = self.fs.data.write_extents(ino, 0, data)
        res = self.fs.meta.untier_commit(ino, gen, extents)
        self.fs.data.close_stream(ino)
        self._forget(ino)
        if res.get("ok"):
            metrics.tiering_untiered.inc(outcome="promoted")
            metrics.tiering_bytes.inc(size, direction="hot")
            return "promoted"
        metrics.tiering_untiered.inc(outcome="fenced")
        return "fenced"

    def _forget(self, ino: int) -> None:
        with self._lock:
            self._hot.discard(ino)
            self._heat.pop(ino, None)

    # -------------------------------------------------- orphan reaping
    def reap_orphans(self) -> int:
        """Drain the metanode blob freelist: delete each queued blob
        from the blob plane, then retire the entry via the idempotent
        blob_free_done apply. Any failure leaves the entry for the next
        sweep — deletion is at-least-once, which mark-delete absorbs."""
        entries = self.fs.meta.blob_freelist_all()
        reaped = 0
        for full_key, ent in entries.items():
            pid_s, key = full_key.split(":", 1)
            try:
                self.blob.delete(ent["location"], priority=qos.SCRUB)
            except Exception:
                continue  # blob plane unavailable/shed: retry next sweep
            try:
                self.fs.meta.blob_free_done(int(pid_s), key)
            except Exception:
                continue  # retried next sweep (idempotent pop)
            reaped += 1
        if reaped:
            metrics.tiering_orphans_reaped.inc(reaped)
        metrics.tiering_blob_freelist.set(len(entries) - reaped)
        return reaped

    # ------------------------------------- inventory reconciliation
    # Closes the residual put->blob_written leak window documented in
    # the module docstring: a blob whose PUT landed but whose
    # blob_written record never did is referenced by NOTHING — no
    # xattr, no freelist entry — and only a bucket-level cross-check of
    # blob-plane listings against metadata can find it.

    def _referenced_bids(self) -> set[tuple[int, int]]:
        """Every (vid, bid) the metadata plane can still reach: inode
        cold.location, mid-migration tiering.pending, and blob_freelist
        entries awaiting the reaper."""
        refs: set[tuple[int, int]] = set()

        def add_location(loc) -> None:
            loc = _loc_of(loc)
            if not loc or loc.get("empty"):
                return
            for sl in loc.get("slices", []):
                for k in range(sl["count"]):
                    refs.add((sl["vid"], sl["min_bid"] + k))

        for ino in self.fs.meta.list_inos():
            try:
                xa = self.fs.meta.inode_get(ino).get("xattr") or {}
            except Exception:
                continue
            if xa.get("cold.location"):
                add_location(xa["cold.location"])
            if xa.get("tiering.pending"):
                add_location(xa["tiering.pending"])
        for ent in self.fs.meta.blob_freelist_all().values():
            add_location(ent.get("location"))
        return refs

    def reconcile_inventory(self, listing: dict) -> int:
        """One reconciliation sweep against a blob-plane listing (see
        blob_plane_listing). A bid must show up leaked in TWO
        consecutive sweeps before it is enqueued: a PUT that landed
        between the metadata snapshot and the listing looks exactly
        like a leak for one sweep, and deleting it would eat live data.
        Confirmed leaks are grouped into per-volume synthetic locations
        and enqueued through blob_reconcile_enqueue, so they ride the
        SAME blob_freelist reaper as every other orphan. Returns the
        number of bids enqueued this sweep."""
        refs = self._referenced_bids()
        leaked: set[tuple[int, int]] = set()
        sizes: dict[tuple[int, int], int] = {}
        for vid, info in listing.items():
            for bid, size in info["bids"].items():
                key = (int(vid), int(bid))
                if key not in refs:
                    leaked.add(key)
                    sizes[key] = size
        pending = getattr(self, "_reconcile_pending", set())
        confirmed = leaked & pending
        self._reconcile_pending = leaked - confirmed
        if not confirmed:
            return 0
        # group confirmed bids into contiguous runs per volume — one
        # synthetic Location per run keeps the freelist compact
        by_vid: dict[int, list[int]] = {}
        for vid, bid in confirmed:
            by_vid.setdefault(vid, []).append(bid)
        enqueued = 0
        for vid, bids in sorted(by_vid.items()):
            mode = listing[vid]["codemode"]
            bids.sort()
            run_start = prev = bids[0]
            runs = []
            for b in bids[1:]:
                if b == prev + 1:
                    prev = b
                    continue
                runs.append((run_start, prev))
                run_start = prev = b
            runs.append((run_start, prev))
            for lo, hi in runs:
                count = hi - lo + 1
                blob_size = max(sizes.get((vid, b), 1) for b in
                                range(lo, hi + 1))
                self.fs.meta.blob_reconcile_enqueue({
                    "cluster_id": 1, "codemode": mode,
                    "size": sum(sizes.get((vid, b), 0)
                                for b in range(lo, hi + 1)),
                    "slices": [{"min_bid": lo, "vid": vid, "count": count,
                                "blob_size": max(blob_size, 1)}],
                    "crc": 0})
                enqueued += count
        metrics.tiering_orphans_reconciled.inc(enqueued)
        return enqueued


def blob_plane_listing(cm, node_pool) -> dict:
    """Bucket-level inventory of the blob plane: {vid: {"codemode",
    "bids": {bid: shard_size}}}, from each volume's first listable
    unit (every unit of a volume holds a shard for every bid, so one
    healthy listing per volume is a complete bid census)."""
    out: dict[int, dict] = {}
    for vid in sorted(cm.volumes):
        vol = cm.get_volume(vid)
        bids: dict[int, int] = {}
        for u in vol.units:
            try:
                meta, _ = node_pool.get(u.node_addr).call(
                    "list_chunk",
                    {"disk_id": u.disk_id, "chunk_id": u.chunk_id})
            except Exception:
                continue  # unreachable unit: try the next replica column
            bids = {int(b): int(s) for b, s, _ in meta["shards"]}
            break
        out[vid] = {"codemode": int(vol.codemode), "bids": bids}
    return out
