"""BlobNode: the EC-plane disk server + background-task worker host.

Role parity: blobstore/blobnode (chunk storage service, svr.go:41;
heartbeats to clustermgr; WorkerService pulling repair/migrate tasks,
worker_service.go:203-219). Storage is the native C++ chunk store
(csrc/host/chunkstore.cc); shard payloads are CRC-checked on every read so a
degraded GET or repair download surfaces bit-rot as an error, matching
the reference's end-to-end CRC discipline.

The port's copy of ``cubefs_tpu/blob/blobnode.py``. A node takes a
``device`` and an engine name (``auto`` by default, as the reference's
``admit("auto")``): the MSR helper combination runs on ``codecio``'s
engine. The chaos hooks read an installed ``faultinject`` plan: its
broken disks in ``_disk_down``, its at-rest rot in the verified read,
and a rewrite through ``rpc_put_shard`` heals planted rot.
"""

from __future__ import annotations

import threading
import time
import uuid

import numpy as np

from ..utils import metrics, rpc
from ..utils.diskhealth import DiskHealthTracker
from . import codecio
from .chunkstore import (ChunkStore, ChunkStoreError, CrcMismatchError,
                         ShardNotFoundError, verified_get_shard)


class BlobNode:
    def __init__(self, node_id: int, disk_paths: list[str], cm_client: rpc.Client | None = None,
                 addr: str = "", az: str = "", rack: str = "",
                 device=None, engine: str = "auto"):
        self.node_id = node_id
        self.addr = addr
        self.az = az  # failure-domain labels; carried on register + heartbeat
        self.rack = rack
        self.cm = cm_client
        # helper-side MSR combinations go through the codec admission
        # surface: concurrent repairs' sub-shard reads coalesce into
        # shared device steps like any other stripe math
        self.codec = codecio.engine(device, engine)
        self.stores: dict[int, ChunkStore] = {}  # disk_id -> store
        self._disk_paths = list(disk_paths)
        self.disk_ids: list[int] = []
        self._hb_stop = threading.Event()
        self._hb_thread: threading.Thread | None = None
        self._broken: set[int] = set()
        # limping-disk quarantine (soft: served, never newly allocated);
        # the heartbeat carries the list so clustermgr flips DiskStatus
        self.health = DiskHealthTracker(addr or str(node_id), [])

    # ---------------- lifecycle ----------------
    def register(self) -> None:
        """Register every disk with clustermgr and open its store."""
        for path in self._disk_paths:
            meta, _ = self.cm.call(
                "register_disk", {"node_addr": self.addr, "path": path,
                                  "az": self.az, "rack": self.rack,
                                  "op_id": uuid.uuid4().hex}
            )
            disk_id = meta["disk_id"]
            self.stores[disk_id] = ChunkStore(path)
            self.disk_ids.append(disk_id)

    def attach_local(self, disk_id: int, path: str) -> None:
        """Open a disk without clustermgr (unit tests / tools)."""
        self.stores[disk_id] = ChunkStore(path)
        self.disk_ids.append(disk_id)

    def start_heartbeat(self, interval: float = 3.0) -> None:
        def loop():
            while not self._hb_stop.wait(interval):
                self.send_heartbeat()

        self._hb_thread = threading.Thread(target=loop, daemon=True)
        self._hb_thread.start()

    def send_heartbeat(self) -> None:
        live = [d for d in self.disk_ids if not self._disk_down(d)]
        # quarantine probes ride the heartbeat cadence (the breaker's
        # half-open leg): cooldown elapsed -> one real write+fsync
        for d in live:
            if self.health.probe_due(d):
                self.health.probe_result(d, self._io_probe_ok(d))
        if live and self.cm is not None:
            hb = {"disk_ids": live,
                  "quarantined": [d for d in self.health.quarantined()
                                  if d in live]}
            if self.az:
                # heartbeats re-assert labels so a relabeled node
                # converges without re-registering its disks
                hb["az"] = self.az
                hb["rack"] = self.rack
            self.cm.call("heartbeat", hb)

    def _io_probe_ok(self, disk_id: int) -> bool:
        """Quarantine probe on the disk's store directory: write+fsync
        scored pass/fail (ENOSPC is full, not sick)."""
        import errno as errno_mod
        import os
        import uuid as uuid_mod

        store = self.stores.get(disk_id)
        if store is None:
            return False
        probe = os.path.join(store.directory,
                             f".quarantine_probe.{uuid_mod.uuid4().hex[:8]}")
        try:
            with open(probe, "wb") as f:
                f.write(b"ok")
                f.flush()
                os.fsync(f.fileno())
            os.unlink(probe)
            return True
        except OSError as pe:
            return pe.errno in (errno_mod.ENOSPC, errno_mod.EDQUOT)

    def stop(self) -> None:
        self._hb_stop.set()
        for s in self.stores.values():
            s.close()
        self.stores.clear()

    def break_disk(self, disk_id: int) -> None:
        """Fault injection: disk stops serving + stops heartbeating.

        Kept for direct use, but scenarios that also inject transport
        faults should use faultinject.FaultPlan.break_disk(addr, id)
        instead — the plan-level hook (checked in _disk_down) lets disk
        and network chaos compose in ONE seeded schedule."""
        self._broken.add(disk_id)

    def _disk_down(self, disk_id: int) -> bool:
        if disk_id in self._broken:
            return True
        plan = rpc._fault  # chaos hook; None in production
        return plan is not None and plan.disk_broken(
            self.addr or str(self.node_id), disk_id)

    # ---------------- data plane ----------------
    def _store(self, disk_id: int) -> ChunkStore:
        if self._disk_down(disk_id):
            raise rpc.RpcError(503, f"disk {disk_id} is broken")
        try:
            return self.stores[disk_id]
        except KeyError:
            raise rpc.RpcError(404, f"disk {disk_id} not on node {self.node_id}") from None

    def put_shard(self, disk_id: int, chunk_id: int, bid: int,
                  data: bytes) -> int:
        store = self._store(disk_id)
        t0 = time.monotonic()
        try:
            crc = store.put_shard(chunk_id, bid, data)
            self.health.record_io(disk_id, time.monotonic() - t0)
        except (OSError, ChunkStoreError):
            self.health.record_io(disk_id, time.monotonic() - t0, ok=False)
            raise
        return crc

    def get_shard(self, disk_id: int, chunk_id: int, bid: int,
                  source: str = "read") -> tuple[bytes, int]:
        store = self._store(disk_id)
        t0 = time.monotonic()
        try:
            out = verified_get_shard(
                store, chunk_id, bid,
                node_addr=self.addr or str(self.node_id),
                disk_id=disk_id, source=source)
            self.health.record_io(disk_id, time.monotonic() - t0)
            return out
        except CrcMismatchError:
            raise  # data integrity, not disk death: 409 path upstream
        except ShardNotFoundError:
            raise  # absence is not a health signal either
        except (OSError, ChunkStoreError):
            self.health.record_io(disk_id, time.monotonic() - t0, ok=False)
            raise

    def delete_shard(self, disk_id: int, chunk_id: int, bid: int) -> None:
        self._store(disk_id).delete_shard(chunk_id, bid)

    def list_chunk(self, disk_id: int, chunk_id: int) -> list[tuple[int, int, int]]:
        return self._store(disk_id).list_shards(chunk_id)

    def read_subshard(self, disk_id: int, chunk_id: int, bids: list[int],
                      coeff: list[int]) -> tuple[list[int], bytes]:
        """MSR helper read: for each bid, return the GF combination
        `coeff` (length alpha) of the shard's alpha sub-shards — one
        beta = S/alpha payload per bid instead of the full shard. This
        single RPC is where the (k*alpha/d)x repair-traffic saving
        happens: the combination runs HERE, helper-side, so only beta
        bytes cross the wire. Batched over all of a repair task's bids
        so the device step sees one (B, alpha, beta) stack per size."""
        store = self._store(disk_id)
        alpha = len(coeff)
        if alpha < 1:
            raise rpc.RpcError(400, "empty helper coefficient row")
        row = np.asarray([coeff], dtype=np.uint8)
        shards: list[bytes] = []
        for bid in bids:
            data, _ = verified_get_shard(  # CRC-checked + at-rest gate
                store, chunk_id, bid,
                node_addr=self.addr or str(self.node_id),
                disk_id=disk_id, source="repair")
            if len(data) % alpha:
                raise rpc.RpcError(
                    409, f"bid {bid}: shard size {len(data)} not "
                         f"divisible by alpha={alpha} — not MSR-encoded")
            shards.append(data)
        sizes = [len(s) // alpha for s in shards]
        out: list[bytes | None] = [None] * len(bids)
        by_size: dict[int, list[int]] = {}
        for i, beta in enumerate(sizes):
            by_size.setdefault(beta, []).append(i)
        for beta, idxs in by_size.items():
            stack = np.stack([
                np.frombuffer(shards[i], dtype=np.uint8).reshape(alpha, beta)
                for i in idxs])  # (B, alpha, beta)
            combined = self.codec.matrix_apply(row, stack)  # (B, 1, beta)
            for pos, i in enumerate(idxs):
                out[i] = combined[pos, 0].tobytes()
        metrics.repair_subshard_reads.inc(len(bids))
        return sizes, b"".join(out)  # type: ignore[arg-type]

    # ---------------- RPC surface ----------------
    def rpc_put_shard(self, args, body):
        crc = self.put_shard(args["disk_id"], args["chunk_id"], args["bid"],
                             body)
        plan = rpc._fault
        if plan is not None and plan.heal_rot(
                self.addr or str(self.node_id), args["disk_id"],
                f"c{args['chunk_id']}:b{args['bid']}"):
            # the rewrite replaced a genuinely rotten shard (heal_rot is
            # False for rewrites of clean shards — zero false repairs)
            metrics.integrity_corruptions_healed.inc(
                plane="blob", source=args.get("heal_source") or "repair")
        return {"crc": crc}

    def rpc_get_shard(self, args, body):
        try:
            data, crc = self.get_shard(args["disk_id"], args["chunk_id"],
                                       args["bid"],
                                       source=args.get("source", "read"))
        except ShardNotFoundError as e:
            raise rpc.RpcError(404, str(e)) from None
        except CrcMismatchError as e:
            raise rpc.RpcError(409, str(e)) from None
        return {"crc": crc}, data

    def rpc_delete_shard(self, args, body):
        try:
            self.delete_shard(args["disk_id"], args["chunk_id"], args["bid"])
        except ShardNotFoundError as e:
            raise rpc.RpcError(404, str(e)) from None
        return {}

    def rpc_list_chunk(self, args, body):
        shards = self.list_chunk(args["disk_id"], args["chunk_id"])
        return {"shards": [[b, s, c] for b, s, c in shards]}

    def rpc_read_subshard(self, args, body):
        try:
            sizes, payload = self.read_subshard(
                args["disk_id"], args["chunk_id"], args["bids"],
                args["coeff"])
        except ShardNotFoundError as e:
            raise rpc.RpcError(404, str(e)) from None
        except CrcMismatchError as e:
            raise rpc.RpcError(409, str(e)) from None
        return {"sizes": sizes}, payload

    def rpc_compact_chunk(self, args, body):
        reclaimed = self._store(args["disk_id"]).compact(args["chunk_id"])
        return {"reclaimed": reclaimed}

    def rpc_stat(self, args, body):
        return {
            "node_id": self.node_id,
            "disks": {
                str(d): {"broken": d in self._broken,
                         "quarantined": self.health.is_quarantined(d)}
                for d in self.disk_ids
            },
        }
