"""DataNode: replicated extent storage with chain replication.

Role parity: datanode/ — per-partition extent storage on the native
engine (datanode/storage), leader→followers chain replication with ack
aggregation (repl/repl_protocol.go:311 sendRequestToAllFollowers), CRC
fingerprint diffing for replica repair (data_partition_repair.go:102).

Writes take two paths, like the reference:
  * APPENDS (beyond the extent's written end) ride the chain — leader
    writes locally and fans out to followers, acking when all applied.
  * OVERWRITES of already-written ranges go through a PER-PARTITION
    RAFT group (datanode/partition_raft.go, ApplyRandomWrite at
    partition_op_by_raft.go:224): concurrent overwrites commit in one
    total order on every replica, so a leader change mid-storm cannot
    leave replicas diverged the way racing chain-forwards could.

The port's copy of ``cubefs_tpu/fs/datanode.py``. The native read plane
(``csrc/host/dataserve.cc``) is on unless ``CUBEFS_NATIVE_DATA=0``, and
a failed build of it raises (the reference serves without it).
"""

from __future__ import annotations

import base64
import json
import os
import threading
import time

from ..utils import lockwitness, metrics, rpc
from ..utils.diskhealth import DiskHealthTracker
from ..utils.retry import RetryPolicy
from .extent_store import (BlockCrcError, ExtentError, ExtentStore,
                           verified_read)


class DataPartition:
    def __init__(self, dp_id: int, path: str, peers: list[str], leader: str):
        self.dp_id = dp_id
        self.path = path
        self.store = ExtentStore(path)
        self.peers = list(peers)  # all replica addrs incl. leader
        self.leader = leader
        self.raft = None  # per-dp raft group for the random-write path
        self._meta_path = os.path.join(path, "dp_meta.json")
        self._lock = lockwitness.make_lock("DataPartition._lock")
        self.next_extent = 1
        if os.path.exists(self._meta_path):
            meta = json.load(open(self._meta_path))
            self.next_extent = meta.get("next_extent", 1)
            self.peers = meta.get("peers", self.peers)
            self.leader = meta.get("leader", self.leader)
        self._persist()

    def apply_random_write(self, entry: dict) -> dict:
        """Raft apply: serialize one overwrite onto the local store —
        runs identically on every replica at the same log position."""
        self.store.write(entry["extent_id"], entry["offset"],
                         base64.b64decode(entry["data"]))
        return {}

    def _persist(self) -> None:
        tmp = self._meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"dp_id": self.dp_id, "next_extent": self.next_extent,
                       "peers": self.peers, "leader": self.leader}, f)
        os.replace(tmp, self._meta_path)

    def extent_lock(self, extent_id: int) -> threading.Lock:
        """Per-extent writer lock, held by the DESIGNATED leader across a
        whole write (classify + replicate-everywhere). Both paths ack
        only when every replica applied, so serializing initiation here
        totally orders overlapping writes — a chain append and a raft
        overwrite can never interleave differently on different
        replicas."""
        with self._lock:
            if not hasattr(self, "_ext_locks"):
                self._ext_locks = {}
            return self._ext_locks.setdefault(extent_id, lockwitness.make_lock("DataPartition._ext_lock"))

    def alloc_extent(self, op_id: str | None = None) -> int:
        """Mint the next extent id. A transport retry must get the same
        id back — otherwise the retry mints a second, orphaned extent
        (fsck would report it, but never creating it is better)."""
        with self._lock:
            if not hasattr(self, "_alloc_cache"):
                self._alloc_cache = {}
            if op_id is not None and op_id in self._alloc_cache:
                return self._alloc_cache[op_id]
            eid = self.next_extent
            self.next_extent += 1
            self._persist()
            self.store.create(eid)
            if op_id is not None:
                self._alloc_cache[op_id] = eid
                if len(self._alloc_cache) > 1024:
                    for k in list(self._alloc_cache)[:512]:
                        del self._alloc_cache[k]
            return eid


class DataNode:
    def __init__(self, node_id: int, root_dir: str, addr: str, node_pool,
                 qos=None, disks: list[str] | None = None):
        from ..utils.ratelimit import DiskQos

        self.node_id = node_id
        self.root = root_dir
        # multi-disk model (datanode/space_manager.go + disk.go role):
        # each dp lives on ONE disk; a failed disk takes down its dps
        # only, and the master's disk manager migrates exactly those
        self.disks = [os.path.abspath(d) for d in (disks or [root_dir])]
        self.disk_broken: set[str] = set()  # sticky per-disk health
        self.dp_disk: dict[int, str] = {}  # dp_id -> disk path
        # softer-than-broken quarantine (limping disk): keyed by disk
        # INDEX into self.disks; tests may swap in a FakeClock tracker
        self.health = DiskHealthTracker(addr or str(node_id),
                                        range(len(self.disks)))
        self.addr = addr
        self.nodes = node_pool  # addr -> rpc client (for chain forward)
        # client-facing IO shaping (datanode/limit.go): raft applies and
        # chain replica legs are exempt — throttling consensus/repair
        # traffic would stall recovery, exactly what QoS must not do
        self.qos = qos if isinstance(qos, DiskQos) else DiskQos.from_config(qos)
        self.partitions: dict[int, DataPartition] = {}
        self.extra_routes: dict = {}  # live raft handlers (rpc.resolve_route)
        self._lock = lockwitness.make_rlock("DataNode._lock")
        self._broken = False
        # native C++ read plane (csrc/host/dataserve.cc): serves
        # OP_READ from the same extent-store handles, GIL-free. Only
        # CUBEFS_NATIVE_DATA=0 turns it off; a failed build raises.
        self._native_lib = None
        self._native_h = None
        self.native_addr: str | None = None
        if os.environ.get("CUBEFS_NATIVE_DATA", "1") != "0":
            from ..runtime import fsnative

            self._native_lib = fsnative.load()
            self._native_h = self._native_lib.ds_create()
        # chain legs that failed mid-append: (dp_id, extent_id) -> peers
        # whose replica diverged in the appended range. Repaired
        # immediately in the background (not left to the next fsck /
        # rebuild sweep — a leader read in that window would serve bytes
        # the client was told failed).
        # (dp_id, extent_id, peer) -> {"gen": int, "running": bool}; a
        # repair thread re-syncs until it completes a pass whose gen is
        # still current, so writes landing mid-repair are never lost
        self.pending_repairs: dict[tuple[int, int, str], dict] = {}
        self._repair_lock = lockwitness.make_lock("DataNode._repair_lock")
        for d in self.disks:
            os.makedirs(d, exist_ok=True)
        # reopen partitions found on every disk (raft rejoins via its
        # wal once the master re-pushes the peer set)
        for disk in self.disks:
            for name in os.listdir(disk):
                if name.startswith("dp_") and os.path.isdir(
                        os.path.join(disk, name)):
                    dp_id = int(name[3:])
                    dp = DataPartition(dp_id, os.path.join(disk, name), [], "")
                    self.partitions[dp_id] = dp
                    self.dp_disk[dp_id] = disk
                    self._native_register(dp)
                    if len(dp.peers) > 1:
                        self._start_dp_raft(dp)

    # Native-plane handle discipline: EVERY ds_* call happens while
    # holding self._lock and re-checks _native_h; stop() nulls the
    # attribute under that lock before destroying, so a concurrent
    # caller (e.g. the heartbeat thread's disk_report) can never use a
    # freed handle.

    @property
    def broken(self) -> bool:
        return self._broken

    @broken.setter
    def broken(self, v: bool) -> None:
        # the native read plane honors the same kill switch (tests and
        # failure simulations set this attribute directly)
        self._broken = v
        with self._lock:
            if self._native_h is not None:
                self._native_lib.ds_set_down(self._native_h, 1 if v else 0)

    def serve_native(self, host: str = "127.0.0.1", port: int = 0):
        """Start the C++ read plane; returns its addr (None when the
        native runtime is unavailable, or when client-read QoS is
        configured — the native plane does not shape reads, and
        silently bypassing a configured limit would make QoS dead
        config; such deployments keep the Python plane)."""
        if self.qos is not None and getattr(self.qos, "read", None):
            return None
        with self._lock:
            if self._native_h is None:
                return None
            p = self._native_lib.ds_serve(self._native_h, host.encode(),
                                          port)
        if p < 0:
            return None
        self.native_addr = f"{host}:{p}"
        return self.native_addr

    def _native_register(self, dp: DataPartition) -> None:
        with self._lock:
            if self._native_h is None:
                return
            disk = self.dp_disk.get(dp.dp_id)
            serving = 0 if disk in self.disk_broken else 1
            self._native_lib.ds_add_partition(
                self._native_h, dp.dp_id, dp.store.handle, serving)

    def _pick_disk(self) -> str:
        """Healthy disk with the fewest partitions (space_manager.go
        placement role). Quarantined disks (limping, not dead) get no
        NEW allocations while any unquarantined disk remains — but a
        fully-quarantined node still allocates rather than 503s, since
        quarantine is a soft signal."""
        healthy = [d for d in self.disks if d not in self.disk_broken]
        if not healthy:
            raise rpc.RpcError(503, f"all disks broken on {self.addr}")
        unquarantined = [d for d in healthy
                         if not self.health.is_quarantined(
                             self.disks.index(d))]
        healthy = unquarantined or healthy
        counts = {d: 0 for d in healthy}
        for disk in self.dp_disk.values():
            if disk in counts:
                counts[disk] += 1
        return min(healthy, key=lambda d: (counts[d], d))

    def create_partition(self, dp_id: int, peers: list[str], leader: str) -> None:
        with self._lock:
            if dp_id not in self.partitions:
                disk = self._pick_disk()
                self.partitions[dp_id] = DataPartition(
                    dp_id, os.path.join(disk, f"dp_{dp_id}"), peers, leader
                )
                self.dp_disk[dp_id] = disk
                self._native_register(self.partitions[dp_id])
            else:
                dp = self.partitions[dp_id]
                dp.peers, dp.leader = list(peers), leader
                dp._persist()
            dp = self.partitions[dp_id]
            if dp.raft is not None:
                current = set(dp.raft.peers) | {self.addr}
                if current != set(dp.peers):
                    # master re-pushed a changed replica set (e.g. dead
                    # replica swapped): restart the group on the new
                    # membership over the same wal (crude but safe
                    # reconfiguration — no joint consensus yet)
                    dp.raft.stop()
                    dp.raft = None
            if dp.raft is None and len(dp.peers) > 1:
                self._start_dp_raft(dp)

    def _start_dp_raft(self, dp: DataPartition) -> None:
        from ..parallel import raft as raftlib

        def apply_guarded(entry, _dp=dp):
            # a store failure inside the raft apply (incl. on replicas,
            # where apply exceptions are swallowed) must still run the
            # disk triage, or a follower's dying disk is never detected
            try:
                return _dp.apply_random_write(entry)
            except (OSError, ExtentError):
                disk = self.dp_disk.get(_dp.dp_id)
                if disk is not None:
                    self._probe_disk(disk)
                raise

        node = raftlib.RaftNode(
            f"dp{dp.dp_id}", self.addr, dp.peers, apply_guarded,
            self.nodes,
            data_dir=os.path.join(dp.path, "raft"),
        )
        raftlib.register_routes(self.extra_routes, node)
        dp.raft = node.start()

    def _dp(self, dp_id: int) -> DataPartition:
        if self.broken:
            raise rpc.RpcError(503, f"datanode {self.addr} is down")
        dp = self.partitions.get(dp_id)
        if dp is None:
            raise rpc.RpcError(404, f"dp {dp_id} not on {self.addr}")
        disk = self.dp_disk.get(dp_id)
        if disk in self.disk_broken:
            raise rpc.RpcError(
                503, f"disk {disk} on {self.addr} is broken")
        return dp

    def mark_disk_broken(self, path: str) -> None:
        """Sticky disk failure (disk.go triggerDiskError role): IO
        errors and operator action land here; the next heartbeat's disk
        report makes the master migrate this disk's partitions. The
        native read plane stops serving the disk's dps immediately."""
        path = os.path.abspath(path)
        with self._lock:  # vs create/drop_partition mutating dp_disk
            self.disk_broken.add(path)
            affected = [dp_id for dp_id, d in self.dp_disk.items()
                        if d == path]
            if self._native_h is not None:
                for dp_id in affected:
                    self._native_lib.ds_set_serving(self._native_h,
                                                    dp_id, 0)

    def _probe_disk(self, disk: str) -> None:
        """Write+fsync health probe; a failure marks the disk broken
        (sticky). Per-call unique probe name: concurrent probes must
        not race each other's unlink into a false positive. ENOSPC and
        EDQUOT are NOT death — a full disk is healthy, just full, and
        evacuating it would move data for nothing."""
        import errno as errno_mod
        import uuid

        if disk in self.disk_broken:
            return
        probe = os.path.join(disk, f".health_probe.{uuid.uuid4().hex[:8]}")
        try:
            with open(probe, "wb") as f:
                f.write(b"ok")
                f.flush()
                os.fsync(f.fileno())
            os.unlink(probe)
        except OSError as pe:
            if pe.errno in (errno_mod.ENOSPC, errno_mod.EDQUOT):
                try:
                    os.unlink(probe)
                except OSError:
                    pass
                return
            self.mark_disk_broken(disk)  # also stops native serving

    def _disk_io_guard(self, dp_id: int, exc: Exception):
        """Store failure triage (disk.go triggerDiskError role): the
        extent store surfaces every failure as ExtentError, which could
        be a logical error OR a dying disk. Disambiguate with a direct
        write+fsync probe on the disk — a failed probe marks the disk
        broken (sticky) and surfaces 503 so clients fail over and the
        heartbeat report triggers migration; a healthy probe re-raises
        the original error unchanged."""
        disk = self.dp_disk.get(dp_id)
        if disk is not None:
            self._probe_disk(disk)
        if disk in self.disk_broken:
            raise rpc.RpcError(
                503, f"disk {disk} failed on {self.addr}: {exc}") from None
        raise exc

    def drop_partition(self, dp_id: int) -> None:
        """Remove a replica this node no longer owns (the master
        repointed the replica set after a disk migration): stop its
        raft member, close the store and delete the data — a stale
        live replica would keep serving bytes that no longer receive
        writes."""
        import shutil

        with self._lock:
            dp = self.partitions.pop(dp_id, None)
            disk = self.dp_disk.pop(dp_id, None)
        if dp is None:
            return
        with self._lock:
            if self._native_h is not None:
                # drains in-flight native reads BEFORE the store closes
                self._native_lib.ds_drop_partition(self._native_h, dp_id)
        if dp.raft is not None:
            dp.raft.stop()
        try:
            dp.store.close()
        except Exception:
            pass
        if disk is not None:
            shutil.rmtree(os.path.join(disk, f"dp_{dp_id}"),
                          ignore_errors=True)

    def disk_report(self) -> dict:
        """Per-disk health + resident dps (heartbeat payload; the
        master's disk manager consumes it). Also drains native-plane
        read failures into the disk triage — a dying disk that only
        serves GIL-free reads must still get probed and migrated."""
        failed_disks = []
        with self._lock:
            if self._native_h is not None:
                import ctypes

                buf = (ctypes.c_uint64 * 64)()
                n = self._native_lib.ds_take_failed(self._native_h, buf, 64)
                failed_disks = [self.dp_disk[int(buf[i])]
                                for i in range(n)
                                if int(buf[i]) in self.dp_disk]
        for disk in failed_disks:
            self._probe_disk(disk)
        # quarantine probe rides the heartbeat cadence (breaker
        # half-open analog): cooldown elapsed -> one real write+fsync
        # decides pass/fail
        for idx, disk in enumerate(self.disks):
            if self.health.probe_due(idx):
                self.health.probe_result(idx, self._io_probe_ok(disk))
        with self._lock:
            out = {}
            for idx, d in enumerate(self.disks):
                out[d] = {"broken": d in self.disk_broken,
                          "quarantined": self.health.is_quarantined(idx),
                          "dps": sorted(i for i, dd in self.dp_disk.items()
                                        if dd == d)}
            return out

    def _io_probe_ok(self, disk: str) -> bool:
        """Quarantine probe: same write+fsync as _probe_disk but scored
        pass/fail instead of sticky-breaking (ENOSPC still passes)."""
        import errno as errno_mod
        import uuid

        probe = os.path.join(disk, f".quarantine_probe.{uuid.uuid4().hex[:8]}")
        try:
            with open(probe, "wb") as f:
                f.write(b"ok")
                f.flush()
                os.fsync(f.fileno())
            os.unlink(probe)
            return True
        except OSError as pe:
            if pe.errno in (errno_mod.ENOSPC, errno_mod.EDQUOT):
                return True
            return False

    # ---------------- write path (chain replication) ----------------
    def write(self, dp_id: int, extent_id: int, offset: int, data: bytes,
              chain: bool = True, hops: int = 2) -> None:
        """Write entry point. Follower legs (chain=False) apply locally.
        Everything else routes to the DESIGNATED leader, which holds the
        per-extent lock across the whole operation and classifies it
        exactly once: appends ride the chain, overwrites of
        already-written ranges divert to the per-dp raft group. Both
        paths ack only when every replica applied, so the lock totally
        orders overlapping writes — no replica can see a chain append
        and a raft overwrite in different orders."""
        dp = self._dp(dp_id)
        if not chain:
            self._timed_store_write(dp, dp_id, extent_id, offset, data)
            return
        if dp.leader and dp.leader != self.addr:
            if hops <= 0:
                raise rpc.RpcError(503, f"dp {dp_id}: leader route loop")
            self.nodes.get(dp.leader).call(
                "write", {"dp_id": dp_id, "extent_id": extent_id,
                          "offset": offset, "hops": hops - 1},
                data, timeout=30.0)
            return
        if self.qos is not None:
            # charge the bucket only where the IO actually happens (the
            # designated leader); a stale-view forwarder must not burn
            # its budget on bytes it never writes
            self.qos.acquire_write(len(data))
        with dp.extent_lock(extent_id):
            if len(dp.peers) > 1 and offset < dp.store.size(extent_id):
                raft = dp.raft
                if raft is None:
                    # membership restart in flight: an overwrite must
                    # NEVER fall back to the chain (it would bypass the
                    # raft log and silently diverge a rejoining replica)
                    raise rpc.RpcError(
                        503, f"dp {dp_id} raft reconfiguring; retry")
                self._random_write(dp, extent_id, offset, data)
                return
            self._timed_store_write(dp, dp_id, extent_id, offset, data)
            self._chain_forward(dp, extent_id, offset, data)

    def _timed_store_write(self, dp: DataPartition, dp_id: int,
                           extent_id: int, offset: int, data: bytes) -> None:
        """Local store write with latency/error fed to the quarantine
        tracker (every local IO is a health sample)."""
        disk_idx = self._disk_index(dp_id)
        t0 = time.monotonic()
        try:
            dp.store.write(extent_id, offset, data)
            self.health.record_io(disk_idx, time.monotonic() - t0)
        except (OSError, ExtentError) as e:
            self.health.record_io(disk_idx, time.monotonic() - t0, ok=False)
            self._disk_io_guard(dp_id, e)

    def _chain_forward(self, dp: DataPartition, extent_id: int, offset: int,
                       data: bytes) -> None:
        errs = []
        followers = [p for p in dp.peers if p != self.addr]
        threads = []

        def fwd(peer):
            try:
                self.nodes.get(peer).call(
                    "write_replica",
                    {"dp_id": dp.dp_id, "extent_id": extent_id,
                     "offset": offset},
                    data, timeout=15.0,
                )
            except Exception as e:
                errs.append((peer, e))

        for p in followers:
            t = threading.Thread(target=fwd, args=(p,))
            t.start()
            threads.append(t)
        for t in threads:
            t.join()
        if errs:
            # the leader's local bytes already persisted: until the
            # failed legs are re-synced the replicas diverge in this
            # range, so queue an immediate repair instead of waiting for
            # a periodic fingerprint diff
            for peer, _ in errs:
                self._queue_leg_repair(dp.dp_id, extent_id, peer)
            peers = ", ".join(p for p, _ in errs)
            raise rpc.RpcError(500, f"chain write failed on {peers}: {errs[0][1]}")

    def _queue_leg_repair(self, dp_id: int, extent_id: int, peer: str,
                          attempts: int = 5) -> None:
        key = (dp_id, extent_id, peer)
        with self._repair_lock:
            st = self.pending_repairs.get(key)
            if st is not None and st["running"]:
                # a repair thread is mid-sync; bump the generation so it
                # re-syncs before declaring the leg clean (a sync started
                # before this write may have copied pre-write bytes)
                st["gen"] += 1
                return
            gen0 = st["gen"] + 1 if st else 1
            self.pending_repairs[key] = {"gen": gen0, "running": True}

        def run():
            while True:
                with self._repair_lock:
                    gen = self.pending_repairs[key]["gen"]
                ok = False
                # budget-bounded (attempts), not deadline-bounded: the
                # repair thread may legitimately outlive any fixed window
                r = RetryPolicy(base=0.05, cap=2.0, deadline=None,
                                max_retries=attempts - 1).start(
                    op="sync_extent_from")
                while True:
                    try:
                        self.nodes.get(peer).call(
                            "sync_extent_from",
                            {"dp_id": dp_id, "extent_id": extent_id,
                             "src_addr": self.addr}, timeout=30.0)
                        ok = True
                        break
                    except Exception:
                        if not r.tick(reason="leg-repair"):
                            break
                with self._repair_lock:
                    st = self.pending_repairs[key]
                    if ok and st["gen"] == gen:
                        del self.pending_repairs[key]
                        return
                    if not ok and st["gen"] == gen:
                        # attempts exhausted (peer likely down): stop the
                        # thread but keep the entry visible (rpc_stat) and
                        # restartable — the next failed chain leg, or the
                        # master's rebuild sweep, re-arms a fresh thread
                        st["running"] = False
                        return
                    # gen advanced while we were syncing/failing: go again

        threading.Thread(target=run, daemon=True).start()

    def _random_write(self, dp: DataPartition, extent_id: int, offset: int,
                      data: bytes, deadline: float = 8.0) -> None:
        """Commit an overwrite through the dp raft group, forwarding to
        the current raft leader if this replica isn't it (ApplyRandomWrite
        analog: one total order for overwrites across leader changes).

        Retries are deadline-bounded, not count-bounded: an election
        under write-storm load can outlast any fixed small retry count
        (seen on the deployed real-socket cluster), and failing a write
        because the group took 1-2s to elect is wrong."""
        from ..parallel.raft import NotLeaderError

        entry = {"op": "random_write", "extent_id": extent_id,
                 "offset": offset, "data": base64.b64encode(data).decode()}
        last: Exception | None = None
        r = rpc.FAILOVER_POLICY.start(op="random_write", deadline=deadline)
        while True:
            try:
                # wait_all: readers may hit ANY replica right after the
                # ack (k-faster selection), so the overwrite must be
                # applied everywhere before acking — the same contract
                # the chain gives appends
                dp.raft.propose(entry, wait_all=True)
                return
            except NotLeaderError as e:
                last = e
                if not e.leader or e.leader == self.addr:
                    if r.tick(reason="election"):
                        continue
                else:
                    try:
                        # dedicated forward: the raft leader proposes
                        # as-is, never re-classifies (its local extent
                        # size may lag)
                        self.nodes.get(e.leader).call(
                            "random_write_forward",
                            {"dp_id": dp.dp_id, "extent_id": extent_id,
                             "offset": offset}, data, timeout=15.0)
                        return
                    except Exception as fwd_err:
                        last = fwd_err
                        if r.tick(reason="forward-failed"):
                            continue
            except TimeoutError as e:
                last = e
                # propose() already blocked its own timeout; only check
                # the overall deadline, no extra backoff sleep
                if r.tick(reason="commit-timeout", sleep=False):
                    continue
            break
        raise rpc.RpcError(503, f"dp {dp.dp_id} random write failed: {last}")

    def _disk_index(self, dp_id: int) -> int:
        disk = self.dp_disk.get(dp_id)
        return self.disks.index(disk) if disk in self.disks else 0

    @staticmethod
    def _rot_unit(dp_id: int, extent_id: int) -> str:
        """At-rest fault-plan unit key for one replica's extent copy."""
        return f"dp{dp_id}:e{extent_id}"

    def read(self, dp_id: int, extent_id: int, offset: int, length: int,
             internal: bool = False) -> bytes:
        """internal=True (replica repair) bypasses client QoS — throttling
        recovery is exactly the starvation QoS must not cause."""
        dp = self._dp(dp_id)
        if self.qos is not None and not internal:
            self.qos.acquire_read(length)
        disk_idx = self._disk_index(dp_id)
        t0 = time.monotonic()
        try:
            data = verified_read(
                dp.store, extent_id, offset, length,
                node_addr=self.addr or str(self.node_id),
                disk_id=disk_idx, unit=self._rot_unit(dp_id, extent_id),
                source="repair" if internal else "read")
            self.health.record_io(disk_idx, time.monotonic() - t0)
            return data
        except BlockCrcError:
            raise  # data integrity, not disk death: 409 path upstream
        except (OSError, ExtentError) as e:
            self.health.record_io(disk_idx, time.monotonic() - t0, ok=False)
            self._disk_io_guard(dp_id, e)

    # ---------------- repair (CRC fingerprint diff) ----------------
    def extent_fingerprint(self, dp_id: int, extent_id: int) -> tuple[int, int]:
        dp = self._dp(dp_id)
        size = dp.store.size(extent_id)
        if size == 0:  # absent or empty extent: nothing to fingerprint
            return 0, 0
        crc = dp.store.extent_crc(extent_id)
        # a planted at-rest fault must diverge this replica's fingerprint
        # exactly like real rot would, so scrub/fsck replica-compare
        # spots it without the simulation touching native store bytes
        plan = rpc._fault
        if plan is not None:
            kind = plan.at_rest_fault(self.addr or str(self.node_id),
                                      self._disk_index(dp_id),
                                      self._rot_unit(dp_id, extent_id))
            if kind == "torn_write":
                return max(size - 1, 1), crc ^ 0x0F0F0F0F
            if kind is not None:  # bitflip / stale_crc
                return size, crc ^ 0xA5A5A5A5
        return size, crc

    def sync_extent_from(self, dp_id: int, extent_id: int, src_addr: str,
                         source: str = "repair") -> None:
        """Pull a full extent from a healthy replica (streamed in 1MiB
        spans) — the repair executor for CRC/size-diverged replicas AND
        the one in-place rewrite the fs-plane read-repair / scrub / fsck
        healers all route through. ``source`` labels who triggered it
        ("read" | "scrub" | "fsck" | "repair") in the healed metric."""
        dp = self._dp(dp_id)
        meta, _ = self.nodes.get(src_addr).call(
            "extent_fingerprint", {"dp_id": dp_id, "extent_id": extent_id}
        )
        size = meta["size"]
        dp.store.create(extent_id)
        span = 1 << 20
        for off in range(0, size, span):
            _, chunk = self.nodes.get(src_addr).call(
                "read_internal", {"dp_id": dp_id, "extent_id": extent_id,
                                  "offset": off,
                                  "length": min(span, size - off)},
            )
            dp.store.write(extent_id, off, chunk)
        plan = rpc._fault
        if plan is not None and plan.heal_rot(
                self.addr or str(self.node_id), self._disk_index(dp_id),
                self._rot_unit(dp_id, extent_id)):
            # the rewrite replaced a genuinely rotten copy (heal_rot is
            # False for rewrites of clean units — zero false repairs)
            metrics.integrity_corruptions_healed.inc(plane="fs",
                                                     source=source)

    # ---------------- RPC surface ----------------
    def rpc_create_partition(self, args, body):
        self.create_partition(args["dp_id"], args["peers"], args["leader"])
        return {}

    def rpc_alloc_extent(self, args, body):
        return {"extent_id": self._dp(args["dp_id"]).alloc_extent(
            op_id=args.get("op_id"))}

    def rpc_write(self, args, body):
        self.write(args["dp_id"], args["extent_id"], args["offset"], body,
                   hops=args.get("hops", 2))
        return {}

    def rpc_random_write_forward(self, args, body):
        # raft-leader leg of an overwrite classified by the designated
        # leader: propose only, never re-classify
        dp = self._dp(args["dp_id"])
        if dp.raft is None:
            raise rpc.RpcError(500, f"dp {args['dp_id']} has no raft group")
        self._random_write(dp, args["extent_id"], args["offset"], body)
        return {}

    def rpc_write_replica(self, args, body):
        # follower leg: apply locally, never re-forward
        self.write(args["dp_id"], args["extent_id"], args["offset"], body,
                   chain=False)
        return {}

    def rpc_read_internal(self, args, body):
        # repair plane: QoS-exempt (see read())
        try:
            data = self.read(args["dp_id"], args["extent_id"],
                             args["offset"], args["length"], internal=True)
        except BlockCrcError as e:
            raise rpc.RpcError(409, str(e)) from None
        except ExtentError as e:
            raise rpc.RpcError(500, str(e)) from None
        return {}, data

    def rpc_read(self, args, body):
        try:
            data = self.read(args["dp_id"], args["extent_id"], args["offset"],
                             args["length"])
        except BlockCrcError as e:
            raise rpc.RpcError(409, str(e)) from None
        except ExtentError as e:
            raise rpc.RpcError(500, str(e)) from None
        return {}, data

    def rpc_extent_fingerprint(self, args, body):
        size, crc = self.extent_fingerprint(args["dp_id"], args["extent_id"])
        return {"size": size, "crc": crc}

    def rpc_disk_report(self, args, body):
        return {"disks": self.disk_report()}

    def rpc_drop_partition(self, args, body):
        self.drop_partition(args["dp_id"])
        return {}

    def rpc_mark_disk_broken(self, args, body):
        self.mark_disk_broken(args["path"])
        return {}

    def rpc_list_extents(self, args, body):
        store = self._dp(args["dp_id"]).store
        eids = store.list_extents()
        out = {"extents": eids}
        if args.get("want_ages"):
            # one stat(2) per extent — only fsck's orphan pass needs it
            out["ages"] = {str(e): store.extent_age(e) for e in eids}
        return out

    def rpc_delete_extent(self, args, body):
        self._dp(args["dp_id"]).store.delete(args["extent_id"])
        return {}

    def rpc_sync_extent_from(self, args, body):
        self.sync_extent_from(args["dp_id"], args["extent_id"],
                              args["src_addr"],
                              source=args.get("source", "repair"))
        return {}

    def rpc_dp_raft_status(self, args, body):
        """Raft role/leader/term of one dp's overwrite group (ops/debug
        surface; the CLI's datapartition status path)."""
        dp = self._dp(args["dp_id"])
        st = dp.raft.status() if dp.raft is not None else None
        return {"status": st}

    def rpc_stat(self, args, body):
        with self._repair_lock:
            pending = [
                {"dp_id": dp, "extent_id": ext, "peer": peer,
                 "running": st["running"]}
                for (dp, ext, peer), st in self.pending_repairs.items()
            ]
        with self._lock:
            native_ops = (self._native_lib.ds_op_count(self._native_h)
                          if self._native_h is not None else 0)
        return {"node_id": self.node_id, "partitions": sorted(self.partitions),
                "pending_repairs": pending,
                "disks": self.disk_report(),
                "native_read_ops": native_ops,
                "native_read_addr": self.native_addr}

    # ---------------- binary packet plane (proto/packet.go analog) -----
    # The HOT data path speaks the 64-byte-header binary protocol over
    # persistent TCP, not HTTP: the packet server maps opcodes straight
    # onto the same write/read/repair logic, so both transports share
    # one consistency story (leader routing, raft overwrites, chain).
    def serve_packets(self, host: str = "127.0.0.1",
                      port: int = 0, audit=None,
                      workers: int | None = None) -> "packet.PacketServer":
        from ..utils import packet

        def op_write(hdr, args, payload):
            self.write(hdr["partition"], hdr["extent"], hdr["offset"],
                       payload, hops=args.get("hops", 2))
            return {}, b""

        def op_write_replica(hdr, args, payload):
            self.write(hdr["partition"], hdr["extent"], hdr["offset"],
                       payload, chain=False)
            return {}, b""

        def op_read(hdr, args, payload):
            try:
                data = self.read(hdr["partition"], hdr["extent"],
                                 hdr["offset"], args["length"])
            except BlockCrcError as e:
                raise packet.PacketError(0xC1, str(e)) from None
            except ExtentError as e:
                raise packet.PacketError(0xC2, str(e)) from None
            return {}, data

        def op_fingerprint(hdr, args, payload):
            size, crc = self.extent_fingerprint(hdr["partition"],
                                                hdr["extent"])
            return {"size": size, "crc": crc}, b""

        def op_alloc(hdr, args, payload):
            return {"extent_id": self._dp(hdr["partition"]).alloc_extent()}, b""

        def op_ping(hdr, args, payload):
            return {"node_id": self.node_id}, b""

        srv = packet.PacketServer({
            packet.OP_WRITE: op_write,
            packet.OP_WRITE_REPLICA: op_write_replica,
            packet.OP_READ: op_read,
            packet.OP_FINGERPRINT: op_fingerprint,
            packet.OP_ALLOC_EXTENT: op_alloc,
            packet.OP_PING: op_ping,
        }, host=host, port=port, service="datanode", audit=audit,
           workers=workers,
           # one client's pipelined piece train must apply in arrival
           # order per extent: write() classifies append-vs-overwrite
           # by the extent's current size, so pool reordering would
           # misread disjoint in-window appends as overlap and divert
           # them through raft (a ~6x write-throughput cliff)
           ordered_ops={packet.OP_WRITE, packet.OP_WRITE_REPLICA}).start()
        self.packet_addr = srv.addr
        self._packet_srv = srv
        return srv

    def stop(self) -> None:
        srv = getattr(self, "_packet_srv", None)
        if srv is not None:
            srv.stop()
        with self._lock:
            # null under the lock: every other ds_* caller holds this
            # lock for its whole call, so once we observe/clear the
            # handle here nobody can be mid-call on it
            h, self._native_h = self._native_h, None
        if h is not None:
            # stop the native plane and drain its reads BEFORE closing
            # stores: a read racing a close would touch freed memory;
            # then free the DataServe (no leak per node lifecycle)
            self._native_lib.ds_stop(h)
            for dp_id in list(self.partitions):
                self._native_lib.ds_drop_partition(h, dp_id)
            self._native_lib.ds_destroy(h)
        for dp in self.partitions.values():
            if dp.raft is not None:
                dp.raft.stop()
            dp.store.close()
        self.partitions.clear()
