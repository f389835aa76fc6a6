"""Scheduler: the background-task brain of the EC plane.

Role parity: blobstore/scheduler — disk repair (disk_repairer.go:38,
collectTask:197, AcquireTask:761), shard-repair and blob-delete queue
consumers (shard_repairer.go, blob_deleter.go), task leasing with renew
and idempotent re-queue (migrate.go:941), and per-type runtime
kill-switches (common/taskswitch). Workers (blob/worker.py)
pull leased tasks and do the codec math on the codec engine.

The port's copy of ``cubefs_tpu/blob/scheduler.py``: broken disks to
repair tasks, the lease protocol, the repair and delete queues,
``TaskSwitch``, migrate, balance and rebalance, the inspector, compaction,
task persistence and the checkpoint into the clustermgr's kv. The
inspector's parity recompute, which the continuous scrubber drives
over every volume (``make_scrubber``, ``utils/scrub.py``), runs on
``codecio``'s engine for the scheduler's ``device`` and engine name.
Shard tasks (``shard_repair``/``shard_migrate``) are queued for dead
or migrated shardnodes, leased and completed into the clustermgr's
catalog as the reference's are.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid

import numpy as np

from ..codec import codemode as cmode
from ..ops import rs_kernel
from ..utils import lockwitness, metrics, qos, rpc
from ..utils import scrub as scrublib
from ..utils.retry import MONOTONIC, RetryPolicy

# shard deletes: 2 quick retries on node-level blips, tightly bounded —
# the kafka-style delete queue re-drives real failures later anyway
_DELETE_POLICY = RetryPolicy(base=0.02, cap=0.2, max_retries=2, deadline=2.0)
from . import codecio, topology
from .topology import NoAvailableDisks
from .types import DiskStatus, VolumeInfo


class TaskSwitch:
    """Runtime on/off switches per background task type."""

    def __init__(self):
        self._off: set[str] = set()
        self._lock = lockwitness.make_lock("TaskSwitch._lock")

    def enable(self, kind: str) -> None:
        with self._lock:
            self._off.discard(kind)

    def disable(self, kind: str) -> None:
        with self._lock:
            self._off.add(kind)

    def enabled(self, kind: str) -> bool:
        with self._lock:
            return kind not in self._off


class Scheduler:
    LEASE_SECONDS = 30.0

    def __init__(self, cm_obj, repair_queue=None, delete_queue=None,
                 node_pool=None, data_dir: str | None = None,
                 device=None, engine: str = "auto"):
        # cm_obj is the ClusterMgr object (leader-colocated, like the
        # reference scheduler's direct clustermgr client)
        self.cm = cm_obj
        self.repair_queue = repair_queue
        self.delete_queue = delete_queue
        self.nodes = node_pool
        # the inspector's batched parity recompute; 'auto' inherits the
        # measured crossover policy and coalesces with foreground
        # PUT/repair work in the admission layer
        self.codec = codecio.engine(device, engine)
        self.switch = TaskSwitch()
        self._lock = lockwitness.make_rlock("Scheduler._lock")
        self.tasks: dict[str, dict] = {}  # task_id -> record
        self._done_units: dict[int, set[int]] = {}  # disk -> unit indexes done
        self.last_drain_plan: dict = {}  # most recent plan_disk_drain result
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # task-state checkpoint + transition record log (reference:
        # scheduler checkpoints to clustermgr KV + recordlog audit
        # files). With a data_dir, checkpoints are a local file; WITHOUT
        # one, they ride the clustermgr's replicated kvmgr — task state
        # then survives scheduler NODE loss, which is exactly why the
        # reference checkpoints into clustermgr.
        self.data_dir = data_dir
        self._cm_kv = (not data_dir and hasattr(cm_obj, "kv_get")
                       and hasattr(cm_obj, "kv_set"))
        self._kv_synced = False  # see _kv_flush_now: merge-before-write
        self._kv_warned = False
        self._kv_dirty = threading.Event()
        if self._cm_kv:
            threading.Thread(target=self._kv_flush_loop,
                             daemon=True).start()
        self._recordlog = None
        restored = {}
        if data_dir:
            os.makedirs(data_dir, exist_ok=True)
            tpath = os.path.join(data_dir, "tasks.json")
            if os.path.exists(tpath):
                try:
                    restored = json.load(open(tpath))
                except json.JSONDecodeError:
                    restored = {}
            self._recordlog = open(os.path.join(data_dir, "records.jsonl"), "a")
        elif self._cm_kv:
            try:
                raw = cm_obj.kv_get("sched/tasks")
                restored = json.loads(raw) if raw else {}
            except Exception:
                restored = {}
        if restored:
            with self._lock:
                for t in restored.values():
                    if t["state"] == "leased":
                        t["state"] = "pending"  # lease died with us
                self.tasks = restored

    def _record(self, task_id: str, event: str, **kw) -> None:
        if self._recordlog is not None:
            self._recordlog.write(json.dumps(
                {"ts": round(time.time(), 3), "task": task_id,
                 "event": event, **kw}) + "\n")
            self._recordlog.flush()

    def _checkpoint(self) -> None:
        if self.data_dir:
            tmp = os.path.join(self.data_dir, "tasks.json.tmp")
            with self._lock:
                with open(tmp, "w") as f:
                    json.dump(self.tasks, f)
            os.replace(tmp, os.path.join(self.data_dir, "tasks.json"))
            return
        if self._cm_kv:
            # callers hold the scheduler RLock: the actual kv commit (a
            # quorum raft round on a replicated cm) runs in the flusher
            # thread so worker lease RPCs never queue behind it
            self._kv_dirty.set()

    def _kv_flush_now(self) -> None:
        """One cm-KV checkpoint write (flusher thread; tests call it
        directly for synchronous behavior)."""
        # merge-before-first-write: a standby scheduler that won cm
        # leadership restored an older (possibly empty) snapshot at
        # construction — adopting kv-only tasks before overwriting
        # keeps e.g. manually queued migrations from being lost
        if not self._kv_synced:
            try:
                raw = self.cm.kv_get("sched/tasks")
                remote = json.loads(raw) if raw else {}
            except Exception:
                remote = {}
            with self._lock:
                for tid, t in remote.items():
                    if tid not in self.tasks:
                        if t.get("state") == "leased":
                            t["state"] = "pending"
                        self.tasks[tid] = t
        with self._lock:
            # done tasks stay in memory for reporting but need no
            # durability — an O(done-history) raft commit per
            # transition is the wrong cost shape
            blob = json.dumps({tid: t for tid, t in self.tasks.items()
                               if t.get("state") != "done"})
        try:
            self.cm.kv_set("sched/tasks", blob)
            self._kv_synced = True
        except Exception as e:
            self._kv_synced = False  # re-merge before the next write
            self._kv_dirty.set()  # the flusher RETRIES (with backoff)
            if not self._kv_warned:
                self._kv_warned = True
                import sys

                print(f"scheduler: cm-kv checkpoint failed ({e}); "
                      f"will keep retrying", file=sys.stderr)

    def _kv_flush_loop(self) -> None:
        while True:
            self._kv_dirty.wait()
            if self._stop.is_set():
                # drain the final checkpoint on graceful shutdown — a
                # transition requested just before stop() must not be
                # silently dropped (e.g. a manually queued migration)
                if self._kv_dirty.is_set():
                    self._kv_dirty.clear()
                    self._kv_flush_now()
                return
            self._kv_dirty.clear()
            self._kv_flush_now()  # bursts batch into one commit
            if not self._kv_synced:
                # failed write re-set the dirty flag: back off instead
                # of hot-looping against a leaderless cm
                self._stop.wait(1.0)

    # ---------------- task generation ----------------
    def collect_broken_disks(self) -> list[int]:
        """Failure detector → repair work: mark heartbeat-dead disks
        BROKEN and emit one migrate task per volume-unit on them.

        A freshly elected clustermgr leader has a heartbeat view that is
        entirely stale (heartbeats are leader-local); without a grace
        period it would declare every healthy disk dead and storm the
        cluster with migrations."""
        if not self.switch.enabled("disk_repair"):
            return []
        if not self._leader_grace_ok():
            return []
        newly = []
        for disk_id in self.cm.suspect_dead_disks():
            self.mark_disk_broken(disk_id)
            newly.append(disk_id)
        return newly

    def mark_disk_broken(self, disk_id: int) -> int:
        """Explicit breakage report (blobnode disk report analog);
        idempotent. Returns number of tasks queued."""
        with self._lock:
            disk = self.cm.disks[disk_id]
            if disk.status not in (DiskStatus.NORMAL, DiskStatus.BROKEN):
                return 0
            self.cm.set_disk_status(disk_id, DiskStatus.REPAIRING)
            n = 0
            for vid, unit_index in self.cm.volumes_on_disk(disk_id):
                self._queue_unit_repair(vid, unit_index, reason=f"disk {disk_id} broken",
                                        src_disk=disk_id)
                n += 1
            if n == 0:
                self.cm.set_disk_status(disk_id, DiskStatus.REPAIRED)
        if n:
            # planning measures drain sizes over the network — it must
            # run AFTER the lock is dropped (with the RLock held here it
            # would reenter and hold it across every list_chunk RPC,
            # stalling lease/complete/heartbeat for the whole survey)
            self.plan_disk_drain(disk_id)
        return n

    def _unit_bytes(self, vid: int, unit_index: int) -> int:
        """Drain size of one failed slot, measured from any surviving
        unit's chunk listing (shards of a stripe are equal-width, so a
        survivor's chunk bytes == the dead slot's chunk bytes)."""
        if self.nodes is None:
            return 0
        vol = self.cm.get_volume(vid)
        for u in vol.units:
            if u.index == unit_index:
                continue
            try:
                meta, _ = self.nodes.get(u.node_addr).call(
                    "list_chunk",
                    {"disk_id": u.disk_id, "chunk_id": u.chunk_id})
                return sum(s for _, s, _ in meta["shards"])
            except Exception:
                continue
        return 0

    def _drain_bytes(self, vid: int, unit_index: int) -> int:
        """Drain weight of one repair task for step packing. The unit of
        account is the conventional path's pull: one chunk-width per
        survivor read is normalized to ONE chunk (the historical
        convention). An MSR sub-shard repair pulls d beta-symbols where
        the conventional decode pulls k full shards — d/(alpha*k) of the
        traffic — so more MSR tasks pack into one admission step and the
        coalesced device batches stay full-width."""
        base = self._unit_bytes(vid, unit_index)
        try:
            t = cmode.tactic(self.cm.get_volume(vid).codemode)
        except (KeyError, ValueError, rpc.RpcError):
            return base
        if not t.is_msr():
            return base
        return max(1, -(-base * t.d // (t.alpha * t.n))) if base else 0

    def plan_disk_drain(self, disk_id: int) -> dict:
        """Group one failed disk's open unit-repair tasks into drain
        steps sized against CUBEFS_CODEC_STEP_BYTES: workers that lease
        a step's tasks together submit reconstructs that coalesce into
        full device-width codec steps instead of one skinny stripe per
        drain. Re-runnable (re-plans the still-open tasks)."""
        try:
            step_bytes = int(os.environ.get(
                "CUBEFS_CODEC_STEP_BYTES", str(64 << 20)) or str(64 << 20))
        except ValueError:
            step_bytes = 64 << 20
        # graceful brownout: while any path burns SLO budget, repair
        # drains in smaller steps so reconstruct reads yield bandwidth
        # to foreground IO (1.0 healthy / 0.5 warn / 0.25 critical)
        qos_scale = qos.repair_step_scale()
        step_bytes = max(1, int(step_bytes * qos_scale))
        # Two-phase so the survey RPCs never run under self._lock (the
        # interprocedural lint, CFL101, flagged the old single-phase
        # shape: _drain_bytes -> _unit_bytes -> list_chunk per task
        # while every lease/complete/heartbeat waited on the lock).
        # Phase 1: snapshot which open tasks still need measuring.
        with self._lock:
            unmeasured = [(t["task_id"], t["vid"], t["unit_index"])
                          for t in self.tasks.values()
                          if t.get("src_disk") == disk_id
                          and t["state"] in ("pending", "leased")
                          and t.get("drain_bytes") is None]
        # Phase 2: measure over the network, lock dropped.
        measured = {task_id: self._drain_bytes(vid, unit_index)
                    for task_id, vid, unit_index in unmeasured}
        # Phase 3: re-acquire, re-check task state (a task may have
        # completed or been cancelled during the survey), then pack.
        with self._lock:
            open_tasks = [t for t in self.tasks.values()
                          if t.get("src_disk") == disk_id
                          and t["state"] in ("pending", "leased")]
            step, acc, total = 0, 0, 0
            for t in open_tasks:
                b = t.get("drain_bytes")
                if b is None:
                    if t["task_id"] in measured:
                        b = t["drain_bytes"] = measured[t["task_id"]]
                    else:
                        b = 0  # queued mid-survey: next re-plan measures
                total += b
                if acc and acc + b > step_bytes:
                    step, acc = step + 1, 0
                t["drain_step"] = step
                acc += b
            plan = {"disk_id": disk_id, "tasks": len(open_tasks),
                    "total_bytes": total, "step_bytes": step_bytes,
                    "qos_scale": qos_scale,
                    "steps": (step + 1) if open_tasks else 0}
            self.last_drain_plan = plan
            if open_tasks:
                self._checkpoint()
            return plan

    def _queue_unit_repair(self, vid: int, unit_index: int, reason: str,
                           src_disk: int | None = None,
                           created_flag: list | None = None,
                           prefer_az: str | None = None,
                           require_az: bool = False,
                           require_new_host: bool = False) -> str:
        """Queue (or dedup to) a unit-repair task. created_flag, if
        given, receives True only when a NEW task was created.

        prefer_az defaults to the failed slot's current AZ so repairs
        stay AZ-local when the AZ has capacity; rebalance moves pass the
        stripe's home AZ with require_az (a move that lands in yet
        another wrong AZ is churn, not progress)."""
        with self._lock:
            for t in self.tasks.values():
                if (t.get("vid") == vid and t.get("unit_index") == unit_index
                        and t["state"] in ("pending", "leased")):
                    return t["task_id"]  # idempotent re-queue
            vol = self.cm.get_volume(vid)
            exclude = {u.disk_id for u in vol.units}
            # pick_destination already filters to NORMAL disks; only a
            # still-NORMAL source (the balance path) needs hard exclusion
            hard = {src_disk} if src_disk is not None else set()
            if prefer_az is None and not require_az:
                prefer_az = vol.units[unit_index].az or None
            avoid = {u.node_addr for u in vol.units
                     if u.index != unit_index}
            dest = self.cm.pick_destination(
                exclude, hard_exclude=hard, prefer_az=prefer_az,
                require_az=require_az, avoid_hosts=avoid,
                require_new_host=require_new_host)
            task = {
                "task_id": uuid.uuid4().hex[:16],
                "type": "unit_repair",
                "vid": vid,
                "unit_index": unit_index,
                "codemode": vol.codemode,
                "src_disk": src_disk,
                "dest_disk": dest.disk_id,
                "dest_chunk": self.cm.alloc_chunk_id(),
                "dest_addr": dest.node_addr,
                "state": "pending",
                "lease_until": 0.0,
                "worker": None,
                "attempts": 0,
                "reason": reason,
            }
            self.tasks[task["task_id"]] = task
            if created_flag is not None:
                created_flag.append(True)
            self._record(task["task_id"], "queued", vid=vid,
                         unit=unit_index, reason=reason)
            self._checkpoint()
            return task["task_id"]

    # ---------------- shard-domain tasks ----------------
    # shard_disk_repairer.go / shard_migrate.go parity: when a shardnode
    # dies (or an operator migrates a replica), queue a task that swaps
    # the replica out of every affected shard's raft group. Raft itself
    # moves the data (InstallSnapshot + appends); the task is the
    # control-plane choreography, leased/parked like every other task.
    def _leader_grace_ok(self) -> bool:
        """Shared failure-detector gate: non-leaders reset the grace
        clock; a (re-)elected leader waits out a full heartbeat window
        before trusting its blind, leader-local liveness view."""
        if not getattr(self.cm, "is_leader", lambda: True)():
            self._leader_since = None
            return False
        if getattr(self.cm, "raft", None) is not None:
            now = time.time()
            if getattr(self, "_leader_since", None) is None:
                self._leader_since = now
            if now - self._leader_since < 2 * self.cm.HEARTBEAT_TIMEOUT:
                return False
        return True

    def collect_dead_shardnodes(self) -> list[str]:
        if not self.switch.enabled("shard_repair"):
            return []
        if not self._leader_grace_ok():
            return []
        dead = self.cm.suspect_dead_shardnodes()
        for addr in dead:
            self.repair_shardnode(addr)
        return dead

    def repair_shardnode(self, dead_addr: str) -> int:
        """Queue one shard_repair task per shard replicated on
        `dead_addr`; idempotent. Returns tasks queued."""
        n = 0
        with self._lock:
            for space, shards in self.cm.snapshot_spaces().items():
                for s in shards:
                    if dead_addr in s["addrs"]:
                        if self._queue_shard_task(
                                "shard_repair", space, s, dead_addr):
                            n += 1
        return n

    def shard_migrate(self, space: str, shard_id: int, src_addr: str,
                      dest_addr: str | None = None) -> str | None:
        """Manual replica move (shard_migrate.go / manual_migrater
        analog); healthy source stays up until the new member is in."""
        with self._lock:
            s = next(x for x in self.cm.get_space(space)
                     if x["shard_id"] == shard_id)
            if src_addr not in s["addrs"]:
                raise ValueError(f"{src_addr} not a replica of shard "
                                 f"{shard_id}")
            if dest_addr is not None:
                if dest_addr in s["addrs"]:
                    raise ValueError(f"{dest_addr} is already a replica "
                                     f"of shard {shard_id}")
                if dest_addr not in self.cm.get_service("shardnode"):
                    raise ValueError(f"{dest_addr} is not a registered "
                                     f"shardnode")
            return self._queue_shard_task("shard_migrate", space, s,
                                          src_addr, dest_addr)

    def _healthy_shardnodes(self, exclude: set[str]) -> list[str]:
        now = time.time()
        out = []
        for addr in self.cm.get_service("shardnode"):
            if addr in exclude:
                continue
            seen = self.cm.shardnode_last_seen(addr)
            if seen is not None and now - seen <= self.cm.HEARTBEAT_TIMEOUT:
                out.append(addr)
        return out

    def _queue_shard_task(self, kind: str, space: str, shard: dict,
                          src_addr: str,
                          dest_addr: str | None = None) -> str | None:
        with self._lock:
            for t in self.tasks.values():
                if (t.get("space") == space
                        and t.get("shard_id") == shard["shard_id"]
                        and t["state"] in ("pending", "leased")):
                    return t["task_id"]  # idempotent re-queue
            if dest_addr is None:
                candidates = self._healthy_shardnodes(set(shard["addrs"]))
                if not candidates:
                    return None  # nowhere to go yet; next sweep retries
                # least-load spread (pick_destination analog): count
                # catalog replicas + already-queued repairs per addr so
                # a 50-shard node's death doesn't dogpile one spare
                load: dict[str, int] = {c: 0 for c in candidates}
                for shards in self.cm.snapshot_spaces().values():
                    for x in shards:
                        for a in x["addrs"]:
                            if a in load:
                                load[a] += 1
                for t in self.tasks.values():
                    if (t["type"] in ("shard_repair", "shard_migrate")
                            and t["state"] in ("pending", "leased")
                            and t["dest_addr"] in load):
                        load[t["dest_addr"]] += 1
                dest_addr = min(candidates, key=lambda c: load[c])
            new_addrs = [dest_addr if a == src_addr else a
                         for a in shard["addrs"]]
            task = {
                "task_id": uuid.uuid4().hex[:16],
                "type": kind,
                "space": space,
                "shard_id": shard["shard_id"],
                "start": shard["start"],
                "end": shard["end"],
                "src_addr": src_addr,
                "dest_addr": dest_addr,
                "old_addrs": list(shard["addrs"]),
                "new_addrs": new_addrs,
                "state": "pending",
                "lease_until": 0.0,
                "worker": None,
                "attempts": 0,
                "reason": f"{kind} away from {src_addr}",
            }
            self.tasks[task["task_id"]] = task
            self._record(task["task_id"], "queued", space=space,
                         shard=shard["shard_id"], src=src_addr,
                         dest=dest_addr)
            self._checkpoint()
            return task["task_id"]

    def drop_disk(self, disk_id: int) -> int:
        """Planned decommission: same migrate machinery, healthy source."""
        with self._lock:
            self.cm.set_disk_status(disk_id, DiskStatus.REPAIRING)
            n = 0
            for vid, unit_index in self.cm.volumes_on_disk(disk_id):
                self._queue_unit_repair(vid, unit_index,
                                        reason=f"disk {disk_id} drop", src_disk=disk_id)
                n += 1
            return n

    # ---------------- queue consumers ----------------
    def consume_repair_msgs(self, max_n: int = 64) -> int:
        """Shard-repair events from access (failed PUT shards, degraded
        GETs) → unit repair tasks."""
        if self.repair_queue is None or not self.switch.enabled("shard_repair"):
            return 0
        msgs = self.repair_queue.poll(max_n)
        n = 0
        for off, msg in msgs:
            if msg.get("type") == "shard_repair":
                self._queue_unit_repair(msg["vid"], msg["bad_index"],
                                        reason="shard repair msg")
                n += 1
            self.repair_queue.ack(off)
        return n

    def consume_delete_msgs(self, max_n: int = 64) -> int:
        if self.delete_queue is None or not self.switch.enabled("blob_delete"):
            return 0
        msgs = self.delete_queue.poll(max_n)
        n = 0
        for off, msg in msgs:
            if msg.get("type") == "blob_delete":
                self._delete_blobs(msg["vid"], msg["min_bid"], msg["count"])
                n += 1
            self.delete_queue.ack(off)
        return n

    def _delete_blobs(self, vid: int, min_bid: int, count: int) -> None:
        vol = self.cm.get_volume(vid)
        for k in range(count):
            bid = min_bid + k
            for u in vol.units:
                # a transient node blip gets a small bounded retry
                # (RetryPolicy budget); anything else is left for the
                # inspector sweep to re-delete — delete_shard is
                # idempotent by key
                r = _DELETE_POLICY.start(op="delete_shard")
                while True:
                    try:
                        self.nodes.get(u.node_addr).call(
                            "delete_shard",
                            {"disk_id": u.disk_id, "chunk_id": u.chunk_id,
                             "bid": bid},
                        )
                        break
                    except rpc.ServiceUnavailable:
                        if not r.tick(reason="delete-blip"):
                            break
                    except rpc.RpcError:
                        break

    # ---------------- balance / manual migrate / inspect ----------------
    def balance(self, max_moves: int = 4, threshold: int = 2) -> int:
        """Move units off the most-loaded disks onto the least-loaded
        (balancer.go role). Only counts NORMAL disks; a move is the same
        unit_repair machinery with a healthy source."""
        if not self.switch.enabled("balance"):
            return 0
        with self._lock:
            normal = [d for d in self.cm.disks.values()
                      if d.status == DiskStatus.NORMAL]
            if len(normal) < 2:
                return 0
            normal = topology.order_by_load(normal)
            # account planned moves locally — never mutate clustermgr's
            # records outside its apply door, and never count deduped
            # re-queues as movement
            planned: dict[int, int] = {}
            moves = 0
            for hot in reversed(normal):
                cold = normal[0]
                eff_hot = hot.chunk_count - planned.get(hot.disk_id, 0)
                if eff_hot - cold.chunk_count < threshold or moves >= max_moves:
                    break
                units = self.cm.volumes_on_disk(hot.disk_id)
                if not units:
                    continue
                vid, unit_index = units[0]
                created: list = []
                self._queue_unit_repair(vid, unit_index,
                                        reason=f"balance off disk {hot.disk_id}",
                                        created_flag=created)
                if created:
                    planned[hot.disk_id] = planned.get(hot.disk_id, 0) + 1
                    moves += 1
            return moves

    REBALANCE_MAX_MOVES = 4  # per sweep: converge without a move storm

    def rebalance_sweep(self, max_moves: int | None = None) -> dict:
        """Failure-domain rebalance (tentpole consumer 2): score every
        volume for misplacement — wrong-AZ units first, then intra-AZ
        host colocation — and queue rate-limited unit migrations through
        the ordinary repair machinery until the cluster converges.
        Sets the cubefs_placement_* gauges on every pass, so the scoring
        runs (and the gauges stay fresh) even when nothing moves."""
        if max_moves is None:
            max_moves = self.REBALANCE_MAX_MOVES
        empty = {"moves": 0, "misplaced_units": None, "colocated_units": None,
                 "az_skew": None}
        if not self.switch.enabled("rebalance"):
            return empty
        if not self._leader_grace_ok():
            return empty
        with self._lock:
            disk_map = {d.disk_id: d for d in self.cm.disks.values()}
            vols = [self.cm.get_volume(v) for v in sorted(self.cm.volumes)]
        rep = topology.cluster_misplacement(vols, disk_map)
        metrics.placement_misplaced.set(rep["misplaced_units"])
        metrics.placement_az_skew.set(rep["az_skew"])
        moves = 0
        # wrong-AZ slots move home (require_az: landing in a third AZ is
        # churn); colocated slots move to a fresh host in their own AZ
        # (require_new_host: a move that stays stacked is churn too)
        plan = ([("wrong_az", m, m["want"], True) for m in rep["wrong_az"]]
                + [("colocated", m, m["az"] or None, bool(m["az"]))
                   for m in rep["colocated"]])
        for kind, m, want_az, require_az in plan:
            if moves >= max_moves:
                break
            created: list = []
            try:
                self._queue_unit_repair(
                    m["vid"], m["slot"],
                    reason=f"rebalance {kind} -> {want_az or 'spread'}",
                    prefer_az=want_az, require_az=require_az,
                    require_new_host=(kind == "colocated"),
                    created_flag=created)
            except NoAvailableDisks:
                continue  # no strictly-better home yet; next sweep retries
            if created:
                moves += 1
                metrics.rebalance_moves.inc(reason=kind)
        return {"moves": moves, "misplaced_units": rep["misplaced_units"],
                "colocated_units": rep["colocated_units"],
                "az_skew": rep["az_skew"]}

    def rpc_rebalance(self, args, body):
        mm = args.get("max_moves")
        return self.rebalance_sweep(int(mm) if mm is not None else None)

    def manual_migrate(self, vid: int, unit_index: int) -> str:
        """Operator-requested unit migration (manual_migrater.go role)."""
        return self._queue_unit_repair(vid, unit_index, reason="manual migrate")

    def inspect_volumes(self, max_volumes: int = 8, max_bids: int = 64) -> dict:
        """Scrubber (volume_inspector.go role): re-reads stripes and
        verifies parity with a BATCHED device call per (volume, size)
        group; inconsistent or unreadable units become repair tasks."""
        if not self.switch.enabled("volume_inspect"):
            return {"checked": 0, "bad": 0}
        checked = bad = 0
        with self._lock:
            all_vids = sorted(self.cm.volumes)
            if not all_vids:
                return {"checked": 0, "bad": 0}
            # rotating cursor: max_volumes is a batch size, not a
            # coverage cap — every volume gets scrubbed eventually
            start = getattr(self, "_inspect_cursor", 0) % len(all_vids)
            vids = (all_vids[start:] + all_vids[:start])[:max_volumes]
            self._inspect_cursor = (start + len(vids)) % len(all_vids)
        for vid in vids:
            rep = self._inspect_volume(vid, max_bids=max_bids)
            checked += rep["checked"]
            bad += rep["bad"]
        return {"checked": checked, "bad": bad}

    def _inspect_volume(self, vid: int, max_bids: int = 64) -> dict:
        """Verify one volume's stripes against recomputed parity (the
        per-volume body shared by inspect_volumes and the continuous
        scrubber): batched device parity recompute, unique-culprit
        isolation, repair tasks for missing/corrupt units."""
        checked = bad = missing_units = 0
        vol = self.cm.get_volume(vid)
        t = cmode.tactic(vol.codemode)
        listings: dict[int, dict[int, tuple[int, int]]] = {}
        for u in vol.units:
            try:
                meta, _ = self.nodes.get(u.node_addr).call(
                    "list_chunk", {"disk_id": u.disk_id, "chunk_id": u.chunk_id}
                )
                listings[u.index] = {b: (s, c) for b, s, c in meta["shards"]}
            except rpc.RpcError:
                listings[u.index] = {}
        bids = sorted(set().union(*[set(l) for l in listings.values()]))[:max_bids]
        by_size: dict[int, list[int]] = {}
        for bid in bids:
            sizes = {listings[i][bid][0] for i in listings if bid in listings[i]}
            if len(sizes) == 1:
                by_size.setdefault(sizes.pop(), []).append(bid)
        for size, group in by_size.items():
            stripes = np.zeros((len(group), t.total, size), dtype=np.uint8)
            missing: dict[int, set[int]] = {}  # group idx -> unit idxs
            for gi, bid in enumerate(group):
                for u in vol.units:
                    try:
                        _, payload = self.nodes.get(u.node_addr).call(
                            "get_shard",
                            {"disk_id": u.disk_id, "chunk_id": u.chunk_id,
                             "bid": bid, "source": "scrub"},
                        )
                        stripes[gi, u.index] = np.frombuffer(payload, np.uint8)
                    except rpc.RpcError:
                        missing.setdefault(gi, set()).add(u.index)
            checked += len(group)
            # one batched device parity recompute, per-stripe verdicts
            parity = self.codec.encode_parity(stripes[:, : t.n], t.m)
            mismatch = (parity != stripes[:, t.n : t.n + t.m]).any(axis=-1)
            for gi, bid in enumerate(group):
                miss = missing.get(gi, set())
                for idx in miss:
                    missing_units += 1
                    self._queue_unit_repair(vol.vid, idx,
                                            reason=f"inspect: bid {bid} missing")
                if mismatch[gi].any() and not miss:
                    bad += 1
                    culprit = self._isolate_corrupt_unit(self.codec, t,
                                                         stripes[gi])
                    if culprit is not None:
                        # never "repair" parity from possibly-corrupt
                        # data: repair exactly the unit whose exclusion
                        # makes the stripe a consistent codeword
                        self._queue_unit_repair(
                            vol.vid, culprit,
                            reason=f"inspect: bid {bid} corrupt unit")
                    # multi-corruption: leave for operators; repairing
                    # any single unit could cement wrong data
        return {"checked": checked, "bad": bad, "missing": missing_units}

    # ---------------- continuous scrub (full-cursor) ----------------
    def make_scrubber(self, clock=None, rate: float = 0.0):
        """Build (or rebuild) the blob-plane continuous scrubber: the
        full-cursor extension of inspect_volumes — every volume, up to
        4096 bids each, verified through the same batched parity path,
        admitted at SCRUB priority (brownout sheds it), cursor persisted
        like task checkpoints (data_dir file or cm KV)."""
        def list_units() -> list:
            return sorted(self.cm.volumes)

        def scrub_unit(vid) -> str:
            try:
                with qos.admit("blob.scrub", priority=qos.SCRUB,
                                  svc="scheduler"):
                    rep = self._inspect_volume(int(vid), max_bids=4096)
            except qos.QosRejected:
                return "skipped"  # brownout: give way to foreground
            return "corrupt" if (rep["bad"] or rep["missing"]) else "clean"

        def cursor_load():
            if self.data_dir:
                path = os.path.join(self.data_dir, "scrub_cursor.json")
                if os.path.exists(path):
                    return json.load(open(path)).get("cursor")
                return None
            if self._cm_kv:
                raw = self.cm.kv_get("sched/scrub_cursor")
                return json.loads(raw).get("cursor") if raw else None
            return None

        def cursor_save(cursor) -> None:
            if self.data_dir:
                tmp = os.path.join(self.data_dir, "scrub_cursor.json.tmp")
                with open(tmp, "w") as f:
                    json.dump({"cursor": cursor}, f)
                os.replace(tmp, os.path.join(self.data_dir,
                                             "scrub_cursor.json"))
            elif self._cm_kv:
                self.cm.kv_set("sched/scrub_cursor",
                               json.dumps({"cursor": cursor}))

        self.scrubber = scrublib.Scrubber(
            "blob", list_units, scrub_unit,
            clock=clock or MONOTONIC, rate=rate,
            cursor_load=cursor_load, cursor_save=cursor_save)
        return self.scrubber

    def collect_quarantined_disks(self) -> list[int]:
        """Quarantine → drain: every disk a blobnode heartbeat flipped
        to QUARANTINED gets ONE plan_disk_drain kick (existing data
        migrates off the limping disk; topology's NORMAL filter already
        stopped new allocations). Tracked so repeat sweeps don't
        re-plan; a disk probed back to NORMAL re-arms the kick."""
        kicked = []
        with self._lock:
            seen = getattr(self, "_quarantine_kicked", None)
            if seen is None:
                seen = self._quarantine_kicked = set()
            for d in list(self.cm.disks.values()):
                if d.status == DiskStatus.QUARANTINED:
                    if d.disk_id not in seen:
                        seen.add(d.disk_id)
                        kicked.append(d.disk_id)
                else:
                    seen.discard(d.disk_id)
        for disk_id in kicked:
            try:
                self.plan_disk_drain(disk_id)
            except Exception:
                pass  # planning is advisory; next quarantine re-kicks
        return kicked

    def rpc_scrub_status(self, args, body):
        s = getattr(self, "scrubber", None)
        return {"scrub": s.status() if s is not None else None}

    def rpc_scrub_run(self, args, body):
        s = getattr(self, "scrubber", None)
        if s is None:
            s = self.make_scrubber()
        if args.get("full"):
            return {"result": s.run_full_pass()}
        return {"result": s.run_once(
            max_units=int(args.get("max_units", 8)))}

    @staticmethod
    def _isolate_corrupt_unit(codec, t, stripe) -> int | None:
        """Find the single unit whose exclusion leaves a consistent
        codeword (reconstruct it from the rest and compare everything
        else). Returns None when no unique culprit exists."""
        n, total = t.n, t.n + t.m
        culprits = []
        for c in range(total):
            present = [i for i in range(total) if i != c]
            rows = rs_kernel.reconstruct_rows(n, total, present, [c])
            rebuilt = codec.matrix_apply(rows, stripe[present[:n]])[0]
            candidate = stripe.copy()
            candidate[c] = rebuilt
            par = codec.encode_parity(candidate[None, :n], t.m)[0]
            if np.array_equal(par, candidate[n:total]):
                culprits.append(c)
        return culprits[0] if len(culprits) == 1 else None

    def compact_chunks(self, max_chunks: int = 16) -> dict:
        """Space-reclaim sweep: compact chunks round-robin with a
        rotating cursor (core/chunk/compact.go role; own kill switch;
        called periodically from the background loop and exposed via
        RPC for operators)."""
        if not self.switch.enabled("compact"):
            return {"compacted": 0, "reclaimed": 0}
        with self._lock:
            units = []
            for v in sorted(self.cm.volumes):
                vol = self.cm.get_volume(v)
                units.extend(vol.units)
            if not units:
                return {"compacted": 0, "reclaimed": 0}
            start = getattr(self, "_compact_cursor", 0) % len(units)
            batch = (units[start:] + units[:start])[:max_chunks]
            self._compact_cursor = (start + len(batch)) % len(units)
        compacted = reclaimed = 0
        for u in batch:
            try:
                meta, _ = self.nodes.get(u.node_addr).call(
                    "compact_chunk",
                    {"disk_id": u.disk_id, "chunk_id": u.chunk_id},
                )
                compacted += 1
                reclaimed += meta["reclaimed"]
            except rpc.RpcError:
                continue
        return {"compacted": compacted, "reclaimed": reclaimed}

    def rpc_compact_chunks(self, args, body):
        return self.compact_chunks(int(args.get("max_chunks", 16)))

    # ---------------- task leasing (worker API) ----------------
    def acquire_task(self, worker_id: str) -> dict | None:
        now = time.time()
        with self._lock:
            for t in self.tasks.values():
                if t["state"] == "leased" and t["lease_until"] < now:
                    t["state"] = "pending"  # lease expired -> requeue
                if t["state"] == "pending":
                    t["state"] = "leased"
                    t["worker"] = worker_id
                    t["attempts"] += 1
                    t["lease_until"] = now + self.LEASE_SECONDS
                    self._record(t["task_id"], "leased", worker=worker_id,
                                 attempt=t["attempts"])
                    return dict(t)
            return None

    def renew_task(self, task_id: str, worker_id: str) -> bool:
        with self._lock:
            t = self.tasks.get(task_id)
            if t and t["state"] == "leased" and t["worker"] == worker_id:
                t["lease_until"] = time.time() + self.LEASE_SECONDS
                return True
            return False

    def complete_task(self, task_id: str, worker_id: str) -> None:
        with self._lock:
            t = self.tasks.get(task_id)
            if not t or t["worker"] != worker_id or t["state"] != "leased":
                return  # stale completion; writeback already idempotent
            t["state"] = "done"
            self._record(task_id, "done", worker=worker_id)
            # checkpoint AFTER the cm writeback: a crash in between must
            # re-run the (idempotent) repair, never lose it
            if t["type"] in ("shard_repair", "shard_migrate"):
                self.cm.update_shard_addrs(t["space"], t["shard_id"],
                                           t["new_addrs"])
                self._checkpoint()
                return
            self.cm.update_volume_unit(
                t["vid"], t["unit_index"], t["dest_disk"], t["dest_chunk"],
                t["dest_addr"],
            )
            src = t.get("src_disk")
            if src is not None:
                pending = any(
                    x.get("src_disk") == src and x["state"] != "done"
                    for x in self.tasks.values()
                )
                if not pending:
                    self.cm.set_disk_status(src, DiskStatus.REPAIRED)
            self._checkpoint()

    MAX_ATTEMPTS = 5

    def fail_task(self, task_id: str, worker_id: str, error: str) -> None:
        with self._lock:
            t = self.tasks.get(task_id)
            if t and t["worker"] == worker_id:
                # deterministic failures (e.g. the worker's crc-conflict
                # refusal) must not hot-loop forever: after MAX_ATTEMPTS
                # the task parks for operator attention
                if t["attempts"] >= self.MAX_ATTEMPTS:
                    t["state"] = "parked"
                else:
                    t["state"] = "pending"
                t["last_error"] = error
                self._record(task_id, "failed" if t["state"] == "pending"
                             else "parked",
                             worker=worker_id, error=error[:120])
                self._checkpoint()

    def stats(self) -> dict:
        with self._lock:
            by_state: dict[str, int] = {}
            for t in self.tasks.values():
                by_state[t["state"]] = by_state.get(t["state"], 0) + 1
            return {"tasks": by_state,
                    "repair_backlog": self.repair_queue.backlog() if self.repair_queue else 0,
                    "delete_backlog": self.delete_queue.backlog() if self.delete_queue else 0}

    # ---------------- background loop ----------------
    def start(self, interval: float = 1.0) -> None:
        def loop():
            while not self._stop.wait(interval):
                try:
                    if not getattr(self.cm, "is_leader", lambda: True)():
                        # replicated cm: only the leader's scheduler
                        # generates tasks — and losing leadership must
                        # reset the grace clock even while the switch
                        # gates skip the collectors
                        self._leader_since = None
                        continue
                    self.collect_broken_disks()
                    self.collect_dead_shardnodes()
                    self.collect_quarantined_disks()
                    self.consume_repair_msgs()
                    self.consume_delete_msgs()
                    self._ticks = getattr(self, "_ticks", 0) + 1
                    if self._ticks % 30 == 0:  # failure-domain convergence
                        self.rebalance_sweep()
                    if self._ticks % 60 == 0:  # periodic space reclaim
                        self.compact_chunks()
                    if self._ticks % 10 == 0 and self.switch.enabled("scrub"):
                        # continuous integrity scrub: a small slice per
                        # tick; the Scrubber itself handles QoS shedding,
                        # the CUBEFS_SCRUB door and cursor resume
                        s = getattr(self, "scrubber", None)
                        if s is None:
                            s = self.make_scrubber()
                        s.run_once(max_units=2)
                except Exception:
                    pass  # leader loop must survive transient errors

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._kv_dirty.set()  # wake the kv flusher so it can exit

    # ---------------- RPC surface ----------------
    def rpc_acquire_task(self, args, body):
        t = self.acquire_task(args["worker_id"])
        return {"task": t}

    def rpc_renew_task(self, args, body):
        return {"ok": self.renew_task(args["task_id"], args["worker_id"])}

    def rpc_complete_task(self, args, body):
        self.complete_task(args["task_id"], args["worker_id"])
        return {}

    def rpc_fail_task(self, args, body):
        self.fail_task(args["task_id"], args["worker_id"], args.get("error", ""))
        return {}

    TASK_KINDS = ("disk_repair", "shard_repair", "blob_delete", "balance",
                  "rebalance", "volume_inspect", "compact", "scrub")

    def rpc_task_switch(self, args, body):
        """Runtime kill-switches per background task kind (taskswitch
        analog): action=enable|disable|list. Unknown kinds are rejected
        so a typo can never silently leave a task running."""
        action = args.get("action", "list")
        if action not in ("enable", "disable", "list"):
            raise rpc.RpcError(400, f"unknown action {action!r}")
        if action in ("enable", "disable"):
            kind = args.get("kind")
            if kind not in self.TASK_KINDS:
                raise rpc.RpcError(
                    400, f"unknown task kind {kind!r}; "
                         f"have {list(self.TASK_KINDS)}")
            getattr(self.switch, action)(kind)
        return {"switches": {k: self.switch.enabled(k)
                             for k in self.TASK_KINDS}}

    def rpc_stats(self, args, body):
        return self.stats()
