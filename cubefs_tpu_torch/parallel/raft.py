"""Raft consensus: the replication substrate for metadata services.

The port's copy of ``cubefs_tpu/parallel/raft.py``, host-only like the
reference's: the on-disk format (``meta.json``, ``raft.jsonl``, the
snapshot file) and the wire (the ``raft_*`` routes, their args and
bodies) are the reference's, so a data directory written by either
package opens in the other and a group may mix members of both. It
reads the reference's four switches at their defaults:
``CUBEFS_RAFT_GROUP_COMMIT`` (on), ``CUBEFS_RAFT_PIPELINE`` (4),
``CUBEFS_RAFT_MUX`` (on) and ``CUBEFS_RAFT_MUX_SENDERS`` (8).

Role parity: depends/tiglabs/raft (multi-raft lib: leader/follower/
candidate FSMs, log replication, snapshot transfer, vote/heartbeat RPC
planes) and blobstore/common/raftserver — re-implemented compactly over
this framework's RPC layer rather than ported. One `RaftNode` is one
group member; a process hosts many nodes (multi-raft = one RaftNode per
metadata partition, sharing a transport).

Design notes:
  * The applied state machine is a callable `apply_fn(entry: dict)`;
    metadata services plug their submit→apply door straight in.
  * Election + replication follow the Raft paper: randomized election
    timeout; term-checked RequestVote with the up-to-date-log rule;
    AppendEntries with (prev_index, prev_term) consistency check and
    conflict truncation; commit at the majority match of the current
    term; a term-noop committed on election (§5.4.2) so prior-term
    entries become committable.
  * Log compaction: the log is offset-based (`log_base` = absolute index
    of the last compacted entry). With `snapshot_fn`/`restore_fn`
    configured, the node auto-compacts past COMPACT_THRESHOLD entries
    and leaders stream the FSM snapshot to followers whose next index
    was compacted away (InstallSnapshot).
  * propose() waiters are keyed by (index, term): if leadership changes
    and the slot is overwritten by another leader's entry, the waiter
    gets NotLeaderError instead of a false success.
  * Persistence: (term, voted_for, log_base/term) in meta.json; log
    entries as jsonl; FSM snapshot bytes beside them. Every WAL record
    carries its ABSOLUTE index, so the log file is self-aligning: a
    crash between snapshot/meta persistence and the WAL rewrite can
    never replay entries at wrong positions — load() simply skips
    records at or below the restored log_base. Appends are fsync'd
    before an entry is acknowledged; rewrites go through tmp +
    os.replace + directory fsync.
  * Pipelined replication (CUBEFS_RAFT_PIPELINE, default 4): instead of
    one synchronous ship-then-await loop per follower, the leader keeps
    up to W AppendEntries in flight per follower — batch N+1 is
    dispatched (and its WAL fsync runs) while followers are still
    acking batch N, and concurrent appends queued at a follower share
    its group fsync. next_index is advanced OPTIMISTICALLY at dispatch
    time (tracked as `_shipped`); acknowledged progress still only
    moves through the max()-guarded match_index/next_index updates, so
    commit-index advancement stays quorum-ordered. Sends are carried by
    the ReplMux: per-NodePool, per-address sender lanes shared by every
    group targeting that address (proposals for hundreds of partitions
    share sockets/threads, not one loop each). `=0` restores the
    per-peer synchronous repl threads. CUBEFS_RAFT_MUX (default on)
    likewise collapses the per-node election/compaction tickers into
    ONE TickMux thread per pool.
"""

from __future__ import annotations

import base64
import json
import os
import queue as _queue
import random
import threading
import time

from ..utils import faultinject as _fi
from ..utils import lockwitness
from ..utils import metrics as _metrics
from ..utils import trace as _trace


class NotLeaderError(Exception):
    def __init__(self, leader: str | None, reason: str = "not leader"):
        super().__init__(f"{reason}; try {leader!r}")
        self.leader = leader


class _ProposeWaiter:
    """One propose() call parked in the leader's group-commit batcher.
    Resolved exactly once — by the apply loop (result/exc), a failed
    drain (NotLeaderError), or stop() — then its private event fires:
    waiters never contend on a shared condition variable."""

    __slots__ = ("entry", "index", "term", "result", "exc", "done",
                 "event", "ref", "enq_t")

    def __init__(self, entry: dict):
        self.entry = entry
        self.index = 0  # absolute index, assigned by the drain
        self.term = 0
        self.result = None
        self.exc: BaseException | None = None
        self.done = False
        self.event = threading.Event()
        # span handoff: the draining caller's context is the only one
        # that survives into the batch — every other submitter's span
        # reaches the drain span through this captured ref
        self.ref = _trace.capture()
        self.enq_t = time.perf_counter()

    def resolve(self, result, exc: BaseException | None) -> None:
        self.result = result
        self.exc = exc
        self.done = True
        self.event.set()


class RaftNode:
    ELECTION_MIN = 0.15
    ELECTION_MAX = 0.30
    HEARTBEAT = 0.05
    COMPACT_THRESHOLD = 1024  # log entries kept before auto-snapshot

    NOOP = {"__raft_noop__": True}

    def __init__(self, group_id: str, me: str, peers: list[str], apply_fn,
                 pool, data_dir: str | None = None,
                 snapshot_fn=None, restore_fn=None, seeded: bool = False):
        self.group_id = group_id
        self.me = me
        self.peers = [p for p in peers if p != me]
        self.apply_fn = apply_fn
        self.snapshot_fn = snapshot_fn  # () -> bytes of FSM state
        self.restore_fn = restore_fn  # (bytes) -> None
        self.pool = pool
        self.data_dir = data_dir

        self._lock = lockwitness.make_rlock("RaftNode._lock")
        # synchronous role/leader-change hook (e.g. the native meta read
        # plane's serving flag): invoked UNDER the node lock, so
        # listeners must be non-blocking and must never call back into
        # this node. Fired only when (role, leader) actually changes —
        # listeners like ms_set_serving take an exclusive native lock,
        # and re-firing on every heartbeat would block the GIL-free
        # read plane once per heartbeat interval for no state change.
        self.role_listener = None
        self._last_notified: tuple | None = None
        self.term = 0
        self.voted_for: str | None = None
        self.log: list[dict] = []  # entries AFTER log_base
        self.log_base = 0  # absolute index of last compacted entry
        self.log_base_term = 0
        self.commit_index = 0  # absolute, 1-based; 0 = nothing
        self.last_applied = 0
        self.role = "follower"
        self.leader: str | None = None
        self.next_index: dict[str, int] = {}
        self.match_index: dict[str, int] = {}
        self.applied_index: dict[str, int] = {}  # peer's last_applied
        self._last_heard = time.monotonic()
        self._election_due = self._rand_timeout()
        self._stop = threading.Event()
        self._apply_cv = threading.Condition(self._lock)
        self._waiters: dict[int, _ProposeWaiter] = {}  # absolute index ->
        # proposal group commit: concurrent propose() callers enqueue
        # here; whichever caller finds the batcher idle drains the whole
        # queue as ONE log append / WAL write / replication round.
        # CUBEFS_RAFT_GROUP_COMMIT=0 keeps the per-call path (A/B knob).
        self._prop_mu = lockwitness.make_lock("RaftNode._prop_mu")
        self._prop_queue: list[_ProposeWaiter] = []
        self._prop_busy = False
        self._group_commit = (
            os.environ.get("CUBEFS_RAFT_GROUP_COMMIT", "1") != "0"
        )
        self._wal = None
        self._wal_unclean = False
        # group-commit state: records are WRITTEN+flushed under the node
        # lock, fsync'd OUTSIDE it by _wal_sync (concurrent acks share
        # one disk flush). _wal_mu guards the handle vs rewrite swaps.
        self._wal_mu = lockwitness.make_lock("RaftNode._wal_mu")
        self._sync_cv = threading.Condition()
        self._sync_active = False
        self._wal_written = 0  # abs idx written+flushed
        self._wal_synced = 0   # abs idx fsync'd
        if data_dir:
            os.makedirs(data_dir, exist_ok=True)
            self._load()
            self._wal_written = self._wal_synced = self._last_index()
            self._wal = open(self._wal_path(), "a")
            if self._wal_unclean:
                # the file held garbage/skipped records beyond the loaded
                # prefix: rewrite it before appending, or new acknowledged
                # entries would land after the garbage and be dropped by
                # the next load
                self._persist_entries([], rewrote=True)
        if seeded and self.term == 0 and not self.log_base and not self.log:
            # a fresh group whose FSM begins with state its log will not
            # hold (a shard born of a split): that state is entry 1 of
            # term 0, compacted on every founding member, so a member
            # that joins later with an empty log is sent a snapshot of it
            self.log_base = self.commit_index = self.last_applied = 1
            self._wal_written = self._wal_synced = 1
            self._persist_meta()
        # pipelined replication door: W in-flight AppendEntries per
        # follower, dispatched through the shared ReplMux lanes. "0"
        # restores the per-peer synchronous repl threads below exactly.
        try:
            self._pipeline = max(
                0, int(os.environ.get("CUBEFS_RAFT_PIPELINE", "4") or "0"))
        except ValueError:
            self._pipeline = 4
        # timer mux door: enroll in the per-pool TickMux instead of
        # running a private 10ms election/compaction ticker thread
        self._use_mux = os.environ.get("CUBEFS_RAFT_MUX", "1") != "0"
        self._tick_busy = False  # TickMux: an election/compaction runs
        self._ticker: threading.Thread | None = None
        # pipelined-mode send progress, all guarded by _lock:
        #   _shipped[peer]  highest abs index handed to the mux
        #                   (optimistic next_index; 0 = resend from the
        #                   acknowledged next_index)
        #   _inflight[peer] append/snapshot RPCs currently in flight
        #   _repl_retry[peer] transport-error backoff deadline
        self._shipped: dict[str, int] = {}
        self._inflight: dict[str, int] = {}
        self._repl_retry: dict[str, float] = {}
        self._replmux: "ReplMux | None" = None
        # legacy plane (pipeline=0): one long-lived replication thread
        # per peer (the tiglabs-raft dedicated-transport analog):
        # signaled on propose/leadership, self-firing every HEARTBEAT
        # while leader
        legacy_peers = [] if self._pipeline else self.peers
        self._repl_events = {p: threading.Event() for p in legacy_peers}
        self._repl_threads = [
            threading.Thread(target=self._repl_loop, args=(p,), daemon=True)
            for p in legacy_peers
        ]

    # ---------------- index helpers (absolute <-> list) ----------------
    def _last_index(self) -> int:
        return self.log_base + len(self.log)

    def _term_at(self, abs_index: int) -> int:
        if abs_index == self.log_base:
            return self.log_base_term
        return self.log[abs_index - 1 - self.log_base]["term"]

    def _entry_at(self, abs_index: int) -> dict:
        return self.log[abs_index - 1 - self.log_base]

    # ---------------- persistence ----------------
    def _wal_path(self) -> str:
        return os.path.join(self.data_dir, "raft.jsonl")

    def _snap_path(self) -> str:
        return os.path.join(self.data_dir, "snapshot.json")

    def _fsync_dir(self) -> None:
        fd = os.open(self.data_dir, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def _write_atomic(self, path: str, payload: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self._fsync_dir()

    def _persist_meta(self) -> None:
        if not self.data_dir:
            return
        self._write_atomic(
            os.path.join(self.data_dir, "meta.json"),
            json.dumps({"term": self.term, "voted_for": self.voted_for,
                        "log_base": self.log_base,
                        "log_base_term": self.log_base_term}),
        )

    def _persist_entries(self, appended: list[dict], rewrote: bool) -> None:
        """appended = strict suffix newly appended to self.log; rewrote =
        a conflict truncated/overwrote earlier entries (or compaction):
        rewrite the whole wal so it never holds duplicates. Records carry
        absolute indices; appends are fsync'd before returning (= before
        the entry can be acknowledged to a leader or proposer)."""
        if self._wal is None:
            return
        if rewrote:
            with self._wal_mu:  # vs a concurrent group fsync
                self._wal.close()
                lines = [
                    json.dumps({"idx": self.log_base + i + 1, **rec})
                    for i, rec in enumerate(self.log)
                ]
                self._write_atomic(
                    self._wal_path(), "".join(ln + "\n" for ln in lines)
                )
                self._wal = open(self._wal_path(), "a")
            with self._sync_cv:
                self._wal_written = self._last_index()
                self._wal_synced = self._wal_written  # replace+fsync'd
        else:
            base = self._last_index() - len(appended)
            for i, rec in enumerate(appended):
                self._wal.write(json.dumps({"idx": base + i + 1, **rec}) + "\n")
            self._wal.flush()
            # fsync is DEFERRED to _wal_sync, called by the proposer /
            # append handler outside the node lock before acknowledging:
            # concurrent callers share one group fsync instead of
            # serializing a disk flush each under the lock
            with self._sync_cv:
                self._wal_written = self._last_index()

    def _wal_sync(self, through: int) -> None:
        """Group commit: block until WAL records through absolute index
        `through` are fsync'd. The first caller becomes the syncer; the
        rest wait on its flush — N concurrent acks cost ONE fsync. Never
        called under the node lock."""
        if self._wal is None:
            return
        while True:
            with self._sync_cv:
                if through <= self._wal_synced:
                    return
                if self._sync_active:
                    self._sync_cv.wait(timeout=1.0)
                    continue
                self._sync_active = True
                target = self._wal_written
            try:
                with self._wal_mu:
                    wal = self._wal
                    if wal is not None:
                        os.fsync(wal.fileno())
                        _metrics.raft_wal_fsyncs.inc(group=self.group_id)
            finally:
                with self._sync_cv:
                    self._sync_active = False
                    self._wal_synced = max(self._wal_synced, target)
                    self._sync_cv.notify_all()

    def _persist_snapshot(self, data: bytes) -> None:
        if not self.data_dir:
            return
        self._write_atomic(
            self._snap_path(),
            json.dumps({"index": self.log_base, "term": self.log_base_term,
                        "data": base64.b64encode(data).decode()}),
        )

    def _load(self) -> None:
        meta = os.path.join(self.data_dir, "meta.json")
        if os.path.exists(meta):
            m = json.load(open(meta))
            self.term, self.voted_for = m["term"], m["voted_for"]
            self.log_base = m.get("log_base", 0)
            self.log_base_term = m.get("log_base_term", 0)
        if os.path.exists(self._snap_path()) and self.restore_fn:
            s = json.load(open(self._snap_path()))
            self.restore_fn(base64.b64decode(s["data"]))
            self.log_base = s["index"]
            self.log_base_term = s["term"]
        self.commit_index = self.last_applied = self.log_base
        if os.path.exists(self._wal_path()):
            for line in open(self._wal_path()):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    # torn tail write: entry was never acknowledged
                    self._wal_unclean = True
                    break
                idx = rec.pop("idx", None)
                if idx is None:
                    # legacy record without absolute index: sequential
                    self.log.append(rec)
                    self._wal_unclean = True  # rewrite with indices
                elif idx <= self.log_base:
                    self._wal_unclean = True  # covered by the snapshot
                elif idx == self.log_base + len(self.log) + 1:
                    self.log.append(rec)
                else:
                    # gap/misalignment: trust only the contiguous prefix
                    self._wal_unclean = True
                    break

    # ---------------- lifecycle ----------------
    def start(self) -> "RaftNode":
        if self._use_mux:
            TickMux.get(self.pool).enroll(self)
        else:
            self._ticker = threading.Thread(
                target=self._tick_loop, daemon=True)
            self._ticker.start()
        if self._pipeline and self.peers:
            self._replmux = ReplMux.get(self.pool)
            self._replmux.enroll(self)
        for t in self._repl_threads:
            t.start()
        if self.peers:
            HeartbeatMux.get(self.pool).enroll(self)
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._use_mux:
            TickMux.get(self.pool).drop(self)
        if self._replmux is not None:
            self._replmux.drop(self)
            self._replmux = None
        if self.peers:
            HeartbeatMux.get(self.pool).drop(self)
        for ev in self._repl_events.values():
            ev.set()  # wake replication threads so they exit promptly
        with self._apply_cv:
            self._apply_cv.notify_all()
        # drain barrier: an apply already inside the lock finishes before
        # stop() returns, and handlers that were queued ON the lock are
        # rejected by the inside-lock stop checks — so a successor node
        # over the same wal/FSM can never interleave with late applies
        # from this instance
        with self._lock:
            waiters = list(self._waiters.values())
            self._waiters.clear()
            if self._wal is not None:
                self._wal.close()
                self._wal = None
        for w in waiters:
            w.resolve(None, NotLeaderError(None, "node stopped"))

    def _rand_timeout(self) -> float:
        return random.uniform(self.ELECTION_MIN, self.ELECTION_MAX)

    def _tick_loop(self) -> None:
        while not self._stop.wait(0.01):
            with self._lock:
                role = self.role
                overdue = (
                    time.monotonic() - self._last_heard > self._election_due
                )
                want_compact = (
                    self.snapshot_fn is not None
                    and len(self.log) > self.COMPACT_THRESHOLD
                    and self.last_applied > self.log_base
                )
            if want_compact:
                self.take_snapshot()
            if role == "leader":
                # replication (incl. heartbeats) is driven by the
                # per-peer threads; nothing to do here
                time.sleep(self.HEARTBEAT)
            elif overdue:
                self._run_election()

    def _repl_loop(self, peer: str) -> None:
        """The BULK replication plane: ships log entries/snapshots,
        paced per HEARTBEAT while there is work. Idle liveness is the
        HeartbeatMux's job — an idle leader's repl thread blocks on its
        event, so bulk and heartbeat planes never contend."""
        ev = self._repl_events[peer]
        while not self._stop.is_set():
            with self._lock:
                leading = self.role == "leader"
                pending = leading and (
                    self.next_index.get(peer, self._last_index() + 1)
                    <= self._last_index()
                )
            if not leading or not pending:
                # woken by propose/commit-advance/leadership-change
                ev.wait()
                ev.clear()
                continue
            # ship entries, then pace (a signal mid-wait short-circuits)
            self._append_to(peer)
            ev.wait(self.HEARTBEAT)
            ev.clear()

    def _kick_repl(self, peer: str | None = None) -> None:
        """Wake the replication plane: the ReplMux dispatcher in
        pipelined mode, the per-peer thread(s) in legacy mode."""
        if self._pipeline:
            mux = self._replmux
            if mux is not None:
                mux.kick(self)
        elif peer is None:
            for ev in self._repl_events.values():
                ev.set()
        else:
            ev = self._repl_events.get(peer)
            if ev is not None:
                ev.set()

    def _dispatch_appends(self, mux: "ReplMux") -> bool:
        """Pipelined-mode send pass (called by the ReplMux dispatcher):
        for every follower with unshipped entries and a free window
        slot, build AppendEntries from the OPTIMISTIC send cursor
        (`_shipped`) and hand it to the peer's sender lane — without
        waiting for outstanding acks. Returns True when pending work
        was left undispatched (window full, snapshot in flight, or
        error backoff) so the mux re-ticks this node at heartbeat pace
        instead of waiting for an ack that may never come."""
        jobs: list[tuple[str, str, dict]] = []
        blocked = False
        now = time.monotonic()
        with self._lock:
            if self._stop.is_set() or self.role != "leader":
                return False
            last = self._last_index()
            for peer in self.peers:
                ni = self.next_index.get(peer, last + 1)
                start = max(ni, self._shipped.get(peer, 0) + 1)
                if ni > self.log_base and start > last:
                    continue  # fully shipped (acks may still be pending)
                if now < self._repl_retry.get(peer, 0.0):
                    blocked = True
                    continue
                inflight = self._inflight.get(peer, 0)
                if inflight >= self._pipeline:
                    blocked = True
                    continue
                if ni <= self.log_base:
                    # peer needs compacted entries: stream the snapshot,
                    # never pipelining around it (its reply resets the
                    # peer's whole cursor). The snapshot is stamped at
                    # last_applied — snapshot_fn() reflects exactly that
                    # index under the lock, and pairing it with the
                    # (older) log_base would make the follower re-apply
                    # the gap on top of state that already contains it
                    if self.snapshot_fn is None:
                        continue
                    if inflight:
                        blocked = True
                        continue
                    upto = self.last_applied
                    args = {
                        "term": self.term, "leader": self.me,
                        "index": upto,
                        "snap_term": self._term_at(upto),
                        "data": base64.b64encode(self.snapshot_fn()).decode(),
                    }
                    self._shipped[peer] = upto
                    jobs.append((peer, "snap", args))
                else:
                    prev_index = start - 1
                    prev_term = (
                        self._term_at(prev_index) if prev_index else 0)
                    args = {
                        "term": self.term, "leader": self.me,
                        "prev_index": prev_index, "prev_term": prev_term,
                        "entries": self.log[start - 1 - self.log_base:],
                        "commit": self.commit_index,
                    }
                    self._shipped[peer] = last
                    jobs.append((peer, "append", args))
                self._inflight[peer] = inflight + 1
                _metrics.raft_inflight_window.observe(
                    inflight + 1, group=self.group_id)
        appended = sum(1 for j in jobs if j[1] == "append")
        if appended:
            _metrics.raft_pipelined_appends.inc(
                appended, group=self.group_id)
        for peer, kind, args in jobs:
            mux.submit(self, peer, kind, args)
        return blocked

    def _on_repl_error(self, peer: str) -> None:
        """A pipelined send to `peer` failed in transport: resend from
        the acknowledged next_index after a heartbeat's backoff (the
        legacy loop's retry pacing)."""
        with self._lock:
            self._shipped[peer] = 0
            self._repl_retry[peer] = time.monotonic() + self.HEARTBEAT

    def _on_snapshot_reply(self, peer: str, args: dict, meta: dict) -> None:
        with self._lock:
            if self._stop.is_set():
                return
            if meta.get("term", 0) > self.term:
                self._step_down(meta["term"])
            elif meta.get("ok") and self.role == "leader" \
                    and args.get("term") == self.term:
                self.match_index[peer] = max(
                    self.match_index.get(peer, 0), args["index"])
                self.next_index[peer] = max(
                    self.next_index.get(peer, 1), args["index"] + 1)
                self.applied_index[peer] = max(
                    self.applied_index.get(peer, 0), args["index"])
                self._apply_cv.notify_all()

    def _repl_job_done(self, peer: str) -> None:
        """A mux sender finished one RPC for `peer`: free its window
        slot and re-kick the dispatcher so the slot refills."""
        with self._lock:
            self._inflight[peer] = max(0, self._inflight.get(peer, 0) - 1)
        self._kick_repl()

    def heartbeat_args(self) -> list[tuple[str, dict]]:
        """(peer, empty-AppendEntries args) for every peer this LEADER
        has no pending entries for — consumed by the HeartbeatMux."""
        out = []
        with self._lock:
            if self.role != "leader" or self._stop.is_set():
                return out
            last = self._last_index()
            for peer in self.peers:
                ni = self.next_index.get(peer, last + 1)
                if ni <= self.log_base or ni <= last \
                        or self._inflight.get(peer, 0):
                    continue  # snapshot/bulk replication owns this peer
                prev_index = ni - 1
                prev_term = self._term_at(prev_index) if prev_index else 0
                out.append((peer, {
                    "term": self.term, "leader": self.me,
                    "prev_index": prev_index, "prev_term": prev_term,
                    "entries": [], "commit": self.commit_index,
                }))
        return out

    # ---------------- snapshot / compaction ----------------
    def take_snapshot(self) -> None:
        """Compact the log up to last_applied using the FSM's snapshot."""
        if self.snapshot_fn is None:
            return
        with self._lock:
            upto = self.last_applied
            if upto <= self.log_base:
                return
            data = self.snapshot_fn()
            self.log_base_term = self._term_at(upto)
            del self.log[: upto - self.log_base]
            self.log_base = upto
            self._persist_snapshot(data)
            self._persist_meta()
            self._persist_entries([], rewrote=True)

    def handle_install_snapshot(self, args: dict, body: bytes) -> dict:
        if self._stop.is_set():
            return {"ok": False, "term": 0}
        with self._lock:
            if self._stop.is_set():
                return {"ok": False, "term": 0}
            if args["term"] < self.term:
                return {"ok": False, "term": self.term}
            if args["term"] > self.term or self.role != "follower":
                self._step_down(args["term"])
            self.leader = args["leader"]
            self._notify_role()
            self._last_heard = time.monotonic()
            if args["index"] <= self.log_base:
                return {"ok": True, "term": self.term}
            if self.restore_fn is not None:
                self.restore_fn(base64.b64decode(args["data"]))
            self.log = []
            self.log_base = args["index"]
            self.log_base_term = args["snap_term"]
            self.commit_index = self.last_applied = self.log_base
            self._persist_snapshot(base64.b64decode(args["data"]))
            self._persist_meta()
            self._persist_entries([], rewrote=True)
            return {"ok": True, "term": self.term}

    # ---------------- election ----------------
    def _run_election(self) -> None:
        with self._lock:
            self.term += 1
            self.role = "candidate"
            self.voted_for = self.me
            self.leader = None
            self._notify_role()
            self._persist_meta()
            term = self.term
            last_index = self._last_index()
            last_term = self._term_at(last_index) if last_index else 0
            self._last_heard = time.monotonic()
            self._election_due = self._rand_timeout()
        votes = 1
        vlock = lockwitness.make_lock("RaftNode.vlock")
        done = threading.Event()
        majority = (len(self.peers) + 1) // 2 + 1
        if votes >= majority:  # single-node group
            self._become_leader(term)
            return

        def ask(peer):
            nonlocal votes
            try:
                # declare identity so injected partitions cut BOTH
                # directions of this node's traffic (faultinject)
                with _fi.sender(self.me):
                    meta, _ = self.pool.get_direct(peer).call(
                        f"raft_{self.group_id}_vote",
                        {"term": term, "candidate": self.me,
                         "last_index": last_index, "last_term": last_term},
                        timeout=1.0,
                    )
            except Exception:
                return
            with self._lock:
                if meta.get("term", 0) > self.term:
                    self._step_down(meta["term"])
                    done.set()
                    return
            if meta.get("granted"):
                with vlock:
                    votes += 1
                    if votes >= majority:
                        done.set()

        threads = [threading.Thread(target=ask, args=(p,), daemon=True)
                   for p in self.peers]
        for t in threads:
            t.start()
        done.wait(timeout=self.ELECTION_MIN)
        with vlock:
            won = votes >= majority
        if won:
            self._become_leader(term)

    def _become_leader(self, term: int) -> None:
        with self._lock:
            if self.role != "candidate" or self.term != term:
                return
            self.role = "leader"
            self.leader = self.me
            self._notify_role()
            n = self._last_index() + 1
            self.next_index = {p: n for p in self.peers}
            self.match_index = {p: 0 for p in self.peers}
            # fresh leadership: forget optimistic send cursors from any
            # earlier term of ours (in-flight decrements are max(0,·)-
            # guarded, so stale completions can't corrupt the window)
            self._shipped = {p: 0 for p in self.peers}
            self._repl_retry.clear()
            # commit a current-term no-op immediately: prior-term entries
            # can only commit transitively through it (Raft §5.4.2)
            rec = {"term": self.term, "entry": dict(self.NOOP)}
            self.log.append(rec)
            self._persist_entries([rec], rewrote=False)
            noop_idx = self._last_index()
        self._wal_sync(noop_idx)
        self._kick_repl()  # wake the replication plane for the new term
        self._broadcast_append()

    def _notify_role(self) -> None:
        # change-only: handle_append calls this on EVERY heartbeat, and
        # an exclusive-locking listener re-fired per heartbeat is the
        # native-read-plane stall regression. Dedup only once a
        # listener exists, so one attached late still hears the current
        # state on the next transition attempt.
        fn = self.role_listener
        if fn is None:
            return
        state = (self.role, self.leader)
        if state == self._last_notified:
            return
        self._last_notified = state
        try:
            fn(self.role, self.leader)
        except Exception:
            pass

    def _step_down(self, term: int) -> None:
        # caller holds the lock
        self.term = max(self.term, term)
        self.role = "follower"
        self.voted_for = None
        self.leader = None  # stale self/old-leader would misroute redirects
        self._notify_role()
        self._persist_meta()
        # do NOT reset the election timer here (Raft §5.2: only a GRANTED
        # vote or a valid AppendEntries resets it — both callers set
        # _last_heard themselves on those paths). Resetting on every
        # higher-term RequestVote lets a log-behind candidate that can
        # never win (§5.4.1 restriction) suppress this node's own
        # election forever: a two-node livelock where the node with the
        # committed log stays follower while the empty-log peer
        # term-ratchets — observed over the HTTP transport, where a
        # heartbeat gap is long enough for the empty peer to campaign.
        self._election_due = self._rand_timeout()

    # ---------------- replication ----------------
    def propose(self, entry: dict, timeout: float = 5.0,
                wait_all: bool = False):
        """Leader-only: append + replicate + wait for commit+apply.
        Returns the state machine's apply result (re-raising the apply
        exception if the op failed deterministically). A leadership
        change that drops the entry raises NotLeaderError — never a
        false success.

        Group commit: concurrent propose() callers enqueue into the
        batcher; whichever caller finds it idle drains EVERY waiting
        entry into one log append under one lock acquisition, one WAL
        write feeding the shared group fsync, and one replication kick
        — N concurrent proposals cost one replication round, not N.
        Each caller then blocks on its own per-index event; the apply
        loop applies a whole drained batch before waking the waiters,
        so there is no notify_all herd re-checking a shared dict.

        wait_all=True additionally waits until EVERY peer has
        acknowledged replication through this entry before returning
        (all-replica ack, the chain-replication consistency contract):
        use it when readers may hit any replica right after the ack.
        Raises TimeoutError if a peer stays behind — the entry is
        committed, but not yet everywhere."""
        if self._stop.is_set():
            raise NotLeaderError(None, "node stopped")
        with self._lock:
            if self.role != "leader":
                raise NotLeaderError(self.leader)
        w = _ProposeWaiter(entry)
        with _trace.stage("raft_propose"):
            return self._propose_wait(w, timeout, wait_all)

    def _propose_wait(self, w: _ProposeWaiter, timeout: float,
                      wait_all: bool):
        if self._group_commit:
            with self._prop_mu:
                self._prop_queue.append(w)
                drain = not self._prop_busy
                if drain:
                    self._prop_busy = True
            if drain:
                self._drain_proposals()
        else:
            # A/B control: per-call append round (still shares the
            # group fsync with any concurrent caller, as before)
            last = self._append_batch([w])
            if last:
                self._wal_sync(last)
                self._broadcast_append()
        deadline = time.monotonic() + timeout
        if not w.event.wait(timeout):
            with self._lock:
                if w.index:
                    self._waiters.pop(w.index, None)
            if not w.done:  # lost the race to a concurrent resolve?
                raise TimeoutError(
                    f"entry {w.index or '?'} not committed in time")
        if w.exc is not None:
            raise w.exc
        if wait_all:
            index = w.index
            with self._apply_cv:
                while any(self.applied_index.get(p, 0) < index
                          for p in self.peers):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or self._stop.is_set():
                        raise TimeoutError(
                            f"entry {index} committed but not yet applied "
                            f"on all replicas")
                    self._apply_cv.wait(remaining)
        return w.result

    def _drain_proposals(self) -> None:
        """The caller that found the batcher idle drains it: repeatedly
        swap out the queue and land each swap as one lock acquisition /
        log append / WAL write / replication kick. Entries arriving
        while a swap is appending or fsyncing ride the next swap — the
        fsync window is exactly where concurrent callers pile up, so
        batch width tracks contention with no added idle latency."""
        while True:
            with self._prop_mu:
                batch = self._prop_queue
                if not batch:
                    self._prop_busy = False
                    return
                self._prop_queue = []
            t0 = time.perf_counter()
            _trace.observe_stage("propose_queue_wait", "meta.write",
                                 [t0 - w.enq_t for w in batch])
            span = _trace.start_span(
                "stage:propose_drain",
                links=[w.ref for w in batch if w.ref is not None])
            span.set_tag("stage", "propose_drain")
            span.set_tag("entries", len(batch))
            with span:
                last = self._append_batch(batch)
                if last:
                    with _trace.stage("group_fsync", path="meta.write"):
                        self._wal_sync(last)
                    self._broadcast_append()
            _trace.observe_stage("propose_drain",
                                 span.path or "meta.write",
                                 time.perf_counter() - t0)

    def _append_batch(self, batch: list[_ProposeWaiter]) -> int:
        """Append every waiter's entry under ONE node-lock acquisition
        and ONE WAL write+flush. Returns the absolute index of the last
        appended entry, or 0 if the leadership re-check failed (every
        waiter is then resolved with NotLeaderError)."""
        with self._lock:
            if self._stop.is_set() or self.role != "leader":
                stopped = self._stop.is_set()
                err = NotLeaderError(
                    None if stopped else self.leader,
                    "node stopped" if stopped else "not leader")
                for w in batch:
                    w.resolve(None, err)
                return 0
            recs = []
            for w in batch:
                rec = {"term": self.term, "entry": w.entry}
                self.log.append(rec)
                recs.append(rec)
                w.index = self._last_index()
                w.term = self.term
                self._waiters[w.index] = w
            self._persist_entries(recs, rewrote=False)
            last = self._last_index()
        _metrics.raft_proposals.inc(len(batch), group=self.group_id)
        _metrics.raft_proposal_batches.inc(group=self.group_id)
        _metrics.raft_entries_per_batch.observe(
            len(batch), group=self.group_id)
        return last

    def _broadcast_append(self) -> None:
        with self._lock:
            if self.role != "leader":
                return
        if not self.peers:  # single node: commit = log end
            with self._lock:
                self._advance_commit()
            return
        self._kick_repl()

    def _append_to(self, peer: str) -> None:
        snapshot_args = None
        with self._lock:
            if self.role != "leader":
                return
            ni = self.next_index.get(peer, self._last_index() + 1)
            if ni <= self.log_base:
                # peer needs entries we compacted: stream the snapshot.
                # Stamp it at last_applied — snapshot_fn() reflects that
                # index exactly (read under this lock); stamping the
                # older log_base would make the follower re-apply the
                # log_base..last_applied gap over state that already
                # contains it (double-apply)
                upto = self.last_applied
                if self.snapshot_fn is None:
                    return
                snapshot_args = {
                    "term": self.term, "leader": self.me,
                    "index": upto, "snap_term": self._term_at(upto),
                    "data": base64.b64encode(self.snapshot_fn()).decode(),
                }
            else:
                prev_index = ni - 1
                prev_term = self._term_at(prev_index) if prev_index else 0
                entries = self.log[ni - 1 - self.log_base :]
                args = {
                    "term": self.term, "leader": self.me,
                    "prev_index": prev_index, "prev_term": prev_term,
                    "entries": entries, "commit": self.commit_index,
                }
        try:
            if snapshot_args is not None:
                with _fi.sender(self.me):
                    meta, _ = self.pool.get_direct(peer).call(
                        f"raft_{self.group_id}_snapshot", snapshot_args,
                        timeout=5.0
                    )
                with self._lock:
                    if self._stop.is_set():
                        return
                    if meta.get("term", 0) > self.term:
                        self._step_down(meta["term"])
                    elif meta.get("ok"):
                        self.match_index[peer] = snapshot_args["index"]
                        self.next_index[peer] = snapshot_args["index"] + 1
                        self.applied_index[peer] = max(
                            self.applied_index.get(peer, 0),
                            snapshot_args["index"])
                        self._apply_cv.notify_all()
                return
            with _fi.sender(self.me):
                meta, _ = self.pool.get_direct(peer).call(
                    f"raft_{self.group_id}_append", args, timeout=1.0
                )
        except Exception:
            return
        self._process_append_reply(peer, args, meta)

    def _process_append_reply(self, peer: str, args: dict, meta: dict) -> None:
        with self._lock:
            if self._stop.is_set():
                return  # a successor instance owns the FSM now
            if meta.get("term", 0) > self.term:
                self._step_down(meta["term"])
                return
            if self.role != "leader":
                return
            if args.get("term") != self.term:
                # reply to a send from an OLDER leadership of ours: the
                # acked indices may hold different entries now — with a
                # pipeline's worth of sends in flight across an
                # election, counting them toward match_index could
                # commit an uncommitted slot
                return
            if meta.get("ok"):
                # max() guards: a STALE reply (e.g. an in-flight heartbeat
                # overtaken by an entry append) must never regress the
                # peer's progress — a regressed next_index parks the peer
                # between both planes and it would election-timeout
                matched = args["prev_index"] + len(args["entries"])
                self.match_index[peer] = max(
                    self.match_index.get(peer, 0), matched)
                self.next_index[peer] = max(
                    self.next_index.get(peer, 1), self.match_index[peer] + 1)
                self.applied_index[peer] = max(
                    self.applied_index.get(peer, 0), meta.get("applied", 0))
                before = self.commit_index
                self._advance_commit()
                if self.commit_index > before:
                    # push the new commit index out NOW so followers
                    # apply within one round-trip, not one heartbeat
                    self._kick_repl()
                self._apply_cv.notify_all()  # wait_all proposers watch applied
            else:
                # conflict hints are bounded BOTH ways: never below the
                # acknowledged match (a pipelined resend racing a slow
                # reply must not re-ship the whole log), never above
                # this send's own prev (an overtaken out-of-order
                # append reports conflict at follower-last+1, which can
                # exceed what we've actually shipped in order)
                hint = meta.get("conflict_index")
                if not hint:
                    hint = self.next_index.get(peer, 2) - 1
                self.next_index[peer] = max(
                    self.match_index.get(peer, 0) + 1,
                    min(hint, max(1, args["prev_index"])),
                )
                # the peer needs entries again: rewind the optimistic
                # send cursor and wake the replication plane (a parked
                # legacy thread would otherwise never resume and the
                # heartbeat plane skips pending peers)
                self._shipped[peer] = 0
                self._kick_repl(peer)

    def _advance_commit(self) -> None:
        # caller holds lock; commit = highest index replicated on majority
        # with an entry of the current term
        n_members = len(self.peers) + 1
        for idx in range(self._last_index(), self.commit_index, -1):
            if self._term_at(idx) != self.term:
                break
            count = 1 + sum(1 for p in self.peers if self.match_index.get(p, 0) >= idx)
            if count > n_members // 2:
                self.commit_index = idx
                break
        self._apply_committed()

    def _apply_committed(self) -> None:
        # caller holds lock
        if self.last_applied >= self.commit_index:
            return
        t0 = time.perf_counter()
        resolved: list[_ProposeWaiter] = []
        while self.last_applied < self.commit_index:
            abs_idx = self.last_applied + 1
            rec = self._entry_at(abs_idx)
            self.last_applied = abs_idx
            w = self._waiters.pop(abs_idx, None)
            result, exc = None, None
            if rec["entry"].get("__raft_noop__"):
                pass
            else:
                try:
                    result = self.apply_fn(rec["entry"])
                except Exception as e:
                    # deterministic app-level failures are part of the FSM;
                    # surface to a local waiter, ignore on replicas
                    exc = e
            if w is not None:
                if rec["term"] != w.term:
                    # slot was overwritten by another leader's entry: the
                    # proposed entry is LOST, not committed
                    exc = NotLeaderError(self.leader, "entry lost to new leader")
                    result = None
                w.result, w.exc, w.done = result, exc, True
                resolved.append(w)
        # the whole drained range is applied before ANY waiter wakes:
        # one event per waiter, no shared-cv thundering herd
        if resolved:
            dt = time.perf_counter() - t0
            _metrics.raft_batch_apply_latency.observe(
                dt, group=self.group_id)
            # apply runs with no request context (it serves submitters
            # it cannot see), so the stage path is explicit
            _trace.observe_stage("raft_apply", "meta.write", dt)
            for w in resolved:
                w.event.set()
        self._apply_cv.notify_all()  # wait_all watchers track applied_index

    # ---------------- RPC handlers ----------------
    def handle_vote(self, args: dict, body: bytes) -> dict:
        if self._stop.is_set():
            return {"granted": False, "term": 0}
        with self._lock:
            if args["term"] < self.term:
                return {"granted": False, "term": self.term}
            if args["term"] > self.term:
                self._step_down(args["term"])
            last_index = self._last_index()
            last_term = self._term_at(last_index) if last_index else 0
            up_to_date = (args["last_term"], args["last_index"]) >= (last_term, last_index)
            if up_to_date and self.voted_for in (None, args["candidate"]):
                self.voted_for = args["candidate"]
                self._persist_meta()
                self._last_heard = time.monotonic()
                return {"granted": True, "term": self.term}
            return {"granted": False, "term": self.term}

    def handle_append(self, args: dict, body: bytes) -> dict:
        # a stopped node must not apply entries: its FSM's resources
        # (stores, files) may already be closed — or a successor raft
        # instance may already be applying over the same FSM
        if self._stop.is_set():
            return {"ok": False, "term": 0}
        with self._lock:
            if self._stop.is_set():  # re-check: we may have queued on the
                return {"ok": False, "term": 0}  # lock across a stop()
            if args["term"] < self.term:
                return {"ok": False, "term": self.term}
            if args["term"] > self.term or self.role != "follower":
                self._step_down(args["term"])
            self.leader = args["leader"]
            self._notify_role()
            self._last_heard = time.monotonic()
            prev_index = args["prev_index"]
            entries = args["entries"]
            if prev_index > self._last_index():
                return {"ok": False, "term": self.term,
                        "conflict_index": self._last_index() + 1}
            if prev_index < self.log_base:
                # we compacted past prev: drop entries we already hold
                skip = self.log_base - prev_index
                entries = entries[skip:]
                prev_index = self.log_base
            if prev_index > self.log_base and self._term_at(prev_index) != args["prev_term"]:
                t = self._term_at(prev_index)
                ci = prev_index
                while ci - 1 > self.log_base and self._term_at(ci - 1) == t:
                    ci -= 1
                return {"ok": False, "term": self.term, "conflict_index": ci}
            # append, overwriting conflicts; track the wal delta precisely
            appended: list[dict] = []
            rewrote = False
            for i, rec in enumerate(entries):
                idx = prev_index + i + 1
                if idx <= self._last_index():
                    if self._term_at(idx) != rec["term"]:
                        del self.log[idx - 1 - self.log_base :]
                        self.log.append(rec)
                        rewrote = True
                    # same term at same index: identical entry, skip
                else:
                    self.log.append(rec)
                    appended.append(rec)
            sync_through = 0
            if appended or rewrote:
                self._persist_entries(appended, rewrote)
                sync_through = self._last_index()
            if args["commit"] > self.commit_index:
                self.commit_index = min(args["commit"], self._last_index())
                self._apply_committed()
            result = {"ok": True, "term": self.term,
                      "applied": self.last_applied}
        if sync_through:
            # the ok-ack is a durability promise to the leader: wait for
            # the (shared) group fsync outside the lock, so concurrent
            # append batches don't serialize disk flushes
            self._wal_sync(sync_through)
        return result

    def status(self) -> dict:
        with self._lock:
            return {"role": self.role, "term": self.term, "leader": self.leader,
                    "log_len": len(self.log), "log_base": self.log_base,
                    "commit": self.commit_index, "applied": self.last_applied}


class HeartbeatMux:
    """The dedicated multi-raft heartbeat plane (tiglabs raft
    transport_heartbeat + transport_multi analog): ONE batched RPC per
    peer node per tick carries empty AppendEntries for every group this
    process currently leads, so hundreds of partitions cost O(peer
    nodes) idle heartbeat RPCs instead of O(groups x peers) — and bulk
    entry replication (the repl threads) can never starve liveness."""

    _BY_POOL: dict[int, "HeartbeatMux"] = {}
    _BY_POOL_LOCK = lockwitness.make_lock("HeartbeatMux._BY_POOL_LOCK")

    @classmethod
    def get(cls, pool) -> "HeartbeatMux":
        with cls._BY_POOL_LOCK:
            mux = cls._BY_POOL.get(id(pool))
            if mux is None:
                mux = cls._BY_POOL[id(pool)] = HeartbeatMux(pool)
            return mux

    def __init__(self, pool):
        self.pool = pool
        self._lock = lockwitness.make_lock("HeartbeatMux._lock")
        self.nodes: dict[tuple[str, str], RaftNode] = {}  # (gid, me) -> node
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # persistent per-address senders (latest-batch slot semantics):
        # a dead peer blocks only its own sender, and steady state spawns
        # zero threads per tick. Keys are peer addrs, or (peer, sender)
        # tuples while a FaultPlan is installed (see _loop).
        self._senders: dict[str | tuple, dict] = {}

    def enroll(self, node: "RaftNode") -> None:
        with self._lock:
            if self._stop.is_set():
                # raced a final drop(): re-resolve through the registry
                HeartbeatMux.get(node.pool).enroll(node)
                return
            self.nodes[(node.group_id, node.me)] = node
            if self._thread is None:
                self._thread = threading.Thread(target=self._loop,
                                                daemon=True)
                self._thread.start()

    def drop(self, node: "RaftNode") -> None:
        with self._lock:
            cur = self.nodes.get((node.group_id, node.me))
            if cur is node:
                del self.nodes[(node.group_id, node.me)]
            if not self.nodes:
                # last node gone: stop the tick thread and release the
                # pool reference, or every retired cluster leaks both
                self._stop.set()
                for slot in self._senders.values():
                    slot["ev"].set()
                with HeartbeatMux._BY_POOL_LOCK:
                    if HeartbeatMux._BY_POOL.get(id(self.pool)) is self:
                        del HeartbeatMux._BY_POOL[id(self.pool)]

    def _loop(self) -> None:
        while not self._stop.wait(RaftNode.HEARTBEAT):
            with self._lock:
                nodes = list(self.nodes.values())
            # batches normally key on peer addr alone; under an installed
            # FaultPlan they key on (peer, sender) so each local node's
            # heartbeats carry ITS identity — an isolated old leader's
            # heartbeats must be cut sender-side or followers sharing
            # this process would never start an election
            chaos = _fi.current() is not None
            batches: dict = {}  # key -> [(gid, node, args)]
            for node in nodes:
                for peer, args in node.heartbeat_args():
                    key = (peer, node.me) if chaos else peer
                    batches.setdefault(key, []).append(
                        (node.group_id, node, args))
            for key, items in batches.items():
                addr, me = key if isinstance(key, tuple) else (key, None)
                with self._lock:
                    slot = self._senders.get(key)
                    if slot is None:
                        slot = self._senders[key] = {
                            "ev": threading.Event(), "batch": None}
                        threading.Thread(target=self._sender_loop,
                                         args=(addr, me, slot),
                                         daemon=True).start()
                slot["batch"] = items  # latest batch wins
                slot["ev"].set()

    def _sender_loop(self, addr: str, me: str | None, slot: dict) -> None:
        while not self._stop.is_set():
            slot["ev"].wait()
            slot["ev"].clear()
            if self._stop.is_set():
                return
            items = slot["batch"]
            if items:
                self._send(addr, me, items)

    def _send(self, addr: str, me: str | None, items: list) -> None:
        try:
            with _fi.sender(me):
                meta, _ = self.pool.get_direct(addr).call(
                    "raft_hb_batch",
                    {"items": [[gid, args] for gid, _, args in items]},
                    timeout=1.0)
        except Exception:
            return
        replies = dict(map(tuple, meta.get("replies", [])))
        for gid, node, args in items:
            reply = replies.get(gid)
            if reply is not None:
                node._process_append_reply(addr, args, reply)


class ReplMux:
    """The shared bulk-replication plane for pipelined mode: ONE
    dispatcher thread per NodePool walks every dirty leader's
    `_dispatch_appends`, and per-ADDRESS sender lanes (bounded worker
    threads over a FIFO job queue) carry the actual AppendEntries /
    InstallSnapshot RPCs. All raft groups targeting the same address
    share its lane — hundreds of partitions cost O(addresses x window)
    sender threads instead of O(groups x peers) blocking loops, and the
    lane's worker pool IS the per-follower in-flight window's
    concurrency. Lane width caps at CUBEFS_RAFT_MUX_SENDERS (default
    8); a dead address blocks only its own lane."""

    _BY_POOL: dict[int, "ReplMux"] = {}
    _BY_POOL_LOCK = lockwitness.make_lock("ReplMux._BY_POOL_LOCK")

    @classmethod
    def get(cls, pool) -> "ReplMux":
        with cls._BY_POOL_LOCK:
            mux = cls._BY_POOL.get(id(pool))
            if mux is None:
                mux = cls._BY_POOL[id(pool)] = ReplMux(pool)
            return mux

    def __init__(self, pool):
        self.pool = pool
        try:
            self.senders_per_addr = max(1, int(
                os.environ.get("CUBEFS_RAFT_MUX_SENDERS", "8") or "8"))
        except ValueError:
            self.senders_per_addr = 8
        self._lock = lockwitness.make_lock("ReplMux._lock")
        self.nodes: dict[tuple[str, str], RaftNode] = {}  # (gid, me) ->
        self._dirty: set[RaftNode] = set()
        self._ev = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # addr -> {"q": SimpleQueue, "workers": int, "busy": int}
        self._lanes: dict[str, dict] = {}

    def enroll(self, node: RaftNode) -> None:
        with self._lock:
            if self._stop.is_set():
                # raced a final drop(): re-resolve through the registry
                ReplMux.get(node.pool).enroll(node)
                return
            self.nodes[(node.group_id, node.me)] = node
            if self._thread is None:
                self._thread = threading.Thread(target=self._loop,
                                                daemon=True)
                self._thread.start()

    def drop(self, node: RaftNode) -> None:
        with self._lock:
            cur = self.nodes.get((node.group_id, node.me))
            if cur is node:
                del self.nodes[(node.group_id, node.me)]
            self._dirty.discard(node)
            if not self.nodes:
                self._stop.set()
                self._ev.set()
                with ReplMux._BY_POOL_LOCK:
                    if ReplMux._BY_POOL.get(id(self.pool)) is self:
                        del ReplMux._BY_POOL[id(self.pool)]

    def kick(self, node: RaftNode) -> None:
        """Mark a node as having replication work; the dispatcher picks
        it up on its next pass (propose, freed window slot, conflict,
        commit advance all land here)."""
        with self._lock:
            if self._stop.is_set():
                return
            self._dirty.add(node)
        self._ev.set()

    def _loop(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                batch = list(self._dirty)
                self._dirty.clear()
            again: list[RaftNode] = []
            for node in batch:
                try:
                    if node._dispatch_appends(self):
                        again.append(node)
                except Exception:
                    pass  # a stopping node mid-teardown; drop it
            with self._lock:
                self._dirty.update(again)
                pending = bool(self._dirty)
            # blocked nodes (window full / error backoff) re-tick at
            # heartbeat pace; otherwise sleep until the next kick
            if pending:
                self._ev.wait(RaftNode.HEARTBEAT)
            else:
                self._ev.wait()
            self._ev.clear()

    def submit(self, node: RaftNode, peer: str, kind: str,
               args: dict) -> None:
        with self._lock:
            lane = self._lanes.get(peer)
            if lane is None:
                lane = self._lanes[peer] = {
                    "q": _queue.SimpleQueue(), "workers": 0, "busy": 0}
            lane["q"].put((node, peer, kind, args))
            # grow the lane while queued jobs outnumber free workers
            while (lane["workers"] < self.senders_per_addr
                   and lane["workers"] - lane["busy"] < lane["q"].qsize()):
                lane["workers"] += 1
                threading.Thread(target=self._worker, args=(peer, lane),
                                 daemon=True).start()
            _metrics.raft_mux_senders.set(lane["workers"], addr=peer)
        _metrics.raft_mux_jobs.inc(kind=kind)

    def _worker(self, addr: str, lane: dict) -> None:
        q = lane["q"]
        while not self._stop.is_set():
            try:
                job = q.get(timeout=5.0)
            except _queue.Empty:
                with self._lock:
                    if q.empty():  # shrink: verified idle under the lock
                        lane["workers"] -= 1
                        _metrics.raft_mux_senders.set(
                            lane["workers"], addr=addr)
                        return
                continue
            with self._lock:
                lane["busy"] += 1
            try:
                self._run_job(*job)
            finally:
                with self._lock:
                    lane["busy"] -= 1
        with self._lock:
            lane["workers"] -= 1

    def _run_job(self, node: RaftNode, peer: str, kind: str,
                 args: dict) -> None:
        try:
            try:
                with _fi.sender(node.me):
                    if kind == "snap":
                        meta, _ = self.pool.get_direct(peer).call(
                            f"raft_{node.group_id}_snapshot", args,
                            timeout=5.0)
                    else:
                        meta, _ = self.pool.get_direct(peer).call(
                            f"raft_{node.group_id}_append", args,
                            timeout=1.0)
            except Exception:
                node._on_repl_error(peer)
                return
            if kind == "snap":
                node._on_snapshot_reply(peer, args, meta)
            else:
                node._process_append_reply(peer, args, meta)
        finally:
            node._repl_job_done(peer)


class TickMux:
    """Shared election-timer/compaction plane (CUBEFS_RAFT_MUX door):
    ONE 10ms ticker per NodePool checks every enrolled node's election
    deadline and compaction threshold, so hundreds of raft groups cost
    one timer thread instead of one ticker each. Elections and
    snapshots run on short-lived worker threads (rare events), guarded
    by a per-node busy flag so a slow election can't be double-fired."""

    _BY_POOL: dict[int, "TickMux"] = {}
    _BY_POOL_LOCK = lockwitness.make_lock("TickMux._BY_POOL_LOCK")

    @classmethod
    def get(cls, pool) -> "TickMux":
        with cls._BY_POOL_LOCK:
            mux = cls._BY_POOL.get(id(pool))
            if mux is None:
                mux = cls._BY_POOL[id(pool)] = TickMux(pool)
            return mux

    def __init__(self, pool):
        self.pool = pool
        self._lock = lockwitness.make_lock("TickMux._lock")
        self.nodes: dict[tuple[str, str], RaftNode] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def enroll(self, node: RaftNode) -> None:
        with self._lock:
            if self._stop.is_set():
                TickMux.get(node.pool).enroll(node)
                return
            self.nodes[(node.group_id, node.me)] = node
            if self._thread is None:
                self._thread = threading.Thread(target=self._loop,
                                                daemon=True)
                self._thread.start()

    def drop(self, node: RaftNode) -> None:
        with self._lock:
            cur = self.nodes.get((node.group_id, node.me))
            if cur is node:
                del self.nodes[(node.group_id, node.me)]
            if not self.nodes:
                self._stop.set()
                with TickMux._BY_POOL_LOCK:
                    if TickMux._BY_POOL.get(id(self.pool)) is self:
                        del TickMux._BY_POOL[id(self.pool)]

    def _loop(self) -> None:
        while not self._stop.wait(0.01):
            with self._lock:
                nodes = list(self.nodes.values())
            now = time.monotonic()
            for node in nodes:
                if node._stop.is_set() or node._tick_busy:
                    continue
                act = None
                with node._lock:
                    if (node.snapshot_fn is not None
                            and len(node.log) > node.COMPACT_THRESHOLD
                            and node.last_applied > node.log_base):
                        act = "compact"
                    elif (node.role != "leader"
                          and now - node._last_heard > node._election_due):
                        act = "election"
                    if act:
                        node._tick_busy = True
                if act:
                    threading.Thread(target=self._run, args=(node, act),
                                     daemon=True).start()

    def _run(self, node: RaftNode, act: str) -> None:
        try:
            if act == "compact":
                node.take_snapshot()
            else:
                node._run_election()
        finally:
            node._tick_busy = False


def register_routes(routes: dict, node: RaftNode) -> None:
    """Mount a raft node's handlers on a service's route table
    (multi-raft: many nodes share one server). Also maintains the
    table's shared batched-heartbeat endpoint."""
    routes[f"raft_{node.group_id}_vote"] = node.handle_vote
    routes[f"raft_{node.group_id}_append"] = node.handle_append
    routes[f"raft_{node.group_id}_snapshot"] = node.handle_install_snapshot
    reg = routes.setdefault("__raft_groups__", {})
    reg[node.group_id] = node

    def hb_batch(args, body, _reg=reg):
        replies = []
        for gid, a in args["items"]:
            member = _reg.get(gid)
            if member is None:
                replies.append([gid, {"ok": False, "term": 0}])
            else:
                replies.append([gid, member.handle_append(a, b"")])
        return {"replies": replies}

    routes["raft_hb_batch"] = hb_batch
