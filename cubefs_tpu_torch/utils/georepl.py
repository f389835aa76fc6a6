"""Cross-cluster geo-replication core: WAL shipping, fenced failover.

Role parity: the reference federates whole storage planes across
regions; here the PR 14 CRC32-framed WAL (utils/fsm.py) IS the
replication log. Every primary-side commit door (ReplicatedFsm._commit
/ _commit_many, MetaPartition.submit / submit_many) invokes a
``GeoShipper`` tap post-apply; the shipper stamps a monotonic
per-partition sequence plus the cluster's fencing epoch into a
``_frame``-framed envelope — the on-disk WAL framing is also the ship
format, so every shipped record carries its own CRC and the follower's
``GeoApplier`` detects torn/corrupt lines exactly like WAL replay does.

Follower-side contract (the lint family CFG pins it):

* ``GeoApplier.deliver`` is the ONE door shipped records enter through:
  sequence gaps trigger a bounded backfill from the shipper's ring (or
  a full snapshot bootstrap over the packet mux on a ring miss),
  duplicates (seq <= applied) are skipped idempotently, and records
  carrying a stale fencing epoch are REJECTED — a healed old primary
  replaying its unshipped tail into a promoted follower must never
  double-apply (``cubefs_geo_fencing_rejections_total``).
* Mutations arriving over RPC bounce off the follower fence
  (``_geo_gate`` in the commit doors) with GeoRedirect (452,
  "primary=<addr>"); reads serve locally.

``GeoController`` is the per-cluster promote/failback state machine
(FOLLOWING -> FENCED -> PROMOTED -> FAILBACK_SYNC -> FOLLOWING) with
op_id-fenced idempotent transitions: a transport retry of a `promote`
replays the recorded outcome instead of bumping the epoch twice.

Replication lag doubles as an SLO: the applier observes each record's
ship-stamp age as a ``geo.replication`` total-stage sample, so a
lagging follower burns the registered error budget and trips the same
brownout machinery (utils/slo.py + utils/qos.py) as a burning latency
SLO.

Everything is behind ``CUBEFS_GEO`` (default off): with the door shut
no tap is installed, no gate fires, and FSM digests are byte-identical
to pre-geo behavior.

The port's copy of ``cubefs_tpu/utils/georepl.py``: a shipped record
is the same ``_frame`` line, byte for byte, in both packages.
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
import threading

from . import metrics, rpc
from .fsm import _frame, _parse_frame
from .retry import Clock, MONOTONIC

# promote/failback state machine positions (metrics export order)
STATES = ("PRIMARY", "FOLLOWING", "FENCED", "PROMOTED", "FAILBACK_SYNC")


def enabled() -> bool:
    """CUBEFS_GEO door: 0/unset (default) = no geo-replication — no
    taps, no gates, FSM-digest-identical to pre-geo behavior."""
    return os.environ.get("CUBEFS_GEO", "0") not in ("", "0")


def fsm_digest(host) -> str:
    """sha256 over a host FSM's canonical serialized state — the
    cross-cluster convergence check (byte-identical digests after heal
    + failback). Works for ReplicatedFsm hosts (`_state_bytes`) and
    MetaPartitions (`state_bytes`)."""
    fn = getattr(host, "state_bytes", None)
    if fn is None:
        fn = host._state_bytes
    return hashlib.sha256(fn()).hexdigest()


class GeoShipper:
    """Primary-side, per-partition: commit-door tap -> framed envelope
    with (seq, epoch, ship-ts) -> bounded ring + unacked pending queue.

    The ring bounds backfill: a follower that missed up to `ring`
    records recovers from here; anything older falls back to a full
    snapshot bootstrap. The pending queue is the RPO ledger — bytes
    committed locally but not yet acknowledged by the follower are the
    data at risk if the region dies right now."""

    RING = 512

    def __init__(self, part: str, epoch_fn, clock: Clock = MONOTONIC,
                 tenant: str = "fs", ring: int = RING):
        self.part = part
        self.tenant = tenant
        self.clock = clock
        self._epoch_fn = epoch_fn
        self.active = True  # False while this cluster is the follower
        self.seq = 0
        self._ring: collections.deque = collections.deque(maxlen=ring)
        self._pending: collections.deque = collections.deque()
        self._pending_bytes = 0
        # reentrant: a tap can fire while a pump thread holds the lock
        # via backfill() -> never, but transitions (adopt) run under
        # gateway locks that also pump — keep it simple and safe
        self._lock = threading.RLock()

    def tap(self, record: dict) -> None:
        """Invoked by the commit door, post-apply, under its commit
        lock: the per-partition sequence mirrors commit order."""
        if not self.active:
            return
        with self._lock:
            self.seq += 1
            env = {"seq": self.seq, "epoch": self._epoch_fn(),
                   "ts": round(self.clock.now(), 6), "rec": record}
            line = _frame(json.dumps(env))
            self._ring.append((self.seq, line))
            self._pending.append((self.seq, line))
            self._pending_bytes += len(line)
            metrics.geo_rpo_bytes.set(
                self._pending_bytes, part=self.part, tenant=self.tenant)

    def pending(self, max_records: int = 256) -> list[str]:
        """Head of the unacked stream (ship batch); leaves it queued
        until the follower's applied_seq comes back through ack()."""
        with self._lock:
            out = []
            for i, (_, line) in enumerate(self._pending):
                if i >= max_records:
                    break
                out.append(line)
            return out

    def pending_bytes(self) -> int:
        with self._lock:
            return self._pending_bytes

    def ack(self, applied_seq: int) -> int:
        """Follower confirmed everything through applied_seq: retire it
        from the RPO ledger. Returns the number of records retired."""
        with self._lock:
            n = 0
            while self._pending and self._pending[0][0] <= applied_seq:
                _, line = self._pending.popleft()
                self._pending_bytes -= len(line)
                n += 1
            metrics.geo_rpo_bytes.set(
                self._pending_bytes, part=self.part, tenant=self.tenant)
            if n:
                metrics.geo_shipped.inc(n, part=self.part)
            return n

    def backfill(self, from_seq: int) -> list[str] | None:
        """Contiguous records from_seq..seq out of the bounded ring, or
        None on a ring miss (caller falls back to snapshot bootstrap).
        The bound is the point: backfill memory is O(ring), never
        O(divergence)."""
        with self._lock:
            if from_seq > self.seq:
                return []
            lines = [line for s, line in self._ring if s >= from_seq]
            if len(lines) != self.seq - from_seq + 1:
                return None  # ring wrapped past from_seq
            return lines

    def adopt(self, seq: int) -> None:
        """Role change (promote/failback): continue the partition's ONE
        logical sequence from where the applier left it. The ring
        restarts empty — the peer recovers older history via
        bootstrap."""
        with self._lock:
            self.seq = seq
            self._ring.clear()
            self._pending.clear()
            self._pending_bytes = 0
            metrics.geo_rpo_bytes.set(
                0, part=self.part, tenant=self.tenant)


class GeoApplier:
    """Follower-side, per-partition: the ONE door shipped records enter
    the local FSM through (lint CFG001). Parses the `_frame` envelope
    (CRC-checked like WAL replay), enforces the fencing epoch, skips
    duplicates, detects gaps, and applies in sequence via the injected
    `apply_fn` (the host's `geo_apply` door, which bypasses the
    follower fence without echoing the shipper tap).

    Optional `state_path` persists (applied_seq, epoch) AFTER each
    applied batch: on a crash between the host's WAL append and the
    sidecar write the stream re-sends the tail and the host's op_id
    dedup absorbs the replay — at-least-once delivery, exactly-once
    apply."""

    def __init__(self, part: str, apply_fn, clock: Clock = MONOTONIC,
                 tenant: str = "fs", state_path: str | None = None,
                 slo=None):
        self.part = part
        self.tenant = tenant
        self.clock = clock
        self._apply_fn = apply_fn
        self._slo = slo  # SloTracker to register geo.replication with
        self.applied_seq = 0
        self.epoch = 0
        self.fenced = False  # promote quiesce: reject the stream
        self._lock = threading.Lock()
        self._state_path = state_path
        if state_path and os.path.exists(state_path):
            st = json.load(open(state_path))
            self.applied_seq = int(st["seq"])
            self.epoch = int(st["epoch"])

    def _save(self) -> None:
        if not self._state_path:
            return
        tmp = self._state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"seq": self.applied_seq, "epoch": self.epoch}, f)
        os.replace(tmp, self._state_path)

    def _observe_lag(self, lag: float) -> None:
        metrics.geo_lag.set(lag, part=self.part, tenant=self.tenant)
        # the lag sample rides the shared stage histogram so the SLO
        # tracker's burn-rate machinery sees it with zero extra wiring
        metrics.request_stage_seconds.observe(
            lag, path="geo.replication", stage="total")

    def deliver(self, lines: list) -> dict:
        """Apply one shipped batch in order. Returns
        ``{"applied_seq", "epoch", "need", "fenced"}`` — `need` is the
        first missing sequence when a gap stopped the batch (the
        shipper backfills from there), else None."""
        need = None
        with self._lock:
            if self.fenced:
                return {"applied_seq": self.applied_seq,
                        "epoch": self.epoch, "need": None, "fenced": True}
            last_ts = None
            applied = 0
            for raw in lines:
                if isinstance(raw, str):
                    raw = raw.encode()
                try:
                    env = _parse_frame(raw.rstrip(b"\n"))
                except (ValueError, json.JSONDecodeError):
                    # a torn/corrupt line poisons itself only: the
                    # resulting sequence gap (if the record mattered)
                    # heals through the backfill machinery
                    metrics.geo_applied.inc(
                        part=self.part, outcome="corrupt")
                    continue
                seq, epoch = int(env["seq"]), int(env["epoch"])
                if epoch < self.epoch:
                    # stale-epoch record from a healed old primary:
                    # fenced out, never double-applied
                    metrics.geo_fencing_rejections.inc(part=self.part)
                    continue
                if epoch > self.epoch:
                    self.epoch = epoch  # new primary generation
                if seq <= self.applied_seq:
                    metrics.geo_applied.inc(
                        part=self.part, outcome="duplicate")
                    continue
                if seq > self.applied_seq + 1:
                    need = self.applied_seq + 1
                    metrics.geo_applied.inc(part=self.part, outcome="gap")
                    break
                self._apply_fn(env["rec"])
                self.applied_seq = seq
                applied += 1
                last_ts = env.get("ts")
                metrics.geo_applied.inc(part=self.part, outcome="applied")
            if last_ts is not None:
                self._observe_lag(max(0.0, self.clock.now() - last_ts))
            if applied:
                self._save()
        return {"applied_seq": self.applied_seq, "epoch": self.epoch,
                "need": need, "fenced": False}

    def adopt(self, seq: int, epoch: int) -> None:
        """Role change: reposition the applier without touching state
        (promote continues from its own applied position; a graceful
        resume_following folds in the drained ship position)."""
        with self._lock:
            self.applied_seq = int(seq)
            self.epoch = max(self.epoch, int(epoch))
            self._save()

    def bootstrap(self, data: bytes, seq: int, epoch: int,
                  restore_fn) -> None:
        """Full state transfer landed (fsm_recover_from_state
        generalized across clusters): adopt the primary's state,
        sequence position and epoch in one step."""
        with self._lock:
            restore_fn(data)
            self.applied_seq = int(seq)
            self.epoch = max(self.epoch, int(epoch))
            metrics.geo_backfills.inc(part=self.part, kind="bootstrap")
            self._save()


# transition table: (state, op) -> next state. `promote` is the only
# epoch-bumping edge; `demote` is the old primary folding into the new
# primary's stream at failback.
_TRANSITIONS = {
    ("FOLLOWING", "fence"): "FENCED",
    ("FENCED", "promote"): "PROMOTED",
    ("FENCED", "resume_following"): "FOLLOWING",  # aborted promote
    ("PROMOTED", "failback_sync"): "FAILBACK_SYNC",
    ("FAILBACK_SYNC", "resume_following"): "FOLLOWING",
    ("FAILBACK_SYNC", "fence"): "FENCED",  # drain quiesce before swap
    ("PRIMARY", "demote"): "FOLLOWING",
    ("PRIMARY", "fence"): "FENCED",  # planned failback cutover quiesce
    ("FENCED", "demote"): "FOLLOWING",
    ("FOLLOWING", "promote"): None,  # must fence first: quiesce gap
}


class GeoController:
    """Per-cluster promote/failback state machine with a monotonic
    fencing epoch. Transitions carry an op_id and are idempotent: the
    recorded outcome replays on retry (a duplicated `promote` must not
    mint two epochs — that is the fence the blackout drill proves)."""

    OP_CACHE_SIZE = 1024

    def __init__(self, cluster: str, state: str = "PRIMARY",
                 epoch: int = 0):
        if state not in STATES:
            raise ValueError(f"unknown geo state {state!r}")
        self.cluster = cluster
        self.state = state
        self.epoch = epoch
        self._lock = threading.RLock()
        self._op_cache: dict[str, tuple[str, int]] = {}
        self._export()

    def _export(self) -> None:
        metrics.geo_state.set(STATES.index(self.state),
                              cluster=self.cluster)
        metrics.geo_epoch.set(self.epoch, cluster=self.cluster)

    def observe_epoch(self, epoch: int) -> None:
        """Learn a higher epoch from the stream (a follower tracking
        its primary's generation) so a later promote always fences
        ABOVE everything this cluster has ever seen."""
        with self._lock:
            if epoch > self.epoch:
                self.epoch = epoch
                self._export()

    def transition(self, op: str, op_id: str | None = None) -> dict:
        with self._lock:
            if op_id is not None and op_id in self._op_cache:
                state, epoch = self._op_cache[op_id]
                return {"state": state, "epoch": epoch, "replayed": True}
            nxt = _TRANSITIONS.get((self.state, op))
            if nxt is None:
                raise rpc.RpcError(
                    409, f"geo transition {op!r} invalid from "
                         f"{self.state}")
            self.state = nxt
            if op == "promote":
                self.epoch += 1
            if op_id is not None:
                self._op_cache[op_id] = (self.state, self.epoch)
                if len(self._op_cache) > self.OP_CACHE_SIZE:
                    for k in list(self._op_cache)[
                            : self.OP_CACHE_SIZE // 2]:
                        del self._op_cache[k]
            self._export()
            return {"state": self.state, "epoch": self.epoch,
                    "replayed": False}
