"""MetaNode: partitioned in-RAM filesystem metadata.

Role parity: metanode/ — a MetaPartition owns an inode-id range and
keeps inode/dentry trees in memory (partition.go:484-524, btree.go),
mutations flow through a single submit→apply door (partition_op_inode.go
:205 submit, partition_fsm.go:38 Apply) and persist as an op-log +
CRC'd snapshot with an apply-id watermark (partition_store.go). The
apply stream is the replication interface: peers (and later raft) replay
the same records.

The port's copy of ``cubefs_tpu/fs/metanode.py``: the same snapshot,
oplog and raft directories on disk and the same wire. The native read
plane (``csrc/host/metaserve.cc``) is on unless ``CUBEFS_NATIVE_META=0``,
and a failed build of it raises (the reference serves without it).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import threading
import time
import uuid
import zlib

from ..utils import lockwitness, metrics, rpc
from ..utils import trace as tracelib

ROOT_INO = 1

# inode types
DIR = "dir"
FILE = "file"
SYMLINK = "symlink"


class MetaError(Exception):
    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = code


EPERM = 1
ENOENT = 2
EEXIST = 17
EBUSY = 16
EISDIR = 21
ENOTDIR = 20
ENOSPC = 28
ENOTEMPTY = 39
EDQUOT = 122
# live range migration (fs/split.py): the inode the op routes by sits
# in a sub-range that is frozen for, or already handed off by, a
# metapartition split/merge. >= 99 so it rides the 499 "errno=NN"
# encoding; the message carries "pid=<target>" and the sdk re-routes
# exactly like the 453 transport code (rpc.RANGE_MOVED).
EMOVED = 121


def _rpc_err(e: "MetaError") -> "rpc.RpcError":
    return rpc.errno_error(e.code, str(e))


def _record_inos(r: dict) -> list[int]:
    """The inode ids whose state THIS record mutates on this partition —
    the keys the range-migration fences check. Dentry-plane ops
    (mk_dentry/rm_dentry/mknod/unlink2/rename) live under their parent
    keys: the child "ino" they may also carry can legitimately belong
    to ANOTHER partition (classic alloc-elsewhere create), so gating on
    it would bounce valid cross-partition ops. Pure inode ops carry no
    parent and gate on "ino". tx records carry theirs per sub-op."""
    out = [v for k in ("parent", "src_parent", "dst_parent")
           if isinstance((v := r.get(k)), int)]
    if r.get("op") in ("tx_prepare", "tx_commit", "tx_abort"):
        for o in r.get("ops") or []:
            v = o.get("parent")
            if isinstance(v, int):
                out.append(v)
    if not out and isinstance((v := r.get("ino")), int):
        out.append(v)
    return out


class MetaPartition:
    """One inode-range shard: [start, end)."""

    TX_TTL = 30.0  # seconds a prepared tx may stay undecided
    TX_COMMIT_TTL = 3600.0  # how long commit decisions stay queryable

    def __init__(self, pid: int, start: int, end: int, data_dir: str | None = None):
        self.pid = pid
        self.start = start
        self.end = end
        self._lock = lockwitness.make_rlock("MetaPartition._lock")
        self.inodes: dict[int, dict] = {}
        self.dentries: dict[int, dict[str, int]] = {}  # parent -> name -> ino
        # two-phase transactions (metanode/transaction.go analog):
        # prepared sub-ops hold dentry locks until commit/abort; commit
        # decisions stay queryable so participants can roll forward
        self.tx_pending: dict[str, dict] = {}  # tx_id -> {ops, ts, coord}
        self.tx_committed: dict[str, dict] = {}  # tx_id -> {victims, ts}
        # deferred-deletion free list (partition_free_list.go analog):
        # unlink/truncate move freed extent keys HERE (replicated FSM
        # state) instead of trusting the client to delete them; the
        # metanode's background scan deletes them from datanodes and
        # retires entries via the free_done op. A client crash right
        # after unlink can no longer leak datanode space.
        self.freelist: dict[str, dict] = {}  # key -> {extents, ts}
        # deferred blob deletion (the cold-tier mirror of the extent
        # freelist): any apply that makes a blob location unreachable —
        # fenced migration, overwrite, unlink of a cold file — queues it
        # HERE instead of trusting a client to delete it. The tiering
        # engine's orphan reaper deletes from the blob plane and retires
        # entries via blob_free_done, so no crash point strands a blob.
        self.blob_freelist: dict[str, dict] = {}  # key -> {location, ts}
        self.apply_id = 0
        self._next_ino = start
        self._dirty: set[str] = set(self._SEGMENTS)
        self._seg_crcs: dict[str, int] = {}
        self._oplog_records = 0
        self._op_cache: dict[str, tuple] = {}  # op_id -> (result, err)
        self._alloc_cache: dict[str, int] = {}  # alloc op_id -> ino
        # advisory enforcement flags pushed by the master's quota sweep
        # (meta_quota_manager.go analog) — NOT part of the FSM: they gate
        # the leader's submit door, never the deterministic apply
        self.enforce = {"vol_full": False, "exceeded": set()}
        # geo-replication hooks (fs/georepl.py). The tap fires post-
        # apply under self._lock on the serving side so the shipped
        # sequence mirrors commit order; follower mode bounces every
        # mutation with GeoRedirect while reads keep serving locally.
        # All None/off by default: with CUBEFS_GEO shut nothing here
        # ever fires and the FSM digest is byte-identical to pre-geo.
        self.geo_tap = None
        self.geo_mode: str | None = None
        self.geo_primary: str | None = None
        # live range migration (fs/split.py). `frozen`/`moved` are FSM
        # state (replicated + checkpointed in the "range" segment):
        # frozen sub-ranges bounce mutations with EMOVED while the
        # handoff copies them; moved sub-ranges redirect forever (the
        # inodes live on the target partition now). `_range_taps` is
        # leader-local scratch — the delta tap registered by
        # range_export, drained at freeze — never serialized.
        self.frozen: dict[str, dict] = {}  # split_id -> {lo, hi, target_pid}
        self.moved: dict[str, int] = {}  # "lo-hi" -> target_pid
        self._range_taps: dict[str, dict] = {}
        self.data_dir = data_dir
        # native read-plane mirror (runtime/src/metaserve.cc): when
        # attached, every apply re-states its tree mutation into the C++
        # store under this same lock, so the native server always serves
        # what a leader-routed Python read would
        self._mir = None  # (ctypes lib, MetaServe handle)
        self._last_tx_ops = None  # mirror hint from _apply_tx_commit
        self._oplog = None
        if data_dir:
            os.makedirs(data_dir, exist_ok=True)
            self._load()
            self._oplog = open(os.path.join(data_dir, "oplog.jsonl"), "a")
        if self.start <= ROOT_INO < self.end and ROOT_INO not in self.inodes:
            # fixed ts: the bootstrap root is applied LOCALLY on every
            # replica (it precedes the raft log), so a wall-clock stamp
            # would make freshly-born replicas bitwise-divergent
            self.apply({"op": "mk_inode", "ino": ROOT_INO, "type": DIR,
                        "mode": 0o755, "ts": 0.0})

    # ---------------- apply door (replication interface) ----------------
    def _geo_gate(self) -> None:
        """Follower fence: a geo-follower partition serves reads but
        bounces every mutation to the primary region with GeoRedirect
        (452, "primary=<addr>") — the ONE mutation choke point on this
        class (lint CFG002 pins its presence in the commit doors).
        Shipped records from the primary enter through `geo_apply`,
        never here."""
        if self.geo_mode == "follower":
            metrics.geo_redirects.inc(
                part=getattr(self, "geo_part", str(self.pid)))
            raise rpc.RpcError(rpc.GEO_REDIRECT,
                               f"primary={self.geo_primary or ''}")

    def geo_apply(self, record: dict) -> dict:
        """The GeoApplier's sanctioned commit door on a follower
        partition (lint CFG001): same apply+oplog discipline as submit,
        minus the follower fence (shipped records ARE the primary's
        committed mutations — they must land) and minus the shipper tap
        (a follower never echoes the stream back). Records arrive with
        the primary's ts stamped; op_id dedup absorbs stream replays."""
        with self._lock:
            result = self.apply(dict(record))
            if self._oplog is not None:
                self._oplog.write(json.dumps(
                    {"aid": self.apply_id, **record}) + "\n")
                self._oplog.flush()
                self._oplog_records += 1
                if self._oplog_records >= self.SNAPSHOT_EVERY:
                    self.snapshot()
            return result

    def submit(self, record: dict) -> dict:
        """Validate + apply + log one mutation; returns the result.
        Auto-checkpoints every SNAPSHOT_EVERY records so oplog replay
        stays bounded without O(partition) work per external call.

        The wall clock is read HERE (proposer side) and travels in the
        record: apply handlers must never read it themselves, or
        replicas/WAL replays stamp divergent mtimes (fsm-purity CFM001).
        Records arriving via oplog replay or raft already carry ts."""
        self._geo_gate()
        record.setdefault("ts", time.time())
        with self._lock:
            result = self.apply(record)
            if self._oplog is not None:
                # the record carries the apply-id it landed at: replay
                # after a crash between watermark commit and oplog
                # truncation skips records the checkpoint already holds
                # (double-applying appends would garble extent layouts)
                self._oplog.write(json.dumps(
                    {"aid": self.apply_id, **record}) + "\n")
                self._oplog.flush()
                self._oplog_records += 1
                if self._oplog_records >= self.SNAPSHOT_EVERY:
                    self.snapshot()
            if self.geo_tap is not None:
                # under the partition lock, post-apply: the shipper's
                # per-partition sequence mirrors commit order
                self.geo_tap(record)
            return result

    def submit_many(self, records: list[dict]) -> list:
        """Standalone batch door: apply an ordered batch in sequence
        under ONE lock acquisition and land the oplog append as one
        write+flush. Each constituent still logs as its own record with
        its own apply-id — a batch is a commit-door optimization, not a
        WAL format, so crash replay is identical to N separate submits.
        Returns per-op outcomes [[result, None] | [None, [code, msg]]]."""
        self._geo_gate()
        now = time.time()
        for rec in records:
            rec.setdefault("ts", now)  # one proposer-side clock read
        with self._lock:
            outs = []
            lines = []
            for rec in records:
                try:
                    outs.append([self.apply(rec), None])
                    # failed constituents are NOT logged — same as the
                    # single-op door, whose replay assumes every oplog
                    # record re-applies cleanly
                    lines.append(json.dumps({"aid": self.apply_id, **rec}))
                    if self.geo_tap is not None:
                        # per ok constituent, in apply order: the geo
                        # stream has no batch framing, only sequence
                        self.geo_tap(rec)
                except MetaError as e:
                    outs.append([None, [e.code, str(e)]])
            if self._oplog is not None and lines:
                self._oplog.write("".join(ln + "\n" for ln in lines))
                self._oplog.flush()
                self._oplog_records += len(lines)
                if self._oplog_records >= self.SNAPSHOT_EVERY:
                    self.snapshot()
            return outs

    OP_CACHE_SIZE = 4096

    def apply(self, record: dict) -> dict:
        """Apply one mutation. Records carrying an op_id are idempotent:
        a client retry of an already-applied op (lost response, replica
        failover) returns the cached outcome instead of re-applying —
        the cache is part of the FSM, so replicas stay identical.

        A `__batch__` record is an ordered batch of mutations coalesced
        into ONE raft entry by the submit-plane group commit: every
        constituent applies in sequence through this same door (per-op
        op_id dedup intact — a batch boundary is invisible to replay and
        retries), and the batch's FSM result is the per-op outcome list
        [[result, None] | [None, [code, msg]], ...] so replicas agree
        even when some constituents fail deterministically."""
        with self._lock:
            if record.get("op") == "__batch__":
                outs = []
                for sub in record["records"]:
                    try:
                        outs.append([self.apply(sub), None])
                    except MetaError as e:
                        outs.append([None, [e.code, str(e)]])
                return outs
            op_id = record.get("op_id")
            if op_id is not None and op_id in self._op_cache:
                result, err = self._op_cache[op_id]
                if err is not None:
                    raise MetaError(err[0], err[1])
                return result
            self.apply_id += 1
            op = record["op"]
            try:
                if (self.frozen or self.moved) and \
                        op not in self._RANGE_EXEMPT_OPS:
                    # apply-side fence: records already in the raft
                    # queue when the freeze landed must not mutate the
                    # migrating sub-range (the proposer-side gate can't
                    # see an in-flight freeze) — deterministic, so
                    # replicas agree the op bounced
                    self._range_check(record)
                result = getattr(self, f"_apply_{op}")(record)
                self._dirty |= self._DIRTY_MAP.get(op, set(self._SEGMENTS))
                if self._range_taps:
                    # post-apply, under the partition lock: the delta
                    # tap sees mutations in commit order, exactly like
                    # the geo tap below the submit doors
                    self._tap_record(record, result)
                if self._mir is not None:
                    self._mirror_op(record, result)
                outcome = (result, None)
            except MetaError as e:
                outcome = (None, (e.code, str(e)))
                self._remember(op_id, outcome)
                raise
            self._remember(op_id, outcome)
            return result

    def _remember(self, op_id, outcome) -> None:
        if op_id is None:
            return
        self._op_cache[op_id] = outcome
        if len(self._op_cache) > self.OP_CACHE_SIZE:
            # drop oldest half (insertion-ordered dict)
            for k in list(self._op_cache)[: self.OP_CACHE_SIZE // 2]:
                del self._op_cache[k]

    # ---------------- live range migration (fs/split.py) ----------------
    # The donor side of a metapartition split/merge: range_export
    # captures a scoped snapshot + registers a leader-local delta tap,
    # range_freeze fences the migrating sub-range (mutations outside it
    # never stall), range_drop hands the sub-range off for good. The
    # target side loads via range_load and claims the range via
    # range_activate. All five are ordinary FSM applies — replicated,
    # op_id-idempotent, replayed from the oplog/WAL like any mutation.

    # ops the apply-side range fence skips: the migration's own applies,
    # plus background reclamation/tx-bookkeeping that carries no
    # client-visible tree mutation for the migrating inodes
    _RANGE_EXEMPT_OPS = frozenset({
        "range_freeze", "range_thaw", "range_load", "range_activate",
        "range_drop", "free_done", "blob_free_done",
        "blob_reconcile_enqueue", "tx_finish", "tx_commit", "tx_abort",
    })
    RANGE_TAP_MAX = 50000  # delta records before the tap poisons itself

    @staticmethod
    def _key_ino(key: str) -> int:
        """Owner ino of a freelist/blob_freelist key ("<ino>" or
        "<ino>:t<aid>"/"<ino>:b<aid>")."""
        try:
            return int(key.split(":", 1)[0])
        except ValueError:
            return -1

    def range_moved_target(self, ino: int) -> int | None:
        for key, tpid in self.moved.items():
            lo, hi = key.split("-")
            if int(lo) <= ino < int(hi):
                return tpid
        return None

    def range_target(self, ino: int) -> int | None:
        """Target pid when `ino` sits in a moved OR frozen sub-range;
        None when this partition still serves it."""
        t = self.range_moved_target(ino)
        if t is not None:
            return t
        for f in self.frozen.values():
            if f["lo"] <= ino < f["hi"]:
                return f["target_pid"]
        return None

    def _range_check(self, r: dict) -> None:
        for ino in _record_inos(r):
            t = self.range_target(ino)
            if t is not None:
                raise MetaError(
                    EMOVED,
                    f"inode {ino} range moved from mp {self.pid} (pid={t})")

    def _tap_record(self, r: dict, result) -> None:
        """Feed one successfully-applied record to every registered
        delta tap. Records are normalized so they replay verbatim on the
        target: mknod (allocates inside apply) becomes explicit
        mk_inode/mk_dentry, unlink2 splits into its dentry/inode halves.
        A record that straddles the migrating boundary (rename with one
        parent inside, a tx touching the range) POISONS the tap — the
        engine aborts that split attempt cleanly rather than replay a
        record whose other half isn't on the target."""
        op = r.get("op")
        if op in ("range_freeze", "range_thaw", "range_load",
                  "range_activate", "range_drop", "free_done",
                  "blob_free_done", "blob_reconcile_enqueue", "tx_finish"):
            return
        for tap in self._range_taps.values():
            lo, hi = tap["lo"], tap["hi"]
            if tap.get("poisoned"):
                continue

            def inr(v):
                return isinstance(v, int) and lo <= v < hi

            base = r.get("op_id") or f"rtap-{tap['split_id']}-{self.apply_id}"
            if op in ("tx_prepare", "tx_commit", "tx_abort"):
                if any(inr(o.get("parent")) for o in r.get("ops") or []):
                    tap["poisoned"] = f"tx {op} touched the migrating range"
                continue
            if op == "rename_local":
                sp, dp = r.get("src_parent"), r.get("dst_parent")
                if inr(sp) and inr(dp):
                    tap["records"].append(dict(r))
                elif inr(sp) or inr(dp):
                    tap["poisoned"] = "rename straddles the migrating range"
                continue
            if op == "mknod":
                ino = result["ino"]
                if inr(ino):
                    tap["records"].append({
                        "op": "mk_inode", "ino": ino, "type": r["type"],
                        "mode": r.get("mode", 0o644),
                        "uid": r.get("uid", 0), "gid": r.get("gid", 0),
                        "target": r.get("target"),
                        "quota_ids": list(r.get("quota_ids") or []),
                        "ts": r.get("ts", 0.0), "op_id": base + "#i"})
                if inr(r["parent"]):
                    tap["records"].append({
                        "op": "mk_dentry", "parent": r["parent"],
                        "name": r["name"], "ino": ino,
                        "ts": r.get("ts", 0.0), "op_id": base + "#d"})
                continue
            if op == "unlink2":
                if inr(r.get("parent")):
                    tap["records"].append({
                        "op": "rm_dentry", "parent": r["parent"],
                        "name": r["name"], "ts": r.get("ts", 0.0),
                        "op_id": base + "#d"})
                if inr(result.get("ino")):
                    half = ({"op": "rm_inode", "ino": result["ino"]}
                            if result.get("removed", True)
                            else {"op": "dec_nlink", "ino": result["ino"]})
                    tap["records"].append({**half, "ts": r.get("ts", 0.0),
                                           "op_id": base + "#r"})
                continue
            # same owner-key rule as _record_inos: a dentry op's child
            # "ino" may be foreign — only ops whose state lives in the
            # range belong in the delta
            if any(inr(i) for i in _record_inos(r)):
                tap["records"].append(dict(r))
        for tap in self._range_taps.values():
            if (not tap.get("poisoned")
                    and len(tap["records"]) > self.RANGE_TAP_MAX):
                tap["poisoned"] = "delta outran the copy (tap overflow)"

    def range_export(self, lo: int, hi: int, split_id: str) -> tuple[bytes, int]:
        """Scoped snapshot of [lo, hi): inodes in range, dentry maps of
        in-range parents, freelist entries owned by in-range inodes —
        serialized as CRC-framed records (utils/fsm.frame_records, one
        CRC per record) so a torn chunk is refused, not loaded. Captured
        under ONE lock acquisition together with the delta-tap
        registration, so the tap sees exactly the mutations the
        snapshot missed. Refuses while a prepared tx holds the range —
        its outcome could not replay on the target."""
        with self._lock:
            for tx in self.tx_pending.values():
                if any(isinstance((p := o.get("parent")), int)
                       and lo <= p < hi for o in tx.get("ops") or []):
                    raise MetaError(
                        EBUSY, f"prepared tx holds [{lo},{hi}) on mp "
                               f"{self.pid}; retry the split later")
            recs: list[dict] = [{
                "k": "head", "lo": lo, "hi": hi, "split_id": split_id,
                "next_ino": self._next_ino,
            }]
            recs.extend({"k": "inode", "v": v}
                        for i, v in self.inodes.items() if lo <= i < hi)
            recs.extend({"k": "dent", "parent": p, "entries": d}
                        for p, d in self.dentries.items() if lo <= p < hi)
            recs.extend({"k": "free", "key": k, "v": v}
                        for k, v in self.freelist.items()
                        if lo <= self._key_ino(k) < hi)
            recs.extend({"k": "bfree", "key": k, "v": v}
                        for k, v in self.blob_freelist.items()
                        if lo <= self._key_ino(k) < hi)
            from ..utils import fsm as fsmlib

            payload = fsmlib.frame_records(recs)
            # (re-)register the tap: an idempotent re-export resets it
            self._range_taps[split_id] = {
                "split_id": split_id, "lo": lo, "hi": hi,
                "records": [], "poisoned": None}
            return payload, self.apply_id

    def range_drain(self, split_id: str) -> tuple[list[dict], str | None]:
        """Close the delta tap (called right after the freeze apply
        landed — nothing can mutate the range anymore) and hand back the
        collected delta, or the poison reason."""
        with self._lock:
            tap = self._range_taps.pop(split_id, None)
            if tap is None:
                return [], "no delta tap registered (donor leader moved?)"
            return tap["records"], tap.get("poisoned")

    def _apply_range_freeze(self, r: dict) -> dict:
        self.frozen[r["split_id"]] = {
            "lo": r["lo"], "hi": r["hi"], "target_pid": r["target_pid"]}
        return {}

    def _apply_range_thaw(self, r: dict) -> dict:
        self.frozen.pop(r["split_id"], None)
        self._range_taps.pop(r["split_id"], None)
        return {}

    def _apply_range_load(self, r: dict) -> dict:
        """Target-side bulk import of a shipped range snapshot. The
        whole decoded state rides IN the record, so replicas (and the
        oplog/WAL replay) load identical bytes through the ordinary
        commit door. Does NOT claim the range — range_activate does,
        after the delta replay, so readers never see a stale copy."""
        st = r["state"]
        for k, v in st.get("inodes", {}).items():
            self.inodes[int(k)] = v
        for k, v in st.get("dentries", {}).items():
            self.dentries[int(k)] = v
        self.freelist.update(st.get("freelist", {}))
        self.blob_freelist.update(st.get("blob_freelist", {}))
        self._next_ino = max(self._next_ino,
                             int(st.get("next_ino", 0)), r["lo"])
        if self._mir is not None:
            self._mirror_full()
        return {"inodes": len(st.get("inodes", {}))}

    def _apply_range_activate(self, r: dict) -> dict:
        lo, hi = r["lo"], r["hi"]
        self.end = max(self.end, hi)
        # a range can come BACK (split handed it away, a later merge
        # returns it): tombstones covering the re-claimed span would
        # shadow the live trees with redirects to a retired partition
        for k in [k for k in self.moved
                  if not (int(k.split("-")[1]) <= lo
                          or hi <= int(k.split("-")[0]))]:
            del self.moved[k]
        for sid in [s for s, f in self.frozen.items()
                    if not (f["hi"] <= lo or hi <= f["lo"])]:
            del self.frozen[sid]
            self._range_taps.pop(sid, None)
        if self._mir is not None:
            self._mirror_moved()
        return {"start": self.start, "end": self.end}

    def _apply_range_drop(self, r: dict) -> dict:
        """Donor-side handoff: forget the migrated sub-range and shrink
        the served range. The moved marker makes every later touch of
        these inos redirect (EMOVED/453) instead of lying ENOENT to a
        client holding a pre-split partition map."""
        lo, hi, tpid = r["lo"], r["hi"], r["target_pid"]
        for ino in [i for i in self.inodes if lo <= i < hi]:
            del self.inodes[ino]
        for p in [p for p in self.dentries if lo <= p < hi]:
            del self.dentries[p]
        for k in [k for k in self.freelist if lo <= self._key_ino(k) < hi]:
            del self.freelist[k]
        for k in [k for k in self.blob_freelist
                  if lo <= self._key_ino(k) < hi]:
            del self.blob_freelist[k]
        if self.end == hi:
            self.end = lo
        for sid in [s for s, f in self.frozen.items()
                    if lo <= f["lo"] and f["hi"] <= hi]:
            del self.frozen[sid]
            self._range_taps.pop(sid, None)
        self.moved[f"{lo}-{hi}"] = tpid
        if self._mir is not None:
            self._mirror_full()
        return {"start": self.start, "end": self.end}

    # ---------------- raft FSM snapshot interface ----------------
    def _state_dict(self) -> dict:
        """The ONE serialized form of the FSM state — used by raft
        snapshots and the on-disk checkpoint alike, so a new field can
        never be persisted in one path and dropped in the other."""
        return {
            "apply_id": self.apply_id, "next_ino": self._next_ino,
            "inodes": {str(k): v for k, v in self.inodes.items()},
            "dentries": {str(k): v for k, v in self.dentries.items()},
            "tx_pending": self.tx_pending,
            "tx_committed": self.tx_committed,
            "freelist": self.freelist,
            "blob_freelist": self.blob_freelist,
            "frozen": self.frozen,
            "moved": self.moved,
            "range_start": self.start,
            "range_end": self.end,
        }

    def _load_state_dict(self, st: dict) -> None:
        self.apply_id = st["apply_id"]
        self._next_ino = st["next_ino"]
        self.inodes = {int(k): v for k, v in st["inodes"].items()}
        self.dentries = {int(k): v for k, v in st["dentries"].items()}
        self.tx_pending = st.get("tx_pending", {})
        self.tx_committed = st.get("tx_committed", {})
        self.freelist = st.get("freelist", {})
        self.blob_freelist = st.get("blob_freelist", {})
        self.frozen = st.get("frozen", {})
        self.moved = st.get("moved", {})
        # a range apply may have shifted [start, end) past what the
        # creator knew (a raft snapshot install on a freshly re-created
        # member, a checkpoint reload mid-migration)
        self.start = st.get("range_start", self.start)
        self.end = st.get("range_end", self.end)

    def export_state(self) -> tuple[bytes, int]:
        """(serialized state, apply_id) captured under ONE lock
        acquisition, so the manifest id always matches the payload. The
        single owner of state serialization — raft snapshots
        (state_bytes) and the export RPC both come through here."""
        with self._lock:
            return json.dumps(self._state_dict()).encode(), self.apply_id

    def state_bytes(self) -> bytes:
        """Serialize the whole partition state (raft snapshot payload)."""
        return self.export_state()[0]

    def restore_state(self, data: bytes) -> None:
        with self._lock:
            self._load_state_dict(json.loads(data))
            self._dirty = set(self._SEGMENTS)  # checkpoint must re-dump
            if self._mir is not None:
                self._mirror_full()

    # ---------------- native read-plane mirror ----------------
    def attach_mirror(self, lib, handle) -> None:
        with self._lock:
            self._mir = (lib, handle)
            self._mirror_full()

    def _mirror_full(self) -> None:
        lib, h = self._mir
        lib.ms_clear(h, self.pid)
        for ino in self.inodes:
            self._mirror_inode(ino)
        for parent, d in self.dentries.items():
            lib.ms_ensure_dir(h, self.pid, parent)
            for name, ino in d.items():
                nb = name.encode()
                lib.ms_put_dentry(h, self.pid, parent, nb, len(nb), ino)
        self._mirror_moved()

    def _mirror_moved(self) -> None:
        """The moved sub-ranges, so the native plane redirects reads of
        them (453) as ``_range_gate_read`` does, where the reference's
        answers ENOENT from the dropped trees."""
        lib, h = self._mir
        flat = [int(x) for key, tpid in self.moved.items() for x in (*key.split("-"), tpid)]
        lib.ms_set_moved(h, self.pid, (ctypes.c_uint64 * len(flat))(*flat), len(self.moved))

    def _mirror_inode(self, ino: int) -> None:
        lib, h = self._mir
        inode = self.inodes.get(ino)
        if inode is None:
            lib.ms_del_inode(h, self.pid, ino)
        else:
            blob = json.dumps(inode).encode()
            lib.ms_put_inode(h, self.pid, ino, blob, len(blob))

    def _mirror_dentry(self, parent: int, name: str) -> None:
        """Re-state one dentry from current tree state (self-correcting:
        works for link, replace and remove alike)."""
        lib, h = self._mir
        nb = name.encode()
        ino = self.dentries.get(parent, {}).get(name)
        if ino is None:
            lib.ms_del_dentry(h, self.pid, parent, nb, len(nb))
        else:
            lib.ms_put_dentry(h, self.pid, parent, nb, len(nb), ino)

    def _mirror_op(self, r: dict, result) -> None:
        """Called under the partition lock right after a successful
        apply; mirrors exactly the trees the op touched."""
        lib, h = self._mir
        op = r["op"]
        if op in ("mk_inode", "mknod"):
            ino = r["ino"] if op == "mk_inode" else result["ino"]
            self._mirror_inode(ino)
            if r["type"] == DIR:
                lib.ms_ensure_dir(h, self.pid, ino)
            if op == "mknod":
                self._mirror_dentry(r["parent"], r["name"])
        elif op == "rm_inode":
            lib.ms_del_inode(h, self.pid, r["ino"])
            lib.ms_del_dir(h, self.pid, r["ino"])
        elif op in ("inc_nlink", "dec_nlink"):
            self._mirror_inode(r["ino"])  # handles removal (None) too
            if op == "dec_nlink" and result.get("removed"):
                lib.ms_del_dir(h, self.pid, r["ino"])
        elif op == "unlink2":
            self._mirror_dentry(r["parent"], r["name"])
            if result.get("removed", True):
                lib.ms_del_inode(h, self.pid, result["ino"])
                lib.ms_del_dir(h, self.pid, result["ino"])
            else:  # a hardlink remains: the inode changed (nlink)
                self._mirror_inode(result["ino"])
        elif op in ("mk_dentry", "rm_dentry"):
            self._mirror_dentry(r["parent"], r["name"])
        elif op == "rename_local":
            # add-before-delete: put the dst dentry first, then drop the
            # src. The native read plane sees each mirror call
            # individually — delete-first opens a window where the file
            # is reachable under NEITHER name (a native lookup racing
            # the rename gets spurious ENOENT)
            self._mirror_dentry(r["dst_parent"], r["dst_name"])
            self._mirror_dentry(r["src_parent"], r["src_name"])
            # the apply bumps the moved inode's gen (tiering fence)
            moved = self.dentries.get(r["dst_parent"], {}).get(r["dst_name"])
            if moved is not None:
                self._mirror_inode(moved)
        elif op in ("append_extents", "set_attr", "set_xattr", "truncate",
                    # the cold tier's applies rewrite the inode's xattrs
                    # and extents too (the reference does not mirror
                    # them: its native reads went on serving the hot
                    # inode after a migration)
                    "tiering_prepare", "tiering_blob_written", "tiering_commit",
                    "tiering_finish", "tiering_abort", "untier_commit"):
            self._mirror_inode(r["ino"])
        elif op == "tx_commit":
            # same add-before-delete discipline for cross-partition
            # renames: replay the dst links before the src removals so
            # native readers never observe the no-name window
            ops = [o for o in self._last_tx_ops or ()
                   if o["kind"] not in ("guard_empty_dir", "mutex")]
            for o in sorted(ops, key=lambda o: o["kind"] != "link"):
                self._mirror_dentry(o["parent"], o["name"])
            self._last_tx_ops = None

    # ---------------- snapshot / recovery ----------------
    # Segmented checkpoint (partition_store.go analog: each tree dumps
    # to its own CRC'd file; the applyID watermark file commits the set
    # LAST). Only trees dirtied since the previous checkpoint are
    # rewritten — an append-only workload re-dumps inodes but never the
    # dentry tree. The oplog is truncated at checkpoint; auto-checkpoint
    # fires every SNAPSHOT_EVERY records, so per-op cost is amortized
    # O(1) instead of O(partition) on every external snapshot call.
    SNAPSHOT_EVERY = 4096
    _SEGMENTS = ("inodes", "dentries", "tx", "freelist", "range")
    _DIRTY_MAP = {
        "range_freeze": {"range"},
        "range_thaw": {"range"},
        "range_load": {"inodes", "dentries", "freelist"},
        "range_activate": {"range"},
        "range_drop": {"inodes", "dentries", "freelist", "range"},
        "mk_inode": {"inodes", "dentries"},
        "rm_inode": {"inodes", "dentries", "freelist"},
        "inc_nlink": {"inodes"},
        "dec_nlink": {"inodes", "dentries", "freelist"},
        "mk_dentry": {"dentries"},
        "rm_dentry": {"dentries"},
        "rename_local": {"dentries", "inodes"},  # gen bump fences tiering
        "append_extents": {"inodes"},
        "set_attr": {"inodes"},
        "set_xattr": {"inodes"},
        "truncate": {"inodes", "freelist"},
        "free_done": {"freelist"},
        "blob_free_done": {"freelist"},
        "blob_reconcile_enqueue": {"freelist"},
        "tiering_prepare": {"inodes"},
        "tiering_blob_written": {"inodes", "freelist"},
        "tiering_commit": {"inodes", "freelist"},
        "tiering_finish": {"inodes"},
        "tiering_abort": {"inodes", "freelist"},
        "untier_commit": {"inodes", "freelist"},
        "tx_prepare": {"tx"},
        "tx_abort": {"tx"},
        "tx_finish": {"tx"},
        "tx_commit": {"tx", "dentries"},
    }

    def _seg_payload(self, name: str) -> dict:
        if name == "inodes":
            return {"inodes": {str(k): v for k, v in self.inodes.items()},
                    "next_ino": self._next_ino}
        if name == "dentries":
            return {"dentries": {str(k): v for k, v in self.dentries.items()}}
        if name == "freelist":
            return {"freelist": self.freelist,
                    "blob_freelist": self.blob_freelist}
        if name == "range":
            return {"frozen": self.frozen, "moved": self.moved,
                    "range_start": self.start, "range_end": self.end}
        return {"tx_pending": self.tx_pending,
                "tx_committed": self.tx_committed}

    def _mark_dirty(self, name: str) -> None:
        self._dirty.add(name)

    def snapshot(self) -> None:
        if not self.data_dir:
            return
        with self._lock:
            seg_crcs = dict(getattr(self, "_seg_crcs", {}))
            for name in self._SEGMENTS:
                if name in seg_crcs and name not in self._dirty:
                    continue  # unchanged since the last checkpoint
                payload = json.dumps(self._seg_payload(name)).encode()
                crc = zlib.crc32(payload)
                # content-addressed filename: a dirty segment writes a NEW
                # file and the old one stays intact until the watermark
                # flips — a crash mid-checkpoint always leaves a fully
                # consistent (old or new) set referenced by the watermark
                fname = f"{name}.{crc:08x}.seg"
                tmp = os.path.join(self.data_dir, fname + ".tmp")
                with open(tmp, "wb") as f:
                    f.write(payload)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, os.path.join(self.data_dir, fname))
                seg_crcs[name] = crc
            # the watermark commits the segment set atomically, LAST
            meta = json.dumps({
                "pid": self.pid, "start": self.start, "end": self.end,
                "apply_id": self.apply_id, "seg_crcs": seg_crcs,
            }).encode()
            tmp = os.path.join(self.data_dir, "apply.meta.tmp")
            with open(tmp, "wb") as f:
                f.write(meta)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(self.data_dir, "apply.meta"))
            # GC segment files the committed watermark no longer references
            live = {f"{n}.{c:08x}.seg" for n, c in seg_crcs.items()}
            for f in os.listdir(self.data_dir):
                if f.endswith(".seg") and f not in live:
                    try:
                        os.unlink(os.path.join(self.data_dir, f))
                    except OSError:
                        pass
            self._seg_crcs = seg_crcs
            self._dirty = set()
            self._oplog_records = 0
            open(os.path.join(self.data_dir, "oplog.jsonl"), "w").close()
            if self._oplog is not None:
                self._oplog.close()
            self._oplog = open(os.path.join(self.data_dir, "oplog.jsonl"), "a")

    def _load(self) -> None:
        self._dirty = set(self._SEGMENTS)
        self._oplog_records = 0
        watermark = os.path.join(self.data_dir, "apply.meta")
        legacy = os.path.join(self.data_dir, "snap.bin")
        if os.path.exists(watermark):
            wm = json.loads(open(watermark, "rb").read())
            state: dict = {"apply_id": wm["apply_id"], "next_ino": self.start,
                           "inodes": {}, "dentries": {}}
            for name, crc in wm["seg_crcs"].items():
                path = os.path.join(self.data_dir, f"{name}.{crc:08x}.seg")
                if not os.path.exists(path):
                    # a referenced-but-missing segment is CORRUPTION, not
                    # an empty tree: booting without it would silently
                    # drop every record it held
                    raise MetaError(
                        5, f"segment {name} missing for mp {self.pid}")
                payload = open(path, "rb").read()
                if zlib.crc32(payload) != crc:
                    raise MetaError(
                        5, f"segment {name} crc mismatch for mp {self.pid}")
                state.update(json.loads(payload))
            self._load_state_dict(state)
            self._seg_crcs = {n: c for n, c in wm["seg_crcs"].items()}
            self._dirty = set()
        elif os.path.exists(legacy):
            raw = open(legacy, "rb").read()
            crc, state = int.from_bytes(raw[:4], "little"), raw[4:]
            if zlib.crc32(state) != crc:
                raise MetaError(5, f"snapshot crc mismatch for mp {self.pid}")
            self._load_state_dict(json.loads(state))
        if self.start <= ROOT_INO < self.end and ROOT_INO not in self.inodes:
            # bootstrap root BEFORE oplog replay: the first records of a
            # checkpoint-less root partition are creates under "/", and
            # replaying them against a rootless tree would drop them all
            # (ENOENT reads as "failed identically at apply time" below)
            self.apply({"op": "mk_inode", "ino": ROOT_INO, "type": DIR,
                        "mode": 0o755})
        oplog = os.path.join(self.data_dir, "oplog.jsonl")
        if os.path.exists(oplog):
            for line in open(oplog):
                line = line.strip()
                if line:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        break
                    aid = rec.pop("aid", None)
                    if aid is not None and aid <= self.apply_id:
                        continue  # checkpoint already contains this op
                    try:
                        self.apply(rec)
                    except MetaError:
                        pass  # op failed identically at original apply time

    # ---------------- inode ops ----------------
    def alloc_ino(self, op_id: str | None = None) -> int:
        """Reserve the next free inode number. The reservation is local
        (not replicated — the ino only becomes durable via the mk_inode
        submit), but a transport retry must get the SAME ino back, or
        the lost first reservation leaks a number from the range and
        the client may observe two different inos for one create.

        Exercised dynamically by tests/test_chaos.py: an injected
        drop-after-execute / duplicate delivery (faultinject.FaultPlan)
        on alloc_ino must mint exactly one ino — the _alloc_cache door
        here is what makes the rpc.call idempotency contract hold."""
        self._geo_gate()
        with self._lock:
            if op_id is not None and op_id in self._alloc_cache:
                return self._alloc_cache[op_id]
            while self._next_ino in self.inodes or self._next_ino == ROOT_INO:
                self._next_ino += 1
            if self._next_ino >= self.end:
                raise MetaError(28, f"mp {self.pid} inode range exhausted")
            if self.range_target(self._next_ino) is not None:
                # the allocation cursor sits in a frozen/moved sub-range:
                # this partition can't mint inos anymore — same fallback
                # contract as a genuinely exhausted range
                raise MetaError(
                    28, f"mp {self.pid} alloc cursor inside a migrating range")
            ino = self._next_ino
            self._next_ino += 1  # reserve: concurrent creates stay unique
            if op_id is not None:
                self._alloc_cache[op_id] = ino
                if len(self._alloc_cache) > self.OP_CACHE_SIZE:
                    for k in list(self._alloc_cache)[: self.OP_CACHE_SIZE // 2]:
                        del self._alloc_cache[k]
            return ino

    def _apply_mk_inode(self, r: dict) -> dict:
        ino = r["ino"]
        if ino in self.inodes:
            raise MetaError(EEXIST, f"inode {ino} exists")
        now = r.get("ts", 0.0)
        self.inodes[ino] = {
            "ino": ino, "type": r["type"], "mode": r.get("mode", 0o644),
            "size": 0, "nlink": 2 if r["type"] == DIR else 1,
            "uid": r.get("uid", 0), "gid": r.get("gid", 0),
            "mtime": now, "ctime": now, "atime": now,
            "extents": [], "xattr": {}, "target": r.get("target"),
            "quota_ids": list(r.get("quota_ids") or []),
        }
        if r["type"] == DIR:
            self.dentries.setdefault(ino, {})
        self._next_ino = max(self._next_ino, ino + 1)
        return {"ino": ino}

    def _apply_rm_inode(self, r: dict) -> dict:
        ino = r["ino"]
        inode = self.inodes.pop(ino, None)
        self.dentries.pop(ino, None)
        exts = inode["extents"] if inode else []
        deferred = [ek for ek in exts if not ek.get("tiny")]
        if deferred:
            # server-side deferred deletion: the background free scan
            # (MetaNode._free_scan) owns reclaiming these from datanodes
            self.freelist[str(ino)] = {
                "extents": deferred, "ts": r.get("ts", 0.0)}
        if inode is not None:
            self._reap_inode_blobs(inode, r.get("ts", 0.0))
        return {"extents": exts, "deferred": bool(deferred)}

    def _apply_mk_dentry(self, r: dict) -> dict:
        parent, name = r["parent"], r["name"]
        self._check_unlocked(parent, name)
        d = self.dentries.get(parent)
        if d is None:
            raise MetaError(ENOENT, f"parent dir {parent} not here")
        if name in d:
            raise MetaError(EEXIST, f"{name!r} exists in {parent}")
        d[name] = r["ino"]
        return {}

    def _apply_mknod(self, r: dict) -> dict:
        """Compound create: inode + dentry in ONE commit (the dominant
        create cost in the deployed A/B was two raft commits + three
        client round trips per file). The inode is allocated from the
        PARENT's partition — locality-preserving placement; callers
        fall back to the two-op path when this range is exhausted
        (MetaError 28). Allocation happens inside apply, so replicas
        allocate identically."""
        parent, name = r["parent"], r["name"]
        self._check_unlocked(parent, name)
        d = self.dentries.get(parent)
        if d is None:
            raise MetaError(ENOENT, f"parent dir {parent} not here")
        if name in d:
            raise MetaError(EEXIST, f"{name!r} exists in {parent}")
        while self._next_ino in self.inodes or self._next_ino == ROOT_INO:
            self._next_ino += 1
        if self._next_ino >= self.end:
            raise MetaError(28, f"mp {self.pid} inode range exhausted")
        if self.range_target(self._next_ino) is not None:
            # deterministic apply-side fence: a compound create must not
            # mint an ino inside a frozen/moved sub-range (replicas all
            # refuse identically; the client falls back to alloc-elsewhere)
            raise MetaError(
                28, f"mp {self.pid} alloc cursor inside a migrating range")
        ino = self._next_ino
        self._next_ino += 1
        now = r.get("ts", 0.0)
        self.inodes[ino] = {
            "ino": ino, "type": r["type"], "mode": r.get("mode", 0o644),
            "size": 0, "nlink": 2 if r["type"] == DIR else 1,
            "uid": r.get("uid", 0), "gid": r.get("gid", 0),
            "mtime": now, "ctime": now, "atime": now,
            "extents": [], "xattr": {}, "target": r.get("target"),
            "quota_ids": list(r.get("quota_ids") or []),
        }
        if r["type"] == DIR:
            self.dentries.setdefault(ino, {})
        d[name] = ino
        return {"ino": ino}

    def _apply_unlink2(self, r: dict) -> dict:
        """Compound unlink: dentry + inode removal in ONE commit when
        the child inode lives in the same partition as the dentry (the
        mknod placement). Raises EXDEV-ish (code 18) when the child is
        foreign — the caller falls back to the two-op path."""
        parent, name = r["parent"], r["name"]
        self._check_unlocked(parent, name)
        d = self.dentries.get(parent)
        if d is None or name not in d:
            raise MetaError(ENOENT, f"{name!r} not in {parent}")
        ino = d[name]
        t = self.range_target(ino)
        if t is not None:
            # the dentry's parent stayed but the child inode is in a
            # migrating sub-range (the generic fence only sees the
            # parent): refuse the compound removal with the SAME errno
            # as a foreign child — the client's two-op fallback routes
            # the rm_inode half by the child ino, and the 453 chase
            # lands it on the new owner
            raise MetaError(
                18, f"inode {ino} migrating off mp {self.pid} "
                    f"(pid={t})")
        inode = self.inodes.get(ino)
        if inode is None:
            raise MetaError(18, f"inode {ino} not in mp {self.pid}")
        if inode["type"] == DIR and self.dentries.get(ino):
            raise MetaError(ENOTEMPTY, f"{name!r} not empty")
        del d[name]
        if inode["type"] != DIR and inode.get("nlink", 1) > 1:
            # other hardlinks remain: drop this dentry + one link only
            inode["nlink"] -= 1
            inode["ctime"] = r.get("ts", 0.0)
            return {"ino": ino, "extents": [], "deferred": False,
                    "removed": False}
        self.inodes.pop(ino)
        self.dentries.pop(ino, None)
        exts = inode["extents"]
        deferred = [ek for ek in exts if not ek.get("tiny")]
        if deferred:
            self.freelist[str(ino)] = {
                "extents": deferred, "ts": r.get("ts", 0.0)}
        self._reap_inode_blobs(inode, r.get("ts", 0.0))
        return {"ino": ino, "extents": exts, "deferred": bool(deferred),
                "removed": True}

    def _apply_inc_nlink(self, r: dict) -> dict:
        """Hardlink support (metanode CreateLink role): bump the link
        count; the dentry itself lands via mk_dentry on the PARENT's
        partition (two commits client-side; a crash between them leaks
        an overcounted nlink for fsck, never a dangling dentry)."""
        inode = self.inodes.get(r["ino"])
        if inode is None:
            raise MetaError(ENOENT, f"inode {r['ino']}")
        if inode["type"] == DIR:
            raise MetaError(EPERM,
                            "hardlinks to directories are not allowed")
        inode["nlink"] = inode.get("nlink", 1) + 1
        inode["ctime"] = r.get("ts", 0.0)
        return {"nlink": inode["nlink"]}

    def _apply_dec_nlink(self, r: dict) -> dict:
        """Drop one link; the inode (and its extents, via the deferred
        freelist) goes only when the LAST link goes. Directories never
        carry extra links, so a dec removes them outright."""
        ino = r["ino"]
        inode = self.inodes.get(ino)
        if inode is None:
            raise MetaError(ENOENT, f"inode {ino}")
        if inode["type"] != DIR and inode.get("nlink", 1) > 1:
            inode["nlink"] -= 1
            inode["ctime"] = r.get("ts", 0.0)
            return {"removed": False, "nlink": inode["nlink"]}
        return {"removed": True, **self._apply_rm_inode(r)}

    def _apply_rm_dentry(self, r: dict) -> dict:
        parent, name = r["parent"], r["name"]
        self._check_unlocked(parent, name)
        d = self.dentries.get(parent)
        if d is None or name not in d:
            raise MetaError(ENOENT, f"{name!r} not in {parent}")
        ino = d.pop(name)
        return {"ino": ino}

    # ---------------- transactions (metanode/transaction.go analog) ----
    # Two-phase protocol for multi-partition atomicity (rename across
    # parents). Prepare validates the sub-ops and locks their dentry
    # keys; commit applies them; abort releases. One involved partition
    # is the COORDINATOR (the reference's TM): the client commits there
    # first, and its durable commit decision is what participants (RMs)
    # consult when an undecided prepared tx expires — roll forward if the
    # coordinator committed, roll back otherwise. Reference:
    # metanode/transaction.go:1, partition_fsmop_transaction.go.

    def _tx_lock_owner(self, parent: int, name: str) -> str | None:
        for tx_id, tx in self.tx_pending.items():
            for op in tx["ops"]:
                if op["parent"] == parent and (
                    op["name"] == name or op["kind"] == "guard_empty_dir"
                ):
                    # a guard op locks the WHOLE parent (no new children
                    # may appear under a dir being replaced)
                    return tx_id
        return None

    def _check_unlocked(self, parent: int, name: str, tx_id: str | None = None):
        owner = self._tx_lock_owner(parent, name)
        if owner is not None and owner != tx_id:
            raise MetaError(
                EBUSY, f"dentry ({parent}, {name!r}) locked by tx {owner}"
            )

    def _gc_tx(self, now: float) -> None:
        # commit records that name participants are GC'd only by
        # tx_finish (after every participant has provably resolved) — a
        # TTL here would let a long-partitioned participant later read
        # "unknown" and roll BACK a committed tx. Recordless (local)
        # commits expire by TTL.
        for k in [k for k, v in self.tx_committed.items()
                  if not v.get("parts") and now - v["ts"] > self.TX_COMMIT_TTL]:
            del self.tx_committed[k]

    def _apply_tx_prepare(self, r: dict) -> dict:
        """r: {tx_id, ops: [...], coord, parts?, ts}. Op kinds:
          * ``link`` — install parent/name -> ino, replacing the target
            the client validated (`victim` = expected current ino or
            None; asserted here, and the key stays locked until commit,
            so the target cannot change in between).
          * ``rm`` — remove; with `ino`, assert the dentry still points
            at it.
          * ``guard_empty_dir`` — assert the dir's local dentry map is
            empty and lock the whole parent so no child can be created
            while a replace-over-dir tx is in flight.
        On the COORDINATOR, `parts` lists the participant partitions so
        its scanner can push the decision and only GC the commit record
        once every participant has resolved."""
        tx_id = r["tx_id"]
        now = r.get("ts", 0.0)
        self._gc_tx(now)
        if tx_id in self.tx_pending or tx_id in self.tx_committed:
            return {}  # idempotent retry
        for op in r["ops"]:
            self._check_unlocked(op["parent"], op["name"], tx_id)
            if op["kind"] == "mutex":
                # pure named lock (no dentry semantics): held from
                # prepare to commit/abort — the cluster-wide
                # serialization primitive for cross-directory dir
                # renames (the kernel's s_vfs_rename_mutex analog)
                continue
            if op["kind"] == "guard_empty_dir":
                children = self.dentries.get(op["parent"])
                if children:
                    raise MetaError(
                        ENOTEMPTY, f"dir {op['parent']} not empty")
                continue
            d = self.dentries.get(op["parent"])
            if d is None:
                raise MetaError(ENOENT, f"parent dir {op['parent']} not here")
            if op["kind"] == "rm":
                if op["name"] not in d:
                    raise MetaError(ENOENT, f"{op['name']!r} not in {op['parent']}")
                if op.get("ino") is not None and d[op["name"]] != op["ino"]:
                    raise MetaError(ENOENT, f"{op['name']!r} changed under tx")
            elif op["kind"] == "link":
                if op.get("noreplace") and d.get(op["name"]) is not None:
                    raise MetaError(
                        EEXIST, f"{op['name']!r} exists (NOREPLACE)")
                if "victim" in op and d.get(op["name"]) != op["victim"]:
                    raise MetaError(
                        ENOENT, f"target {op['name']!r} changed under tx")
        self.tx_pending[tx_id] = {
            "ops": r["ops"], "ts": now, "coord": r.get("coord"),
            "parts": r.get("parts"),
        }
        return {}

    def _apply_tx_commit(self, r: dict) -> dict:
        tx_id = r["tx_id"]
        self._last_tx_ops = None  # idempotent retry must not replay hints
        done = self.tx_committed.get(tx_id)
        if done is not None:
            return {"victims": done["victims"]}  # idempotent retry
        tx = self.tx_pending.pop(tx_id, None)
        if tx is None:
            raise MetaError(ENOENT, f"tx {tx_id} not prepared here")
        self._last_tx_ops = tx["ops"]  # mirror hint (not FSM state)
        victims: list[int] = []
        for op in tx["ops"]:
            if op["kind"] in ("guard_empty_dir", "mutex"):
                continue
            d = self.dentries.setdefault(op["parent"], {})
            if op["kind"] == "rm":
                d.pop(op["name"], None)
            else:
                old = d.get(op["name"])
                if old is not None and old != op["ino"]:
                    victims.append(old)
                d[op["name"]] = op["ino"]
        self.tx_committed[tx_id] = {
            "victims": victims, "ts": r.get("ts", 0.0),
            "parts": tx.get("parts"),
        }
        return {"victims": victims}

    def _apply_tx_finish(self, r: dict) -> dict:
        """Coordinator-only: every participant has resolved — the commit
        record is no longer needed for recovery and can be dropped."""
        self.tx_committed.pop(r["tx_id"], None)
        return {}

    def _apply_tx_abort(self, r: dict) -> dict:
        self.tx_pending.pop(r["tx_id"], None)
        return {}

    def _apply_rename_local(self, r: dict) -> dict:
        """Atomic same-partition rename: unlink src and (re)link dst in
        ONE fsm apply — no intermediate double-link or missing-link state
        is ever visible or persisted. Returns the replaced victim inode
        (or None). The client validates POSIX type rules and passes its
        expectations ("ino" for src, "victim" for dst); the apply
        re-asserts them, so a concurrent mutation between validation and
        apply fails cleanly instead of silently clobbering."""
        sp, sn = r["src_parent"], r["src_name"]
        dp, dn = r["dst_parent"], r["dst_name"]
        self._check_unlocked(sp, sn)
        self._check_unlocked(dp, dn)
        sd = self.dentries.get(sp)
        if sd is None or sn not in sd:
            raise MetaError(ENOENT, f"{sn!r} not in {sp}")
        if r.get("ino") is not None and sd[sn] != r["ino"]:
            raise MetaError(ENOENT, f"{sn!r} changed under rename")
        dd = self.dentries.get(dp)
        if dd is None:
            raise MetaError(ENOENT, f"parent dir {dp} not here")
        victim = dd.get(dn)
        if r.get("noreplace") and victim is not None:
            # RENAME_NOREPLACE: asserted INSIDE the atomic apply, so a
            # concurrent create can never be silently clobbered
            raise MetaError(EEXIST, f"{dn!r} exists (NOREPLACE)")
        if "victim" in r and victim != r["victim"]:
            raise MetaError(ENOENT, f"target {dn!r} changed under rename")
        if victim is not None and self.dentries.get(victim):
            # victim is a dir with local children: re-assert emptiness
            # inside the atomic apply (the client's check raced)
            raise MetaError(ENOTEMPTY, f"target dir {victim} not empty")
        ino = sd.pop(sn)
        if victim == ino:
            victim = None
        dd[dn] = ino
        moved = self.inodes.get(ino)
        if moved is not None:
            # namespace identity changed: fence any in-flight migration
            # that resolved this inode by its old path
            moved["gen"] = moved.get("gen", 0) + 1
        return {"victim": victim}

    def tx_status(self, tx_id: str) -> str:
        with self._lock:
            if tx_id in self.tx_committed:
                return "committed"
            if tx_id in self.tx_pending:
                return "pending"
            return "unknown"

    def expired_txs(self, now: float | None = None) -> list[tuple[str, dict]]:
        now = time.time() if now is None else now
        with self._lock:
            return [(tx_id, dict(tx)) for tx_id, tx in self.tx_pending.items()
                    if now - tx["ts"] > self.TX_TTL]

    def _apply_append_extents(self, r: dict) -> dict:
        inode = self.inodes.get(r["ino"])
        if inode is None:
            raise MetaError(ENOENT, f"inode {r['ino']}")
        inode["extents"].extend(r["extents"])
        inode["size"] = max(inode["size"], r.get("size", inode["size"]))
        inode["mtime"] = r.get("ts", 0.0)
        # generation counter: every data mutation bumps it, so a tiering
        # commit prepared against an older gen fences instead of
        # dropping this write (`.get` keeps pre-gen snapshots loadable)
        inode["gen"] = inode.get("gen", 0) + 1
        return {}

    def _apply_set_attr(self, r: dict) -> dict:
        inode = self.inodes.get(r["ino"])
        if inode is None:
            raise MetaError(ENOENT, f"inode {r['ino']}")
        for k in ("mode", "uid", "gid", "size", "mtime", "atime", "nlink"):
            if k in r:
                inode[k] = r[k]
        if "size" in r:  # length change is a data mutation: fence tiering
            inode["gen"] = inode.get("gen", 0) + 1
        inode["ctime"] = r.get("ts", 0.0)
        return {}

    def _apply_set_xattr(self, r: dict) -> dict:
        inode = self.inodes.get(r["ino"])
        if inode is None:
            raise MetaError(ENOENT, f"inode {r['ino']}")
        if r.get("value") is None:
            inode["xattr"].pop(r["key"], None)
        else:
            inode["xattr"][r["key"]] = r["value"]
        return {}

    def _apply_truncate(self, r: dict) -> dict:
        inode = self.inodes.get(r["ino"])
        if inode is None:
            raise MetaError(ENOENT, f"inode {r['ino']}")
        size = r["size"]
        inode["size"] = size
        inode["gen"] = inode.get("gen", 0) + 1
        if size == 0:
            old = inode["extents"]
            inode["extents"] = []
            self._defer_free(r["ino"], old, r.get("ts", 0.0))
            # truncating a cold (or mid-migration) file to zero makes
            # its blob copy unreachable: queue it for the orphan reaper
            self._reap_inode_blobs(inode, r.get("ts", 0.0))
            for k in ("tiering.state", "tiering.gen", "tiering.ts"):
                inode["xattr"].pop(k, None)
            return {"extents": old}
        # shrink: drop keys entirely past the new EOF (freed for GC) and
        # clip a straddling key's mapped length — reads in [size, later
        # writes) then fall into an uncovered gap and return zeros, never
        # resurrected pre-truncate bytes
        kept, freed = [], []
        for ek in inode["extents"]:
            fo = ek["file_offset"]
            if fo >= size:
                freed.append(ek)
            elif fo + ek["size"] > size:
                clipped = dict(ek)
                clipped["size"] = size - fo
                kept.append(clipped)  # physical tail stays allocated
            else:
                kept.append(ek)
        inode["extents"] = kept
        self._defer_free(r["ino"], freed, r.get("ts", 0.0))
        return {"extents": freed}

    def _defer_free(self, ino: int, extents: list, ts: float) -> None:
        """Queue non-tiny freed extents for the background deletion scan
        (tiny extents are shared across files, never reclaimed here).
        Keyed by apply_id so repeated truncates of one inode never
        collide; apply_id is part of the FSM, so replicas agree."""
        deferred = [ek for ek in extents if not ek.get("tiny")]
        if deferred:
            self.freelist[f"{ino}:t{self.apply_id}"] = {
                "extents": deferred, "ts": ts}

    def _apply_free_done(self, r: dict) -> dict:
        self.freelist.pop(r["key"], None)
        return {}

    def freelist_entries(self) -> list[tuple[str, dict]]:
        with self._lock:
            return [(k, dict(v)) for k, v in self.freelist.items()]

    # ---------------- cold-tier two-phase migration FSM ----------------
    # The fs->blob bridge persists its state IN the inode (xattrs), so
    # WAL replay, raft failover, and lcnode restarts all see exactly
    # where a migration stopped:
    #
    #   (hot) --tiering_prepare--> PREPARE --tiering_blob_written-->
    #   BLOB_WRITTEN --tiering_commit--> COMMITTED --tiering_finish-->
    #   (cold: cold.location set, extents released)
    #
    # Every step fences on the generation counter captured at prepare:
    # a write/truncate/rename racing the migration bumps gen, and the
    # fenced step queues the now-orphaned blob onto blob_freelist and
    # rolls the inode back to hot — the RACING WRITE WINS, the blob
    # copy loses. Fence failures mutate state (rollback + blob enqueue)
    # and must therefore RETURN {"ok": False} instead of raising:
    # apply() skips segment dirtying on MetaError, so a mutate-then-
    # raise would leave checkpoints missing the rollback.

    _TIER_XATTRS = ("tiering.state", "tiering.gen", "tiering.ts")

    def _defer_blob_free(self, ino: int, location, ts: float) -> None:
        """Queue one unreachable blob location for the orphan reaper.
        Keyed by apply_id (FSM state) so repeated enqueues for one
        inode never collide and replicas agree on the key."""
        if not location or location.get("empty"):
            return  # empty-file sentinel: nothing stored in the blob plane
        self.blob_freelist[f"{ino}:b{self.apply_id}"] = {
            "location": location, "ts": ts}

    def _reap_inode_blobs(self, inode: dict, ts: float) -> None:
        """Queue every blob an inode references (committed cold.location
        and/or mid-migration tiering.pending) onto blob_freelist —
        called from any apply that makes the payload unreachable."""
        xa = inode.get("xattr") or {}
        cold = xa.pop("cold.location", None)
        if cold:
            self._defer_blob_free(
                inode["ino"],
                json.loads(cold) if isinstance(cold, str) else cold, ts)
        pending = xa.pop("tiering.pending", None)
        if pending:
            self._defer_blob_free(inode["ino"], pending, ts)

    def _clear_tiering(self, inode: dict) -> None:
        for k in self._TIER_XATTRS:
            inode["xattr"].pop(k, None)

    def _apply_tiering_prepare(self, r: dict) -> dict:
        inode = self.inodes.get(r["ino"])
        if inode is None:
            raise MetaError(ENOENT, f"inode {r['ino']}")
        if inode["type"] != FILE:
            raise MetaError(EISDIR, f"inode {r['ino']} is not a file")
        xa = inode["xattr"]
        st = xa.get("tiering.state")
        if st is not None:
            raise MetaError(EBUSY, f"inode {r['ino']} migration in {st}")
        if xa.get("cold.location"):
            raise MetaError(EEXIST, f"inode {r['ino']} already cold")
        gen = inode.get("gen", 0)
        xa["tiering.state"] = "PREPARE"
        xa["tiering.gen"] = gen
        xa["tiering.ts"] = r.get("ts", 0.0)
        return {"gen": gen, "size": inode["size"]}

    def _apply_tiering_blob_written(self, r: dict) -> dict:
        """Phase 2: the blob copy is durable (and CRC-verified by the
        engine); pin its location as tiering.pending. A fence failure
        (racing write bumped gen, or the file vanished) queues the blob
        for reaping and rolls back — the hot data was never touched."""
        ts = r.get("ts", 0.0)
        inode = self.inodes.get(r["ino"])
        if inode is None:
            self._defer_blob_free(r["ino"], r["location"], ts)
            return {"ok": False, "reason": "unlinked"}
        xa = inode["xattr"]
        if (xa.get("tiering.state") != "PREPARE"
                or inode.get("gen", 0) != r["gen"]):
            self._defer_blob_free(r["ino"], r["location"], ts)
            self._clear_tiering(inode)
            return {"ok": False, "reason": "fenced"}
        xa["tiering.state"] = "BLOB_WRITTEN"
        xa["tiering.pending"] = r["location"]
        return {"ok": True}

    def _apply_tiering_commit(self, r: dict) -> dict:
        """Phase 3, the point of no return — in ONE atomic apply: the
        pending location becomes cold.location and the hot extents move
        to the deferred freelist. Until this apply lands, every crash
        leaves the hot copy fully intact; after it, the blob copy is
        the single source of truth."""
        ts = r.get("ts", 0.0)
        inode = self.inodes.get(r["ino"])
        if inode is None:
            # unlink raced: _reap_inode_blobs already queued the pending
            return {"ok": False, "reason": "unlinked"}
        xa = inode["xattr"]
        st = xa.get("tiering.state")
        if st == "COMMITTED":
            # crash between commit and finish; the rescan just finishes
            return {"ok": True, "already": True}
        if st != "BLOB_WRITTEN" or inode.get("gen", 0) != r["gen"]:
            pending = xa.pop("tiering.pending", None)
            if pending:
                self._defer_blob_free(r["ino"], pending, ts)
            self._clear_tiering(inode)
            return {"ok": False, "reason": "fenced"}
        pending = xa.pop("tiering.pending")
        xa["cold.location"] = json.dumps(pending)
        old = inode["extents"]
        inode["extents"] = []
        self._defer_free(r["ino"], old, ts)
        xa["tiering.state"] = "COMMITTED"
        return {"ok": True, "released": len(old)}

    def _apply_tiering_finish(self, r: dict) -> dict:
        """Clear the transition markers, keeping cold.location — pure
        bookkeeping, idempotent at any point past commit."""
        inode = self.inodes.get(r["ino"])
        if inode is None:
            return {"ok": True}
        if inode["xattr"].get("tiering.state") == "COMMITTED":
            self._clear_tiering(inode)
        return {"ok": inode["xattr"].get("tiering.state") is None}

    def _apply_tiering_abort(self, r: dict) -> dict:
        """Roll an uncommitted migration back to hot; queues any pending
        blob for reaping. Refuses past the commit point (the hot extents
        are already on the freelist — the caller finishes instead)."""
        inode = self.inodes.get(r["ino"])
        if inode is None:
            return {"ok": True}
        xa = inode["xattr"]
        if xa.get("tiering.state") == "COMMITTED":
            return {"ok": False, "reason": "committed"}
        pending = xa.pop("tiering.pending", None)
        if pending:
            self._defer_blob_free(r["ino"], pending, r.get("ts", 0.0))
        self._clear_tiering(inode)
        return {"ok": True}

    def _apply_untier_commit(self, r: dict) -> dict:
        """Re-heat: attach freshly-written (unregistered) hot extents
        and release the blob copy, in one atomic apply. Fenced on gen
        like the forward path; a fence failure reclaims the extents the
        engine just wrote (they were never visible)."""
        ts = r.get("ts", 0.0)
        inode = self.inodes.get(r["ino"])
        if inode is None:
            self._defer_free(r["ino"], r["extents"], ts)
            return {"ok": False, "reason": "unlinked"}
        xa = inode["xattr"]
        cold = xa.get("cold.location")
        if (cold is None or inode.get("gen", 0) != r["gen"]
                or inode["extents"]):
            self._defer_free(r["ino"], r["extents"], ts)
            return {"ok": False, "reason": "fenced"}
        inode["extents"] = list(r["extents"])
        inode["gen"] = inode.get("gen", 0) + 1
        xa.pop("cold.location")
        self._defer_blob_free(
            r["ino"], json.loads(cold) if isinstance(cold, str) else cold,
            ts)
        return {"ok": True}

    def _apply_blob_free_done(self, r: dict) -> dict:
        self.blob_freelist.pop(r["key"], None)
        return {}

    def _apply_blob_reconcile_enqueue(self, r: dict) -> dict:
        """Inventory reconciliation found a blob-plane object no inode
        references (the put->blob_written crash window): queue it on the
        freelist so the existing reaper deletes it. Keyed by apply_id
        via _defer_blob_free (ino 0 = no owner), so replicas agree."""
        self._defer_blob_free(0, r["location"], r.get("ts", 0.0))
        return {"ok": True}

    def blob_freelist_entries(self) -> list[tuple[str, dict]]:
        with self._lock:
            return [(k, dict(v)) for k, v in self.blob_freelist.items()]

    # ---------------- reads (no apply) ----------------
    def inode_get(self, ino: int) -> dict:
        with self._lock:
            inode = self.inodes.get(ino)
            if inode is None:
                raise MetaError(ENOENT, f"inode {ino}")
            return dict(inode)

    def lookup(self, parent: int, name: str) -> int:
        with self._lock:
            d = self.dentries.get(parent)
            if d is None or name not in d:
                raise MetaError(ENOENT, f"{name!r} not in {parent}")
            return d[name]

    def readdir(self, parent: int) -> dict[str, int]:
        with self._lock:
            d = self.dentries.get(parent)
            if d is None:
                raise MetaError(ENOTDIR, f"{parent} is not a dir here")
            return dict(d)

    def dentry_count(self, parent: int) -> int:
        with self._lock:
            return len(self.dentries.get(parent, {}))

    def usage_report(self) -> dict:
        """Per-partition usage: total file bytes/count plus per-quota-id
        sums — recomputed from the inode table (deterministic, no delta
        bookkeeping to drift). The master's quota sweep aggregates these
        across partitions."""
        with self._lock:
            total_b = total_f = 0
            per_quota: dict[str, dict] = {}
            for inode in self.inodes.values():
                if inode["type"] != FILE:
                    continue
                total_b += inode["size"]
                total_f += 1
                for qid in inode.get("quota_ids") or []:
                    u = per_quota.setdefault(str(qid), {"bytes": 0, "files": 0})
                    u["bytes"] += inode["size"]
                    u["files"] += 1
            return {"bytes": total_b, "files": total_f,
                    "per_quota": per_quota}

    def check_limits(self, record: dict) -> None:
        """Leader-side submit-door gate (never in apply — replicas must
        stay deterministic): reject writes that exceed pushed limits."""
        op = record.get("op")
        with self._lock:
            enf = self.enforce
            if op in ("mk_inode", "mknod") and record.get("type") == FILE:
                if any(int(q) in enf["exceeded"]
                       for q in record.get("quota_ids") or []):
                    raise MetaError(EDQUOT, "dir quota exceeded")
            elif op in ("append_extents", "truncate"):
                inode = self.inodes.get(record.get("ino"))
                grows = inode is not None and (
                    record.get("size", 0) > inode["size"])
                if not grows:
                    return
                if enf["vol_full"]:
                    raise MetaError(ENOSPC, "volume is full")
                if inode and any(int(q) in enf["exceeded"]
                                 for q in inode.get("quota_ids") or []):
                    raise MetaError(EDQUOT, "dir quota exceeded")


class _SubmitWaiter:
    """One rpc_submit call parked in a partition's submit coalescer."""

    __slots__ = ("record", "result", "exc", "done", "event", "ref")

    def __init__(self, record: dict):
        self.record = record
        self.result = None
        self.exc: BaseException | None = None
        self.done = False
        self.event = threading.Event()
        # span handoff across the coalescer's first-caller-drains
        # boundary (same contract as the raft _ProposeWaiter)
        self.ref = tracelib.capture()

    def finish(self, result, exc: BaseException | None) -> None:
        self.result = result
        self.exc = exc
        self.done = True
        self.event.set()


class _SubmitBatcher:
    """Per-partition group commit for the RPC submit plane: while one
    propose is in flight (the whole replicate→fsync→apply round),
    concurrent mutations for the same partition queue here and the next
    drain carries them ALL as one `__batch__` raft entry — one
    replication round for N requests, per-op results/errors fanned back
    to their callers. A drain of one coalesces nothing: it proposes the
    record unwrapped, so the uncontended path is the pre-batcher
    behavior. Batch width tracks contention — no timers, no added idle
    latency (same first-caller-drains discipline as the raft batcher
    and `_wal_sync` underneath)."""

    def __init__(self, node: "MetaNode", pid: int):
        self.node = node
        self.pid = pid
        self._mu = lockwitness.make_lock("_SubmitBatcher._mu")
        self._queue: list[_SubmitWaiter] = []
        self._busy = False

    def submit(self, record: dict, timeout: float = 30.0):
        w = _SubmitWaiter(record)
        with self._mu:
            self._queue.append(w)
            drain = not self._busy
            if drain:
                self._busy = True
        if drain:
            self._drain()
        if not w.event.wait(timeout) and not w.done:
            raise rpc.RpcError(503, f"submit to partition {self.pid} "
                                    f"timed out awaiting group commit")
        if w.exc is not None:
            raise w.exc
        return w.result

    def _drain(self) -> None:
        while True:
            with self._mu:
                batch = self._queue
                if not batch:
                    self._busy = False
                    return
                self._queue = []
            self._land(batch)

    def _land(self, batch: list[_SubmitWaiter]) -> None:
        from ..utils import metrics

        raft_node = self.node.rafts.get(self.pid)
        span = tracelib.start_span(
            "stage:submit_coalesce",
            links=[w.ref for w in batch if w.ref is not None])
        span.set_tag("stage", "submit_coalesce").set_tag("pid", self.pid)
        span.set_tag("ops", len(batch))
        t0 = time.perf_counter()
        try:
            with span:
                try:
                    if raft_node is None:
                        raise rpc.RpcError(
                            404, f"meta partition {self.pid} no longer "
                                 f"replicated on node {self.node.node_id}")
                    metrics.meta_ops_per_batch.observe(len(batch),
                                                       pid=self.pid)
                    if len(batch) == 1:
                        batch[0].finish(
                            raft_node.propose(batch[0].record), None)
                        return
                    outs = raft_node.propose(
                        {"op": "__batch__",
                         "records": [w.record for w in batch]})
                    metrics.meta_batch_entries.inc(pid=self.pid)
                    metrics.meta_batched_ops.inc(len(batch), pid=self.pid)
                    for w, (result, err) in zip(batch, outs):
                        if err is not None:
                            w.finish(None, MetaError(err[0], err[1]))
                        else:
                            w.finish(result, None)
                except BaseException as e:
                    # batch-level failure (NotLeaderError, timeout,
                    # apply bug): every still-unresolved waiter
                    # observes the same outcome
                    for w in batch:
                        if not w.done:
                            w.finish(None, e)
        finally:
            # the early return above still lands here: the coalesce
            # stage is observed for every drained batch
            tracelib.observe_stage("submit_coalesce",
                                   span.path or "meta.write",
                                   time.perf_counter() - t0)


class MetaNode:
    """Hosts many MetaPartitions; RPC surface for the meta SDK.

    With peers configured, each partition is a raft group member
    (multi-raft: one RaftNode per partition, handlers mounted on this
    node's live route table) — mutations commit through raft before
    applying, so any majority of metanode replicas preserves the trees.
    """

    REDIRECT = 421  # "not leader; retry at meta['leader']"

    TX_SCAN_INTERVAL = 5.0

    def __init__(self, node_id: int, data_dir: str | None = None,
                 addr: str | None = None, node_pool=None):
        self.node_id = node_id
        self.data_dir = data_dir
        self.addr = addr
        self.pool = node_pool
        self.partitions: dict[int, MetaPartition] = {}
        self.rafts: dict[int, object] = {}  # pid -> RaftNode
        self._batchers: dict[int, _SubmitBatcher] = {}  # pid -> coalescer
        self._coalesce = os.environ.get("CUBEFS_META_COALESCE", "1") != "0"
        self.dp_view_fn = None  # set_dp_view: enables the free scan
        self._wires: dict[str, object] = {}  # packet addr -> WireClient
        self.extra_routes: dict = {}  # live raft handlers (rpc.resolve_route)
        self._lock = lockwitness.make_rlock("MetaNode._lock")
        self._stop = threading.Event()
        # native read plane (csrc/host/metaserve.cc): the C++ tree
        # mirror + GIL-free packet server for the hot read ops. Only
        # CUBEFS_NATIVE_META=0 turns it off; a failed build raises.
        self._native_lib = None
        self._native_h = None
        self.native_addr: str | None = None
        if os.environ.get("CUBEFS_NATIVE_META", "1") != "0":
            from ..runtime import fsnative

            self._native_lib = fsnative.load()
            self._native_h = self._native_lib.ms_create()
        self._tx_scanner = threading.Thread(target=self._tx_scan_loop,
                                            daemon=True)
        self._tx_scanner.start()

    def serve_native(self, host: str = "127.0.0.1", port: int = 0):
        """Start the C++ read-plane server; returns its addr (None when
        the native runtime is unavailable)."""
        if self._native_h is None:
            return None
        p = self._native_lib.ms_serve(self._native_h, host.encode(), port)
        if p < 0:
            return None
        self.native_addr = f"{host}:{p}"
        return self.native_addr

    def create_partition(self, pid: int, start: int, end: int,
                         peers: list[str] | None = None) -> MetaPartition:
        with self._lock:
            if pid not in self.partitions:
                # creation-time bounds are part of replay determinism:
                # every bounds-checked apply in the wal ran against
                # them, so a restart must replay against them too — NOT
                # against a post-migration (shrunk/grown) table row.
                # The wal's own range_load/range_drop applies re-evolve
                # the bounds in order during replay.
                if self.data_dir:
                    rngf = os.path.join(self.data_dir,
                                        f"mp_{pid}.range.json")
                    try:
                        if os.path.exists(rngf):
                            with open(rngf) as f:
                                rec = json.load(f)
                            start, end = int(rec["start"]), int(rec["end"])
                        else:
                            os.makedirs(self.data_dir, exist_ok=True)
                            tmp = rngf + ".tmp"
                            with open(tmp, "w") as f:
                                json.dump({"start": start, "end": end}, f)
                            os.replace(tmp, rngf)
                    except (OSError, ValueError, KeyError):
                        pass
                replicated = bool(peers and len(peers) > 1)
                # replicated partitions persist via the raft wal (replayed
                # into apply on restart) — a second mp-level oplog would
                # double-apply; standalone partitions keep their own oplog
                pdir = (os.path.join(self.data_dir, f"mp_{pid}")
                        if self.data_dir and not replicated else None)
                mp = MetaPartition(pid, start, end, pdir)
                self.partitions[pid] = mp
                if self._native_h is not None:
                    self._native_lib.ms_add_partition(
                        self._native_h, pid, start, end)
                    mp.attach_mirror(self._native_lib, self._native_h)
                    if not replicated:
                        # standalone partitions always leader-serve
                        self._native_lib.ms_set_serving(
                            self._native_h, pid, 1, b"")
                if replicated:
                    if not self.addr or self.pool is None:
                        raise rpc.RpcError(
                            500,
                            f"metanode {self.node_id} got replicated partition "
                            f"{pid} but has no addr/node_pool configured",
                        )
                    from ..parallel import raft as raftlib

                    node = raftlib.RaftNode(
                        f"mp{pid}", self.addr, peers, mp.apply, self.pool,
                        data_dir=os.path.join(self.data_dir, f"mp_{pid}_raft")
                        if self.data_dir else None,
                        snapshot_fn=mp.state_bytes,
                        restore_fn=mp.restore_state,
                    )
                    raftlib.register_routes(self.extra_routes, node)
                    if self._native_h is not None:
                        # serving flag flips synchronously with every
                        # role transition — the native plane redirects
                        # (421 leader=...) exactly when Python would
                        lib, h = self._native_lib, self._native_h

                        def _on_role(role, leader, _pid=pid):
                            lib.ms_set_serving(
                                h, _pid, 1 if role == "leader" else 0,
                                (leader or "").encode())

                        node.role_listener = _on_role
                    self.rafts[pid] = node.start()
            return self.partitions[pid]

    def _mp(self, pid: int) -> MetaPartition:
        mp = self.partitions.get(pid)
        if mp is None:
            raise rpc.RpcError(404, f"meta partition {pid} not on node {self.node_id}")
        return mp

    def _batcher(self, pid: int) -> _SubmitBatcher:
        with self._lock:
            b = self._batchers.get(pid)
            if b is None:
                b = self._batchers[pid] = _SubmitBatcher(self, pid)
            return b

    def _mp_leader(self, pid: int) -> MetaPartition:
        """Leader-routed access: replicated partitions serve reads and
        ino allocation from the raft leader only (followers apply
        asynchronously; serving them would allow stale reads right after
        a committed write)."""
        mp = self._mp(pid)
        node = self.rafts.get(pid)
        if node is not None:
            st = node.status()
            if st["role"] != "leader":
                raise rpc.RpcError(self.REDIRECT, f"leader={st['leader'] or ''}")
        return mp

    def _range_gate(self, pid: int, inos) -> None:
        """Donor-side routing fence for live range migration: every
        mutation door (rpc_submit / rpc_submit_batch / rpc_alloc_ino —
        lint CFE002 pins this reachability) bounces ops aimed at a
        frozen or handed-off sub-range with the 453 range-moved code and
        a "pid=<target>" message the sdk follows. Fast path: partitions
        with no migration in flight pay one falsy check."""
        mp = self.partitions.get(pid)
        if mp is None or not (mp.frozen or mp.moved):
            return
        for ino in inos:
            if isinstance(ino, int):
                t = mp.range_target(ino)
                if t is not None:
                    metrics.meta_range_redirects.inc()
                    raise rpc.RpcError(rpc.RANGE_MOVED, f"pid={t}")

    def _range_gate_read(self, pid: int, inos) -> None:
        """Read-side fence: a frozen range still serves reads from the
        donor (its copy is current while mutations are fenced), but a
        MOVED range must redirect — answering ENOENT from dropped trees
        would lie to a client holding a pre-split partition map."""
        mp = self.partitions.get(pid)
        if mp is None or not mp.moved:
            return
        for ino in inos:
            if isinstance(ino, int):
                t = mp.range_moved_target(ino)
                if t is not None:
                    metrics.meta_range_redirects.inc()
                    raise rpc.RpcError(rpc.RANGE_MOVED, f"pid={t}")

    def stop(self) -> None:
        self._stop.set()
        for r in self.rafts.values():
            r.stop()
        with self._lock:
            wires, self._wires = dict(self._wires), {}
        for wc in wires.values():
            try:
                wc.close()
            except Exception:
                pass
        if self._native_h is not None:
            # stop the listener + connections; the store handle is NOT
            # destroyed — partitions still hold mirror references, and a
            # post-stop apply must never write into freed memory
            self._native_lib.ms_stop(self._native_h)

    # ---------------- transaction resolution (the TM scan) --------------
    def _submit_local(self, pid: int, record: dict):
        """Push a record through the partition's commit door (raft if
        replicated, direct submit otherwise)."""
        record.setdefault("ts", time.time())  # proposer-side stamp
        raft_node = self.rafts.get(pid)
        if raft_node is None:
            return self._mp(pid).submit(record)
        return raft_node.propose(record)

    def _coord_status(self, coord: dict, tx_id: str) -> str:
        """Ask the coordinator partition whether tx_id committed.
        Returns committed|pending|unknown; "pending" (= keep waiting) on
        any doubt, so an unreachable coordinator never causes a
        unilateral rollback of a possibly-committed tx."""
        pid = coord["pid"]
        local = self.partitions.get(pid)
        if local is not None:
            node = self.rafts.get(pid)
            if node is None or node.status()["role"] == "leader":
                return local.tx_status(tx_id)
        if self.pool is None:
            return "pending"
        try:
            meta, _ = rpc.call_replicas(
                self.pool, list(coord.get("addrs") or []), "tx_status",
                {"pid": pid, "tx_id": tx_id}, timeout=2.0, deadline=4.0)
            return meta["status"]
        except Exception:
            return "pending"

    def _resolve_expired_txs(self) -> None:
        for pid, mp in list(self.partitions.items()):
            node = self.rafts.get(pid)
            if node is not None and node.status()["role"] != "leader":
                continue
            for tx_id, tx in mp.expired_txs():
                coord = tx.get("coord")
                if coord and coord.get("pid") != pid:
                    st = self._coord_status(coord, tx_id)
                    if st == "pending":
                        continue  # coordinator undecided: keep waiting
                    op = "tx_commit" if st == "committed" else "tx_abort"
                else:
                    # we ARE the coordinator and the client never decided
                    # within the TTL: abort (participants will follow)
                    op = "tx_abort"
                try:
                    self._submit_local(pid, {
                        "op": op, "tx_id": tx_id, "ts": time.time(),
                        "op_id": f"txres-{tx_id}-{op}",
                    })
                except Exception:
                    pass  # retried on the next scan

    def _push_committed_txs(self) -> None:
        """Coordinator side: push the commit decision to any participant
        still pending, and drop the commit record (tx_finish) once every
        participant has provably resolved — the presumed-abort hazard of
        a TTL-based GC never arises."""
        for pid, mp in list(self.partitions.items()):
            node = self.rafts.get(pid)
            if node is not None and node.status()["role"] != "leader":
                continue
            with mp._lock:
                items = [(tx_id, dict(rec))
                         for tx_id, rec in mp.tx_committed.items()
                         if rec.get("parts")]
            for tx_id, rec in items:
                all_resolved = True
                for part in rec["parts"]:
                    st = self._participant_status(part, tx_id)
                    if st == "pending":
                        all_resolved = self._push_commit(part, tx_id) and all_resolved
                    elif st is None:  # unreachable: keep the record
                        all_resolved = False
                if all_resolved:
                    try:
                        self._submit_local(pid, {
                            "op": "tx_finish", "tx_id": tx_id,
                            "op_id": f"txfin-{tx_id}",
                        })
                    except Exception:
                        pass

    def _participant_status(self, part: dict, tx_id: str) -> str | None:
        local = self.partitions.get(part["pid"])
        if local is not None:
            node = self.rafts.get(part["pid"])
            if node is None or node.status()["role"] == "leader":
                return local.tx_status(tx_id)
        if self.pool is None:
            return None
        try:
            meta, _ = rpc.call_replicas(
                self.pool, list(part.get("addrs") or []), "tx_status",
                {"pid": part["pid"], "tx_id": tx_id}, timeout=2.0,
                deadline=4.0)
            return meta["status"]
        except Exception:
            return None

    def _push_commit(self, part: dict, tx_id: str) -> bool:
        record = {"op": "tx_commit", "tx_id": tx_id, "ts": time.time(),
                  "op_id": f"txpush-{tx_id}"}
        local = self.partitions.get(part["pid"])
        if local is not None:
            node = self.rafts.get(part["pid"])
            if node is None or node.status()["role"] == "leader":
                try:
                    self._submit_local(part["pid"], record)
                    return True
                except Exception:
                    return False
        if self.pool is None:
            return False
        try:
            rpc.call_replicas(
                self.pool, list(part.get("addrs") or []), "submit",
                {"pid": part["pid"], "record": record}, timeout=5.0,
                deadline=6.0)
            return True
        except Exception:
            return False

    def _tx_scan_loop(self) -> None:
        while not self._stop.wait(self.TX_SCAN_INTERVAL):
            try:
                self._resolve_expired_txs()
                self._push_committed_txs()
            except Exception:
                pass
            try:
                self._free_scan()
            except Exception:
                pass

    # ---------------- deferred extent deletion (the free scan) ----------
    # partition_free_list.go analog: the leader of each partition walks
    # its freelist, deletes the extents from every replica of their data
    # partitions, and retires the entry through the commit door (so all
    # replicas drop it). Failures leave the entry for the next sweep —
    # that IS the retry policy; a datanode that stays down parks the
    # entry until the master rebuilds/decommissions the partition.
    def set_dp_view(self, fn) -> None:
        """fn: () -> {dp_id: {"dp_id", "replicas": [...]}}. Deployments
        wire this to the master's client_view; tests inject a direct
        map. Without it the scan is inert (standalone metanodes)."""
        self.dp_view_fn = fn

    def _free_scan(self) -> None:
        view = None
        for pid in list(self.partitions):
            mp = self.partitions.get(pid)
            if mp is None:
                continue
            node = self.rafts.get(pid)
            if node is not None and node.status()["role"] != "leader":
                continue
            entries = mp.freelist_entries()
            if not entries:
                continue
            if view is None:
                fn = getattr(self, "dp_view_fn", None)
                if fn is None:
                    return
                view = fn() or {}
            for key, ent in entries:
                if self._stop.is_set():
                    return
                done = True
                seen: set[tuple[int, int]] = set()
                for ek in ent["extents"]:
                    ekey = (ek["dp_id"], ek["extent_id"])
                    if ekey in seen:
                        continue
                    seen.add(ekey)
                    dp = view.get(ek["dp_id"])
                    if dp is None:
                        done = False  # dp not in view (rebuild in flight)
                        continue
                    for addr in dp["replicas"]:
                        try:
                            self.pool.get(addr).call(
                                "delete_extent",
                                {"dp_id": ek["dp_id"],
                                 "extent_id": ek["extent_id"]},
                                timeout=10.0)
                        except Exception:
                            done = False  # replica down: retry next sweep
                if done:
                    try:
                        self._submit_local(
                            pid, {"op": "free_done", "key": key,
                                  "op_id": uuid.uuid4().hex})
                    except Exception:
                        pass  # resubmitted next sweep (idempotent pop)

    # ---------------- RPC surface ----------------
    def rpc_create_partition(self, args, body):
        self.create_partition(args["pid"], args["start"], args["end"],
                              args.get("peers"))
        return {}

    def rpc_submit(self, args, body):
        pid = args["pid"]
        raft_node = self.rafts.get(pid)
        # ts is stamped at THIS door — before the record enters raft —
        # so every replica (and every WAL replay) applies the same
        # timestamp; apply handlers never read the clock (CFM001)
        args["record"].setdefault("ts", time.time())
        self._range_gate(pid, _record_inos(args["record"]))
        try:
            self._mp(pid).check_limits(args["record"])
            if raft_node is None:
                res = self._mp(pid).submit(args["record"])
            else:
                from ..parallel.raft import NotLeaderError

                try:
                    # submit-plane group commit: while one propose is in
                    # flight, concurrent mutations for this partition
                    # coalesce into ONE __batch__ raft entry — one
                    # replication round carries them all, and the raft
                    # batcher amortizes lock/WAL/fsync underneath.
                    # CUBEFS_META_COALESCE=0 keeps per-op proposes (A/B)
                    if self._coalesce:
                        res = self._batcher(pid).submit(args["record"])
                    else:
                        res = raft_node.propose(args["record"])
                except NotLeaderError as e:
                    raise rpc.RpcError(self.REDIRECT,
                                       f"leader={e.leader or ''}") from None
        except MetaError as e:
            raise _rpc_err(e) from None
        return {"result": res}

    def rpc_submit_batch(self, args, body):
        """Server half of the client-side cross-partition fan-out: one
        RPC lands a whole batch of mutations for ONE partition as a
        single __batch__ raft entry — the batch was already coalesced
        client-side, so re-splitting it through per-record batcher
        waiters would only add N events per call; one propose carries
        the lot (and the raft proposal batcher still merges it with any
        concurrent rpc_submit traffic into one WAL write/replication
        round). Per-record outcomes fan back as [result, null] | [null,
        [code, msg]] — a per-record MetaError fails exactly that
        record, while batch-level outcomes (leader redirect, partition
        gone) fail the call so client-side retry/redirect covers every
        record at once. Records carry their own op_ids: a retried batch
        replays cached results instead of re-applying."""
        pid = args["pid"]
        records = list(args["records"])
        now = time.time()  # one proposer-side stamp for the whole batch
        for rec in records:
            rec.setdefault("ts", now)
        # batch-level range fence: a single 453 fails the whole call and
        # the client fan-out re-routes record by record (same contract
        # as the leader redirect below)
        for rec in records:
            self._range_gate(pid, _record_inos(rec))
        raft_node = self.rafts.get(pid)
        mp = self._mp(pid)
        outs: list = [None] * len(records)
        todo: list[tuple[int, dict]] = []
        for i, rec in enumerate(records):
            try:
                mp.check_limits(rec)
            except MetaError as e:
                outs[i] = [None, [e.code, str(e)]]
                continue
            todo.append((i, rec))
        if todo:
            from ..parallel.raft import NotLeaderError
            from ..utils import metrics

            try:
                if raft_node is None:
                    for i, rec in todo:
                        try:
                            outs[i] = [mp.submit(rec), None]
                        except MetaError as e:
                            outs[i] = [None, [e.code, str(e)]]
                elif len(todo) == 1:
                    i, rec = todo[0]
                    try:
                        outs[i] = [raft_node.propose(rec), None]
                    except MetaError as e:
                        outs[i] = [None, [e.code, str(e)]]
                else:
                    landed = raft_node.propose(
                        {"op": "__batch__",
                         "records": [rec for _, rec in todo]})
                    metrics.meta_batch_entries.inc(pid=pid)
                    metrics.meta_batched_ops.inc(len(todo), pid=pid)
                    for (i, _), out in zip(todo, landed):
                        outs[i] = out
            except NotLeaderError as e:
                raise rpc.RpcError(self.REDIRECT,
                                   f"leader={e.leader or ''}") from None
        return {"results": outs}

    def rpc_alloc_ino(self, args, body):
        mp = self._mp_leader(args["pid"])
        # advisory redirect when the cursor sits in a migrating range —
        # routes fresh creates straight at the target; the deterministic
        # errno-28 fence inside alloc_ino stays authoritative
        self._range_gate(args["pid"], (mp._next_ino,))
        try:
            return {"ino": mp.alloc_ino(op_id=args.get("op_id"))}
        except MetaError as e:
            raise _rpc_err(e) from None

    def _local_leader_for_ino(self, ino: int):
        """The partition owning `ino` IF hosted here and leader-served;
        None otherwise (the walk hands back to the client)."""
        with self._lock:
            for pid, mp in self.partitions.items():
                if mp.start <= ino < mp.end:
                    node = self.rafts.get(pid)
                    if node is not None and \
                            node.status()["role"] != "leader":
                        return None
                    return mp
        return None

    def _walk_owner(self, pid, ino: int):
        """The partition a walk step reads ``ino`` from. With ``pid`` (the
        partition the client's view routed the walk to), that one alone
        while ``ino`` lies in its range: every volume's first partition
        starts at inode 1, so on a node hosting two volumes a range names
        no partition. Without it, the reference's search by range."""
        if pid is None:
            return self._local_leader_for_ino(ino)
        with self._lock:
            mp = self.partitions.get(pid)
            if mp is None or not mp.start <= ino < mp.end:
                return None
            node = self.rafts.get(pid)
            if node is not None and node.status()["role"] != "leader":
                return None
            return mp

    def rpc_walk(self, args, body):
        """Server-side path walk (the round-trip killer behind
        stat/resolve: one request replaces one lookup per component).
        Consumes `names` from `ino` while this node leader-serves the
        partition the client routed it to (``pid``); returns the final
        ino (+ inode when `stat` and locally owned) or a partial {ino,
        remaining} the client resumes elsewhere — the cross-partition
        contract of distributed path walking."""
        ino = args["ino"]
        names = list(args["names"])
        pid = args.get("pid")
        try:
            while names:
                mp = self._walk_owner(pid, ino)
                if mp is None or mp.range_moved_target(ino) is not None:
                    # a moved range hands back a partial: the client
                    # resumes via its (refreshed) partition map instead
                    # of walking a dropped tree
                    break
                ino = mp.lookup(ino, names[0])
                names.pop(0)
            out = {"ino": ino, "remaining": names}
            if not names and args.get("stat"):
                mp = self._walk_owner(pid, ino)
                if mp is not None:
                    out["inode"] = mp.inode_get(ino)
            return out
        except MetaError as e:
            raise _rpc_err(e) from None


    def rpc_inode_get(self, args, body):
        self._range_gate_read(args["pid"], (args["ino"],))
        try:
            return {"inode": self._mp_leader(args["pid"]).inode_get(args["ino"])}
        except MetaError as e:
            raise _rpc_err(e) from None

    def rpc_lookup(self, args, body):
        self._range_gate_read(args["pid"], (args["parent"],))
        try:
            return {"ino": self._mp_leader(args["pid"]).lookup(args["parent"], args["name"])}
        except MetaError as e:
            raise _rpc_err(e) from None

    def rpc_readdir(self, args, body):
        self._range_gate_read(args["pid"], (args["parent"],))
        try:
            return {"entries": self._mp_leader(args["pid"]).readdir(args["parent"])}
        except MetaError as e:
            raise _rpc_err(e) from None

    def rpc_dentry_count(self, args, body):
        self._range_gate_read(args["pid"], (args["parent"],))
        return {"count": self._mp_leader(args["pid"]).dentry_count(args["parent"])}

    def rpc_tx_status(self, args, body):
        return {"status": self._mp_leader(args["pid"]).tx_status(args["tx_id"])}

    def rpc_usage_report(self, args, body):
        return self._mp_leader(args["pid"]).usage_report()

    def rpc_freelist(self, args, body):
        """Pending deferred deletions (fsck reads this so
        freed-but-not-yet-deleted extents don't count as orphans)."""
        mp = self._mp_leader(args["pid"])
        with mp._lock:
            return {"freelist": {k: v for k, v in mp.freelist.items()}}

    def rpc_blob_freelist(self, args, body):
        """Pending deferred blob deletions (the tiering orphan reaper
        drains this; fsck counts these as referenced, not leaked)."""
        mp = self._mp_leader(args["pid"])
        with mp._lock:
            return {"blob_freelist":
                    {k: v for k, v in mp.blob_freelist.items()}}

    def rpc_list_inos(self, args, body):
        """All inode ids held by the partition (fsck's orphan-inode pass
        compares these against the dentry-reachable set)."""
        mp = self._mp_leader(args["pid"])
        with mp._lock:
            return {"inos": sorted(mp.inodes)}

    def rpc_stat(self, args, body):
        """Node-level stats (console/CLI): partitions, raft roles, and
        the native read plane's serve counter."""
        with self._lock:
            parts = {pid: {"start": mp.start, "end": mp.end,
                           "role": (self.rafts[pid].status()["role"]
                                    if pid in self.rafts else "standalone")}
                     for pid, mp in self.partitions.items()}
        native_ops = (self._native_lib.ms_op_count(self._native_h)
                      if self._native_h is not None else 0)
        return {"node_id": self.node_id, "partitions": parts,
                "native_read_ops": native_ops,
                "native_read_addr": self.native_addr}

    def rpc_mp_fill(self, args, body):
        mp = self._mp_leader(args["pid"])
        with mp._lock:
            return {"next_ino": mp._next_ino, "start": mp.start,
                    "end": mp.end}

    def rpc_mp_digest(self, args, body):
        """This replica's own state digest, on any role (never leader-
        routed): sha256 of the partition's serialized FSM state, the
        digest the reference's split tests compare across replicas, with
        the apply id it reflects. The port's addition: it lets a caller
        outside the process hold a partition's replicas equal."""
        mp = self._mp(args["pid"])
        with mp._lock:
            blob = json.dumps(mp._state_dict(), sort_keys=True, default=str)
            aid = mp.apply_id
        return {"digest": hashlib.sha256(blob.encode()).hexdigest(), "apply_id": aid}

    def rpc_drop_partition(self, args, body):
        """Remove a partition (failed-split rollback): stops its raft
        member and forgets the in-RAM trees."""
        with self._lock:
            pid = args["pid"]
            raft_node = self.rafts.pop(pid, None)
            if raft_node is not None:
                raft_node.stop()
            self.partitions.pop(pid, None)
            if self.data_dir:
                try:  # dropped pids never come back: retire the bounds
                    os.remove(os.path.join(self.data_dir,
                                           f"mp_{pid}.range.json"))
                except OSError:
                    pass
            if self._native_h is not None:
                self._native_lib.ms_drop_partition(self._native_h, pid)
        return {}

    def rpc_set_enforcement(self, args, body):
        # advisory flags from the master's quota sweep; pushed to every
        # replica so the gate survives leader changes
        mp = self._mp(args["pid"])
        with mp._lock:
            mp.enforce = {"vol_full": bool(args.get("vol_full")),
                          "exceeded": set(args.get("exceeded") or [])}
        return {}

    def rpc_snapshot(self, args, body):
        self._mp(args["pid"]).snapshot()
        return {}

    def rpc_export_state(self, args, body):
        """Point-in-time FSM state for the snapshot tool (leader-routed,
        CRC'd so transit corruption is detected). apply_id comes out of
        the serialized state itself, so it always matches the payload."""
        mp = self._mp_leader(args["pid"])
        state, apply_id = mp.export_state()
        return {"crc": zlib.crc32(state), "apply_id": apply_id}, state

    # ---------------- live range migration rpcs (fs/split.py) ----------
    def _propose_door(self, pid: int, record: dict):
        """Range-migration commit door: push one migration apply through
        the partition's normal replication path, mapping raft/Meta
        errors exactly like rpc_submit."""
        from ..parallel.raft import NotLeaderError

        try:
            return self._submit_local(pid, record)
        except NotLeaderError as e:
            raise rpc.RpcError(self.REDIRECT,
                               f"leader={e.leader or ''}") from None
        except MetaError as e:
            raise _rpc_err(e) from None

    def _wire(self, addr: str):
        with self._lock:
            wc = self._wires.get(addr)
            if wc is None:
                from ..sdk.clients import WireClient

                wc = WireClient(addr)
                self._wires[addr] = wc
            return wc

    def rpc_range_export(self, args, body):
        """Donor leader: scoped [lo, hi) snapshot + delta-tap
        registration in one locked capture. The payload is CRC-framed
        per record AND summarized by a whole-payload CRC in the meta;
        over the packet plane it rides FLAG_MORE chunk trains."""
        mp = self._mp_leader(args["pid"])
        try:
            payload, aid = mp.range_export(
                args["lo"], args["hi"], args["split_id"])
        except MetaError as e:
            raise _rpc_err(e) from None
        return {"crc": zlib.crc32(payload), "apply_id": aid}, payload

    def rpc_range_fetch(self, args, body):
        """Target-side bootstrap (the geo `_pull_snapshot` idiom): pull
        the donor leader's range snapshot over the packet mux — HTTP
        fallback when no packet addr is known — verify both CRC layers,
        then propose range_load through THIS partition's own commit door
        so every replica loads identical bytes."""
        from ..utils import fsm as fsmlib
        from ..utils import packet

        pid, lo, hi = args["pid"], args["lo"], args["hi"]
        sid = args["split_id"]
        donor = args["donor"]
        meta = payload = None
        last: Exception | None = None
        for addr in donor.get("addrs") or [None]:
            pk = (donor.get("packet_addrs") or {}).get(addr)
            try:
                if pk:
                    # the mux hands back a memoryview over its receive
                    # buffer — materialize before the buffer recycles
                    meta, payload = self._wire(pk).call(
                        packet.OP_META_RANGE_EXPORT,
                        args={"pid": donor["pid"], "lo": lo, "hi": hi,
                              "split_id": sid})
                    payload = bytes(payload)
                elif addr and self.pool is not None:
                    meta, payload = self.pool.get(addr).call(
                        "range_export",
                        {"pid": donor["pid"], "lo": lo, "hi": hi,
                         "split_id": sid}, timeout=30.0)
                else:
                    continue
                break
            except Exception as e:  # noqa: BLE001 - try the next replica
                last = e
                meta = payload = None
        if meta is None:
            raise rpc.RpcError(
                503, f"range export from donor mp {donor.get('pid')} "
                     f"failed: {last}")
        if zlib.crc32(payload) != meta["crc"]:
            raise rpc.RpcError(
                502, f"range snapshot crc mismatch for split {sid}")
        recs = fsmlib.parse_records(payload)
        state = {"inodes": {}, "dentries": {}, "freelist": {},
                 "blob_freelist": {}, "next_ino": 0}
        for rec in recs:
            k = rec.get("k")
            if k == "head":
                state["next_ino"] = rec.get("next_ino", 0)
            elif k == "inode":
                state["inodes"][str(rec["v"]["ino"])] = rec["v"]
            elif k == "dent":
                state["dentries"][str(rec["parent"])] = rec["entries"]
            elif k == "free":
                state["freelist"][rec["key"]] = rec["v"]
            elif k == "bfree":
                state["blob_freelist"][rec["key"]] = rec["v"]
        self._propose_door(pid, {
            "op": "range_load", "lo": lo, "hi": hi, "state": state,
            "op_id": f"rload-{sid}"})
        return {"inodes": len(state["inodes"]),
                "donor_apply_id": meta["apply_id"]}

    def rpc_range_freeze(self, args, body):
        """Donor leader: fence the migrating sub-range (a replicated
        apply — survives restarts and leader changes) and drain the
        delta tap closed by it. The tap-presence check runs FIRST: a
        leadership change since range_export lost the tap, and freezing
        without it would strand the delta — the engine aborts instead."""
        pid, sid = args["pid"], args["split_id"]
        mp = self._mp_leader(pid)
        if sid not in mp._range_taps:
            raise rpc.RpcError(
                409, f"no delta tap for split {sid} on mp {pid} "
                     f"(donor leadership moved since export?)")
        self._propose_door(pid, {
            "op": "range_freeze", "lo": args["lo"], "hi": args["hi"],
            "target_pid": args["target_pid"], "split_id": sid,
            "op_id": f"rfreeze-{sid}"})
        delta, poisoned = mp.range_drain(sid)
        return {"delta": delta, "poisoned": poisoned}

    def rpc_range_thaw(self, args, body):
        """Abort path: unfreeze the donor sub-range (idempotent)."""
        self._propose_door(args["pid"], {
            "op": "range_thaw", "split_id": args["split_id"],
            "op_id": f"rthaw-{args['split_id']}"})
        return {}

    def rpc_range_replay(self, args, body):
        """Target leader: replay the drained delta through the normal
        commit door. Records carry the donor-side op_ids (or synthesized
        "#i/#d/#r" derivatives), so a retried replay dedups instead of
        double-applying; a record that failed identically at donor apply
        time fails identically here."""
        pid = args["pid"]
        applied = failed = 0
        for rec in args.get("records") or []:
            try:
                self._propose_door(pid, dict(rec))
                applied += 1
            except rpc.RpcError as e:
                if 400 <= e.code < 500 and e.code != self.REDIRECT:
                    failed += 1  # deterministic per-record refusal
                else:
                    raise
        return {"applied": applied, "failed": failed}

    def rpc_range_activate(self, args, body):
        """Target leader: claim [lo, hi) — runs only after the delta
        replay, so a reader routed here never sees a stale copy."""
        self._propose_door(args["pid"], {
            "op": "range_activate", "lo": args["lo"], "hi": args["hi"],
            "op_id": f"ractivate-{args['split_id']}"})
        return {}

    def rpc_range_drop(self, args, body):
        """Donor leader: forget the handed-off sub-range and leave the
        moved marker that keeps redirecting stale clients."""
        self._propose_door(args["pid"], {
            "op": "range_drop", "lo": args["lo"], "hi": args["hi"],
            "target_pid": args["target_pid"],
            "op_id": f"rdrop-{args['split_id']}"})
        return {}

    # ---------------- binary packet plane (manager_op.go analog) --------
    # The reference serves EVERY meta op over the 64-byte binary packet
    # protocol (metanode/manager_op.go:300 opCreateInode et al.), not
    # HTTP. The hot SDK ops ride it here: persistent connections kill
    # the per-call HTTP setup+JSON-envelope tax that dominates
    # mdtest-shape workloads. Handlers delegate to the same rpc_*
    # methods, so both transports share one semantics (leader redirect,
    # errno encoding, idempotent submits).
    def serve_packets(self, host: str = "127.0.0.1",
                      port: int = 0, audit=None,
                      workers: int | None = None) -> "packet.PacketServer":
        from ..utils import packet

        def wrap(rpc_method):
            def handler(hdr, args, payload):
                try:
                    out = rpc_method(args, payload)
                except rpc.RpcError as e:
                    # full rpc status (421 leader redirect, 499 errno=..)
                    # rides the reply args — the SDK maps it exactly like
                    # the HTTP transport would
                    raise packet.PacketError(
                        packet.RESULT_RPC, e.message, code=e.code
                    ) from None
                if isinstance(out, tuple):
                    return out
                return out, b""
            return handler

        srv = packet.PacketServer({
            packet.OP_META_LOOKUP: wrap(self.rpc_lookup),
            packet.OP_META_INODE_GET: wrap(self.rpc_inode_get),
            packet.OP_META_READDIR: wrap(self.rpc_readdir),
            packet.OP_META_SUBMIT: wrap(self.rpc_submit),
            packet.OP_META_SUBMIT_BATCH: wrap(self.rpc_submit_batch),
            packet.OP_META_DENTRY_COUNT: wrap(self.rpc_dentry_count),
            packet.OP_META_ALLOC_INO: wrap(self.rpc_alloc_ino),
            packet.OP_META_WALK: wrap(self.rpc_walk),
            packet.OP_META_RANGE_EXPORT: wrap(self.rpc_range_export),
            packet.OP_PING: lambda hdr, a, p: ({}, b""),
        }, host, port, service="metanode", audit=audit, workers=workers)
        return srv.start()
