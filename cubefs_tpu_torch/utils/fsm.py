"""ReplicatedFsm: the shared persistence/replication door for metadata
services.

Both the FS master and the blob clustermgr are state machines with the
same discipline (role parity: the reference backs both with raft +
RocksDB): every mutation is a record through ONE commit door, persisted
to a wal (standalone) or committed through raft (replicated), with
snapshot/restore built from a single serialized-state shape. This mixin
is that door, audited once and used by both.

Host class contract:
  * `_state_dict() -> dict` / `_load_state_dict(dict)` — full FSM state
  * `_apply(record: dict) -> result` — deterministic, takes its own lock
Provided:
  * `_init_fsm(group_id, data_dir, me, peers, node_pool)`
  * `_commit(record)` — wal-append (atomic with apply) or raft-propose;
    raises RpcError(421, "leader=...") on a follower. A record carrying
    an `op_id` is applied at most once: duplicates (transport retries)
    get the first outcome replayed from a bounded cache
  * `_apply_deduped(record)` — the op_id-aware apply door (raft apply
    fn and wal replay both route through it)
  * `is_leader` / `leader_addr` / `_leader_gate`
  * `snapshot()` — standalone wal rotation (raft compacts on its own)

Incremental snapshots (master/metadata_snapshot.go + RocksDB role): a
host that additionally implements the segment contract

  * `_segments_of(record) -> list[str]` — segment ids an op dirties
  * `_segment_state(seg_id) -> json-able | None` — current value
    (None = the segment no longer exists)
  * `_load_segment_state(seg_id, value)` — restore one segment

gets O(dirty) standalone snapshots: applies mark segments dirty, and
`snapshot()` writes only those into a native ordered-KV segment store
(runtime kvstore: its own WAL + compaction bound recovery cost) before
rotating the op WAL. Full-state `_state_dict` remains the raft
InstallSnapshot shape — segmentation is about the LOCAL persistence
path, which is exactly where the reference leans on RocksDB.

The port's copy of ``cubefs_tpu/utils/fsm.py``: a single member keeps
the state file (``snapshot.json``), or for a segmented host the segment
store (``segments/``, the port's ``runtime/kvstore.py``), and the wal
(``wal.jsonl``) under ``data_dir``; a group of more than one peer runs a
``parallel/raft`` node whose directory is ``<data_dir>/raft``. All of
them have the reference's format, so either package opens what the
other wrote. The geo-replication hooks are the reference's: with no tap
and no follower mode set they do nothing.
"""

from __future__ import annotations

import json
import os
import zlib

from . import lockwitness, metrics, rpc


class WalCorruptError(Exception):
    """A WAL record in the MIDDLE of the log failed its CRC/length
    check. Unlike a torn tail (the expected crash artifact — the last
    record never fully hit the platter, so replay truncates it), a bad
    record with VALID records after it means the medium lied: replaying
    past it would silently diverge this replica, so replay refuses.
    Recovery: re-snapshot from a healthy peer (raft hosts get this for
    free via InstallSnapshot; standalone hosts feed a peer's
    `_state_bytes()` to `fsm_recover_from_state`)."""


class SnapshotCorruptError(WalCorruptError):
    """The snapshot file's whole-file digest does not match its payload
    — same refusal/recovery contract as a corrupt-middle WAL record."""


def _frame(payload: str) -> str:
    """One framed WAL line: `!<crc32:08x><len:08x>|<json>`. The CRC is
    over the json payload bytes; the length disambiguates a torn write
    that happens to end on a newline. Legacy bare-JSON lines (pre-CRC
    WALs) still replay."""
    raw = payload.encode()
    return f"!{zlib.crc32(raw):08x}{len(raw):08x}|{payload}\n"


def _parse_frame(line: bytes) -> dict:
    """Decode one WAL line (framed or legacy); raises ValueError on any
    framing/CRC/JSON failure."""
    if line.startswith(b"!"):
        if len(line) < 18 or line[17:18] != b"|":
            raise ValueError("truncated frame header")
        crc = int(line[1:9], 16)
        length = int(line[9:17], 16)
        payload = line[18:]
        if len(payload) != length:
            raise ValueError(
                f"frame length {len(payload)} != header {length}")
        if zlib.crc32(payload) != crc:
            raise ValueError("frame crc mismatch")
        return json.loads(payload)
    return json.loads(line)


def frame_records(records: list[dict]) -> bytes:
    """Serialize a record list into the CRC-framed WAL wire form, one
    `!<crc><len>|<json>` line per record. This is the range-scoped
    snapshot/delta encoding for live metapartition migration
    (fs/split.py): each record is independently checksummed, so a
    corrupt chunk in a shipped range snapshot is detected per record,
    not just by the whole-payload CRC."""
    return "".join(
        _frame(json.dumps(r, sort_keys=True)) for r in records
    ).encode()


def parse_records(data: bytes) -> list[dict]:
    """Decode a `frame_records` payload, verifying every record's CRC.
    Raises ValueError on any framing/CRC/JSON failure — a range
    migration must refuse a torn or corrupt snapshot outright rather
    than load a prefix."""
    out: list[dict] = []
    for line in data.split(b"\n"):
        if line:
            out.append(_parse_frame(line))
    return out


class ReplicatedFsm:
    REDIRECT = 421

    def _init_fsm(self, group_id: str, data_dir: str | None,
                  me: str | None, peers: list[str] | None, node_pool) -> None:
        self._fsm_data_dir = data_dir
        self._wal = None
        # apply+wal-append atomicity
        self._wal_lock = lockwitness.make_lock("ReplicatedFsm._wal_lock")
        # serializes decide+commit: the raft propose (and, in the
        # master's volume create, the planned partition-create RPCs)
        # deliberately runs UNDER it so the duplicate-check stays atomic
        # with the commit — only concurrent proposers queue here, never
        # readers, so the witness's held-across-RPC rule is waived.
        self._propose_lock = lockwitness.make_lock(
            "ReplicatedFsm._propose_lock",
            allow_block="propose serialization spans the commit "
                        "RPC/raft round by design")
        self._fsm_op_cache: dict[str, tuple] = {}  # op_id -> (result, exc)
        self.raft = None
        self.extra_routes: dict = {}
        # geo-replication hooks (utils/georepl.py): the shipper tap is
        # invoked post-apply inside the commit doors; follower mode
        # fences mutations behind GeoRedirect (see _geo_gate)
        self.geo_tap = None
        self._geo_mode: str | None = None
        self.geo_primary: str | None = None
        self._fsm_dirty: set[str] = set()
        self._segmented = hasattr(self, "_segments_of")
        self._seg_store = None
        if peers and len(peers) > 1:
            from ..parallel import raft as raftlib

            if data_dir:
                os.makedirs(data_dir, exist_ok=True)
            self.raft = raftlib.RaftNode(
                group_id, me, peers, self._apply_deduped, node_pool,
                data_dir=os.path.join(data_dir, "raft") if data_dir else None,
                snapshot_fn=self._state_bytes, restore_fn=self._restore_bytes,
            )
            raftlib.register_routes(self.extra_routes, self.raft)
            self.raft.start()
        elif data_dir:
            os.makedirs(data_dir, exist_ok=True)
            self._fsm_load()
            self._wal = open(self._wal_path(), "a")

    # ---------------- roles ----------------
    def is_leader(self) -> bool:
        return self.raft is None or self.raft.status()["role"] == "leader"

    def leader_addr(self) -> str | None:
        return None if self.raft is None else self.raft.status()["leader"]

    def _leader_gate(self) -> None:
        """Replicated mode serves reads and accepts writes on the leader
        only (followers apply asynchronously — serving them would return
        stale maps right after a commit)."""
        if self.raft is not None and not self.is_leader():
            raise rpc.RpcError(self.REDIRECT,
                               f"leader={self.leader_addr() or ''}")

    # ---------------- geo-replication (utils/georepl.py) ----------------
    def _geo_gate(self) -> None:
        """Follower fence: a geo-follower FSM serves reads but bounces
        every mutation to the primary region with GeoRedirect (452,
        "primary=<addr>") — the ONE mutation choke point on this class
        (lint CFG002 pins its presence in the commit doors). Shipped
        records from the primary enter through `geo_apply`, never
        here."""
        if self._geo_mode == "follower":
            metrics.geo_redirects.inc(
                part=getattr(self, "geo_part", ""))
            raise rpc.RpcError(rpc.GEO_REDIRECT,
                               f"primary={self.geo_primary or ''}")

    def geo_set_mode(self, mode: str | None,
                     primary: str | None = None) -> None:
        """Flip this FSM between primary service (None) and geo-follower
        ("follower", mutations fenced to `primary`)."""
        if mode not in (None, "follower"):
            raise ValueError(f"unknown geo mode {mode!r}")
        self._geo_mode = mode
        self.geo_primary = primary

    def geo_apply(self, record: dict):
        """The GeoApplier's sanctioned commit door on a follower FSM
        (lint CFG001): apply + wal-append exactly like the standalone
        `_commit`, but bypassing the follower fence (shipped records ARE
        the primary's already-fenced mutations) and never re-entering
        `geo_tap` (a follower must not echo the stream back at its
        source). Raft-replicated hosts are not geo-apply targets — geo
        replicates cluster-to-cluster, raft replicates within one."""
        if self.raft is not None:
            raise rpc.RpcError(
                500, "geo_apply on a raft-replicated host")
        with self._wal_lock:
            out = self._apply_deduped(dict(record))
            if self._segmented:
                self._fsm_dirty.update(self._segments_of(record))
            if self._wal is not None:
                self._wal.write(_frame(json.dumps(record)))
                self._wal.flush()
        return out

    # ---------------- commit door ----------------
    FSM_OP_CACHE_SIZE = 4096

    def _apply_deduped(self, record: dict):
        """Apply with at-most-once semantics: a record carrying an
        `op_id` is applied once and its outcome (result or error)
        replayed to transport-level retries — the rpc layer re-sends a
        request whose response was lost on a stale connection, and
        id-minting ops (alloc_*, register_disk) must not mint twice.
        The cache is rebuilt from the same record stream on wal/raft
        replay, so replicas and restarts agree. `op_id` is a transport
        concern and is stripped before the host `_apply` sees the
        record.

        A `__batch__` record carries an ordered batch of records
        coalesced into one raft entry (see `_commit_many`): each
        constituent applies in sequence through this same door — per-op
        op_id dedup intact, so batch boundaries are invisible to replay
        and transport retries — and the batch's FSM result is the
        per-op outcome list [[result, None] | [None, [code, msg]]]."""
        if record.get("op") == "__batch__":
            outs = []
            for sub in record["records"]:
                try:
                    outs.append([self._apply_deduped(sub), None])
                except Exception as e:
                    outs.append([None, [getattr(e, "code", 500), str(e)]])
            return outs
        op_id = record.get("op_id")
        if op_id is None:
            return self._apply(record)
        if op_id in self._fsm_op_cache:
            result, exc = self._fsm_op_cache[op_id]
            if exc is not None:
                raise exc
            return result
        rec = {k: v for k, v in record.items() if k != "op_id"}
        try:
            result = self._apply(rec)
        except Exception as e:
            self._fsm_remember(op_id, (None, e))
            raise
        self._fsm_remember(op_id, (result, None))
        return result

    def _fsm_remember(self, op_id: str, outcome: tuple) -> None:
        self._fsm_op_cache[op_id] = outcome
        if len(self._fsm_op_cache) > self.FSM_OP_CACHE_SIZE:
            # drop oldest half (insertion-ordered dict)
            for k in list(self._fsm_op_cache)[: self.FSM_OP_CACHE_SIZE // 2]:
                del self._fsm_op_cache[k]

    def _commit(self, record: dict):
        self._geo_gate()
        if self.raft is None:
            # apply and wal-append must be one atomic step, else
            # concurrent commits can log in a different order than they
            # applied and replay to a different state
            with self._wal_lock:
                out = self._apply_deduped(dict(record))
                if self._segmented:
                    self._fsm_dirty.update(self._segments_of(record))
                if self._wal is not None:
                    self._wal.write(_frame(json.dumps(record)))
                    self._wal.flush()
                if self.geo_tap is not None:
                    # under the wal lock: the shipper's per-partition
                    # sequence must match commit order
                    self.geo_tap(record)
            return out
        from ..parallel.raft import NotLeaderError

        try:
            out = self.raft.propose(record)
        except NotLeaderError as e:
            raise rpc.RpcError(self.REDIRECT,
                               f"leader={e.leader or ''}") from None
        if self.geo_tap is not None:
            self.geo_tap(record)
        return out

    def _commit_many(self, records: list[dict]) -> list:
        """Batch commit door: ONE raft entry (or one wal-lock round in
        standalone mode) carries an ordered batch of records, with
        per-op outcomes [[result, None] | [None, [code, msg]], ...]
        fanned back in order. The wal still records constituents as
        individual lines — a batch entry replays as its constituent
        records, so the replay contract is unchanged."""
        self._geo_gate()
        if self.raft is None:
            with self._wal_lock:
                outs = self._apply_deduped(
                    {"op": "__batch__",
                     "records": [dict(r) for r in records]})
                # only constituents that APPLIED are logged/dirtied —
                # the single-op door's contract: wal replay assumes
                # every record re-applies cleanly
                ok = [r for r, (res, err) in zip(records, outs)
                      if err is None]
                if self._segmented:
                    for r in ok:
                        self._fsm_dirty.update(self._segments_of(r))
                if self._wal is not None and ok:
                    self._wal.write(
                        "".join(_frame(json.dumps(r)) for r in ok))
                    self._wal.flush()
                if self.geo_tap is not None:
                    for r in ok:  # ship applied constituents only
                        self.geo_tap(r)
            return outs
        from ..parallel.raft import NotLeaderError

        try:
            outs = self.raft.propose(
                {"op": "__batch__", "records": list(records)})
        except NotLeaderError as e:
            raise rpc.RpcError(self.REDIRECT,
                               f"leader={e.leader or ''}") from None
        if self.geo_tap is not None:
            for r, (res, err) in zip(records, outs):
                if err is None:
                    self.geo_tap(r)
        return outs

    # ---------------- persistence ----------------
    def _wal_path(self) -> str:
        return os.path.join(self._fsm_data_dir, "wal.jsonl")

    def _snap_path(self) -> str:
        return os.path.join(self._fsm_data_dir, "snapshot.json")

    def _state_bytes(self) -> bytes:
        return json.dumps(self._state_dict()).encode()

    def _restore_bytes(self, data: bytes) -> None:
        self._load_state_dict(json.loads(data))

    def _seg_dir(self) -> str:
        return os.path.join(self._fsm_data_dir, "segments")

    def _open_seg_store(self):
        if self._seg_store is None:
            from ..runtime.kvstore import KvStore

            self._seg_store = KvStore(self._seg_dir())
        return self._seg_store

    def _fsm_load(self) -> None:
        # the legacy full-state file is removed only AFTER a complete
        # migration into the segment store — while it exists it stays
        # authoritative (a crash mid-migration leaves a PARTIAL store)
        if os.path.exists(self._snap_path()):
            self._load_state_dict(self._read_snapshot())
        elif self._segmented and os.path.isdir(self._seg_dir()):
            kv = self._open_seg_store()
            for k, v in kv.scan():
                self._load_segment_state(k.decode(), json.loads(v))
        if os.path.exists(self._wal_path()):
            self._replay_wal()

    def _read_snapshot(self) -> dict:
        doc = json.load(open(self._snap_path()))
        if isinstance(doc, dict) and doc.get("__wal_snap__") == 2:
            # digest-carrying envelope: crc32 over the serialized state
            payload = doc["payload"]
            if zlib.crc32(payload.encode()) != doc["crc"]:
                metrics.integrity_corruptions_detected.inc(
                    plane="wal", source="replay")
                raise SnapshotCorruptError(
                    f"{self._snap_path()}: snapshot digest mismatch")
            return json.loads(payload)
        return doc  # legacy digest-less snapshot

    def _replay_wal(self) -> None:
        """Replay the op WAL with per-record CRC verification. The whole
        file is VALIDATED before anything applies, so a corrupt-middle
        refusal leaves the FSM state untouched for peer recovery."""
        path = self._wal_path()
        with open(path, "rb") as f:
            raw = f.read()
        records: list[dict] = []
        offset = 0
        bad_at: int | None = None  # byte offset of the first bad record
        corrupt_middle = False
        for line in raw.split(b"\n"):
            if line:
                if bad_at is None:
                    try:
                        records.append(_parse_frame(line))
                    except (ValueError, json.JSONDecodeError):
                        bad_at = offset
                else:
                    try:
                        _parse_frame(line)
                    except (ValueError, json.JSONDecodeError):
                        pass  # trailing garbage keeps the tear a tear
                    else:
                        corrupt_middle = True  # valid record AFTER the bad one
                        break
            offset += len(line) + 1
        if corrupt_middle:
            metrics.integrity_corruptions_detected.inc(
                plane="wal", source="replay")
            raise WalCorruptError(
                f"{path}: corrupt record at byte {bad_at} with valid "
                f"records after it — refusing replay (re-snapshot from "
                f"a healthy peer)")
        if bad_at is not None:
            # torn tail: the crash artifact the framing exists to make
            # provably-safe to drop. Truncate so the append stream never
            # concatenates onto half a record.
            with open(path, "r+b") as f:
                f.truncate(bad_at)
            metrics.wal_torn_tail.inc()
        for rec in records:
            self._apply_deduped(rec)
            if self._segmented:
                # replayed ops must re-dirty their segments: the
                # store's copy predates them
                self._fsm_dirty.update(self._segments_of(rec))

    def fsm_recover_from_state(self, data: bytes) -> None:
        """Corrupt-middle recovery door: replace this host's state with
        a healthy peer's `_state_bytes()` (the raft InstallSnapshot
        payload shape), discard the poisoned WAL, and persist a fresh
        digest-carrying snapshot. The op_id cache resets with the state
        — exactly what a raft InstallSnapshot does on a lagging
        follower."""
        with self._wal_lock:
            self._fsm_op_cache.clear()
            self._restore_bytes(data)
            if self._segmented:
                # every segment must land in the store: its current
                # contents predate (or were poisoned alongside) the WAL
                self._fsm_dirty.update(self._all_segments())
            if self._wal is not None:
                self._wal.close()
            open(self._wal_path(), "w").close()
            self._wal = open(self._wal_path(), "a")
        self.snapshot()

    def snapshot(self) -> int:
        """Standalone mode: persist state and rotate the wal (raft mode
        compacts through its own snapshot machinery). Segmented hosts
        write only DIRTY segments — O(touched), not O(state). Returns
        the number of segments written (0 for full-state hosts)."""
        if not self._fsm_data_dir or self.raft is not None:
            return 0
        with self._wal_lock:
            written = 0
            if self._segmented:
                kv = self._open_seg_store()
                if kv.count() == 0 or os.path.exists(self._snap_path()):
                    # first segmented snapshot (fresh store, or
                    # migrating off a legacy full-state file): EVERY
                    # segment must land, or rotating the wal would drop
                    # the untouched remainder
                    self._fsm_dirty.update(self._all_segments())
                for seg in sorted(self._fsm_dirty):
                    val = self._segment_state(seg)
                    if val is None:
                        try:
                            kv.delete(seg.encode())
                        except KeyError:
                            pass
                    else:
                        kv.put(seg.encode(), json.dumps(val).encode())
                    written += 1
                self._fsm_dirty.clear()
                # the op wal only rotates once its effects are durable
                # in the segment store (kv_put fsyncs per mutation)
                if os.path.exists(self._snap_path()):
                    os.remove(self._snap_path())  # legacy file migrated
            else:
                tmp = self._snap_path() + ".tmp"
                payload = json.dumps(self._state_dict())
                with open(tmp, "w") as f:
                    # whole-file digest envelope: a flipped bit anywhere
                    # in the state payload refuses the load instead of
                    # silently restoring corrupt metadata
                    json.dump({"__wal_snap__": 2,
                               "crc": zlib.crc32(payload.encode()),
                               "payload": payload}, f)
                os.replace(tmp, self._snap_path())
            if self._wal is not None:
                self._wal.close()
            open(self._wal_path(), "w").close()
            self._wal = open(self._wal_path(), "a")
            return written

    def fsm_stop(self) -> None:
        if self.raft is not None:
            self.raft.stop()
        if self._seg_store is not None:
            self._seg_store.close()
            self._seg_store = None
