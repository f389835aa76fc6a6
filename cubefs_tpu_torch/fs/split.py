"""Elastic metadata plane: metapartition auto-split/merge with live
inode-range migration (master/meta_partition_manager.go role).

The reference master splits a hot meta partition by APPENDING a fresh
partition for the next inode range (``Master.split_meta_partition``) —
existing inodes stay put, so a partition that went hot stays hot.  This
engine moves the load itself: a fenced three-phase state machine hands
the USED upper half of a hot partition's inode range to a brand-new
partition, live, without stopping writes to the rest of the donor.

Phases (every durable step is an idempotent, op_id-fenced FSM apply —
the PR-12 discipline — so any crash boundary replays clean):

  PREPARE             master commits ``split_prepare``: the split plan
                      and the target pid reservation land in the
                      replicated ``Master.splits`` ledger BEFORE any
                      metanode sees an RPC.  A crash here can neither
                      mint a duplicate pid nor orphan an untracked
                      half-built partition — recovery reads the ledger.
  FROZEN-RANGE-COPIED target partition is created empty; the donor
                      leader streams a CRC-framed range snapshot over
                      the packet mux (FLAG_MORE chunk trains, geo
                      bootstrap idiom) while a leader-local delta tap
                      records every racing mutation; then the donor
                      freezes ONLY the migrating sub-range (replicated
                      apply), the tap drains, and the target replays
                      the delta through its own commit door.  Racing
                      mutations therefore always either win on the
                      donor (tapped + replayed) or bounce with a
                      453/EMOVED routing code the SDK follows to the
                      new owner.  Writes to the REST of the donor's
                      range never stop.
  COMMITTED           master commits the range-table change as ONE
                      ``split_commit`` apply: donor end shrinks, the
                      target row appears, and the volume's
                      ``mp_version`` watermark bumps exactly once —
                      clients re-route atomically on their next view
                      refresh.  The donor then drops the moved trees
                      and keeps a tombstone that redirects stale
                      clients.

Merge is the inverse: a cold partition's range is migrated into its
left-adjacent neighbour with the same machinery, then the donor row is
removed (``merge_commit``) and its raft group is dropped.

The rate-limited balance sweep (the ``sweep_misplaced`` idiom) drives
the ``cubefs_meta_partition_imbalance`` gauge to zero: each call aborts
any in-flight migration left by a crashed leader, then performs at most
``max_moves`` migrations.  The automatic sweep hides behind the
``CUBEFS_META_SPLIT`` door (default OFF — digest-identical to a build
without this file); explicit operator ``split``/``merge`` calls work
regardless of the door.

The port's copy of ``cubefs_tpu/fs/split.py``, with the same
behaviour, on the port's master and metanodes.
"""
from __future__ import annotations

import os

from ..utils import lockwitness, metrics, rpc, slo


def door_open() -> bool:
    """CUBEFS_META_SPLIT gates only the AUTOMATIC balance sweep."""
    return os.environ.get("CUBEFS_META_SPLIT", "0").lower() \
        not in ("0", "", "false", "no")


# a hot meta.write SLO (burn >= 1 means the error budget is being spent
# faster than it accrues) halves the fill threshold: partitions split
# EARLY while the plane is under pressure, late when it is idle
HOT_BURN_RATE = 1.0

# partitions narrower than this never auto-split: each split halves the
# donor's span, so without a floor a persistently-full donor would be
# shaved into confetti by successive sweeps
MIN_SPLIT_SPAN = 4096


class SplitEngine:
    """Master-driven three-phase metapartition migrator.

    Lives on the master leader (``Master.split_engine()``); every
    durable step goes through the master's replicated FSM, so a deposed
    or restarted leader recovers from the ``splits`` ledger alone.
    ``fault_hook`` (tests only) is called at each phase boundary with
    ``(stage, split_id)`` — raising from it abandons the drive exactly
    where a crash would.
    """

    def __init__(self, master):
        self.m = master
        self.fault_hook = None  # tests: fn(stage, split_id) at boundaries
        self._last_imbalance = 0
        # one migration at a time, TRY-acquired: a long-running admin
        # operation must fail fast for contenders, not queue a proposer
        # thread behind seconds of metanode RPCs. Never held inside the
        # master's locks — the drive deliberately spans the phase RPCs.
        self._busy = lockwitness.make_lock(
            "SplitEngine._busy",
            allow_block="migration mutex spans the three-phase drive "
                        "by design; contenders try-acquire and bounce")

    # ---------------- plumbing ----------------
    def _fault(self, stage: str, sid: str) -> None:
        hook = self.fault_hook
        if hook is not None:
            hook(stage, sid)

    def _call(self, addrs: list[str], method: str, args: dict) -> dict:
        """Leader-following call into a metanode replica set."""
        meta, _ = rpc.call_replicas(self.m.nodes, addrs, method, args,
                                    deadline=10.0)
        return meta

    def _packet_addrs(self, addrs: list[str]) -> dict[str, str]:
        with self.m._lock:
            return {a: i["packet_addr"]
                    for a, i in self.m.metanodes.items()
                    if a in addrs and i.get("packet_addr")}

    def _mp_of(self, name: str, pid: int) -> dict:
        from .master import MasterError
        with self.m._lock:
            vol = self.m.volumes.get(name)
            if vol is None:
                raise MasterError(f"no volume {name!r}")
            mp = next((m for m in vol["mps"] if m["pid"] == pid), None)
            if mp is None:
                raise MasterError(f"no mp {pid} in volume {name!r}")
            return dict(mp)

    def _fill(self, mp: dict) -> dict | None:
        """Donor-leader usage report; None when every replica is down."""
        try:
            return self._call(mp.get("addrs") or [mp["addr"]],
                              "mp_fill", {"pid": mp["pid"]})
        except Exception:  # noqa: BLE001 - retried on the next sweep
            return None

    # ---------------- split ----------------
    def split(self, name: str, pid: int | None = None,
              split_ino: int | None = None) -> dict:
        """Split one partition: hand its used upper half to a fresh
        partition, live. Explicit pid/split_ino pin the plan (CLI);
        otherwise the fullest partition splits at the midpoint of its
        USED range."""
        from .master import MasterError
        if not self._busy.acquire(False):
            raise MasterError(
                "a metapartition migration is already in flight")
        try:
            plan = self._plan_split(name, pid, split_ino)
            return self._drive_split(plan)
        finally:
            self._busy.release()

    def _plan_split(self, name: str, pid: int | None,
                    split_ino: int | None) -> dict:
        from .master import MasterError
        m = self.m
        with m._lock:
            vol = m.volumes.get(name)
            if vol is None:
                raise MasterError(f"no volume {name!r}")
            mps = [dict(p) for p in vol["mps"]]
            live = m._live(m.metanodes)
            if not live:
                raise MasterError("no live metanodes")
        if not mps:
            raise MasterError(f"volume {name!r} has no meta partitions")
        if pid is None:
            # fullest USED fraction wins; unreachable partitions skipped
            best = None
            for mp in mps:
                f = self._fill(mp)
                span = mp["end"] - mp["start"]
                if f is None or span <= 0:
                    continue
                frac = (min(f["next_ino"], mp["end"])
                        - mp["start"]) / span
                if best is None or frac > best[0]:
                    best = (frac, mp, f)
            if best is None:
                raise MasterError(f"no reachable mp in volume {name!r}")
            _, donor, fill = best
        else:
            donor = next((p for p in mps if p["pid"] == pid), None)
            if donor is None:
                raise MasterError(f"no mp {pid} in volume {name!r}")
            fill = self._fill(donor)
            if fill is None:
                raise MasterError(f"mp {pid} unreachable")
        start, end = donor["start"], donor["end"]
        # a donor that split before can have its alloc cursor beyond its
        # (shrunk) end — its USED range is its whole remaining range
        used = min(fill["next_ino"], end) - start
        if split_ino is None:
            # midpoint of the USED range, clamped strictly inside it:
            # the donor keeps [start, lo), the target takes [lo, end)
            if used < 2:
                raise MasterError(
                    f"mp {donor['pid']} has only {used} used inodes — "
                    f"nothing to split")
            split_ino = start + used // 2
        if not start < split_ino < end:
            raise MasterError(
                f"split point {split_ino} outside mp {donor['pid']} "
                f"range ({start}, {end})")
        donor_addrs = donor.get("addrs") or [donor["addr"]]
        with m._lock:
            # provisional: names the split id; the ACTUAL target pid is
            # assigned inside the split_prepare apply, serial with every
            # other pid source (a volume create can land between here
            # and the prepare commit)
            tpid = m._next_pid
            meta_load = m._meta_load()
            k = min(m.replicas, len(live))
            # prefer hosts that do NOT hold the donor — the point of a
            # split is spreading load, not doubling it on one box
            cands = [a for a in live if a not in donor_addrs]
            if len(cands) < k:
                cands = live
            addrs = m._select_hosts(m.metanodes, cands, k, meta_load)
        sid = f"sp{tpid}-{name}-{donor['pid']}-{split_ino}"
        return {"split_id": sid, "kind": "split", "name": name,
                "donor_pid": donor["pid"], "donor_addrs": donor_addrs,
                "split_ino": split_ino, "hi": end,
                "target_pids": [tpid], "addrs": addrs}

    def _drive_split(self, plan: dict) -> dict:
        from .master import MasterError
        m = self.m
        sid, name = plan["split_id"], plan["name"]
        lo, hi = plan["split_ino"], plan["hi"]
        addrs, donor_addrs = plan["addrs"], plan["donor_addrs"]
        split = {k: v for k, v in plan.items()
                 if k not in ("name", "donor_addrs")}

        # -- PREPARE: plan + pid reservation land durably first --------
        # the apply assigns the authoritative target pid (and a replayed
        # prepare returns the original assignment via op_id dedup)
        split = m._commit({"op": "split_prepare", "name": name,
                           "split": split, "op_id": f"{sid}#prep"})
        tpid = split["target_pids"][0]
        self._fault("prepared", sid)

        created = []
        try:
            for a in addrs:
                # empty range [lo, lo): range_activate claims [lo, hi)
                # only after the copy + delta replay land. Each replica
                # is addressed directly: the pool's client for an address
                # follows the leader it learned from a partition's 421,
                # which would send this create to another node
                m.nodes.get_direct(a).call(
                    "create_partition",
                    {"pid": tpid, "start": lo, "end": lo, "peers": addrs})
                created.append(a)
        except Exception as e:  # noqa: BLE001 - roll the prepare back
            self._abort(split, name, f"target create failed: {e}",
                        drop_pids=created and [tpid] or [],
                        drop_addrs=created, thaw=False)
            raise MasterError(
                f"split {sid}: target create failed: {e}") from e
        self._fault("created", sid)

        donor_info = {"pid": plan["donor_pid"], "addrs": donor_addrs,
                      "packet_addrs": self._packet_addrs(donor_addrs)}
        try:
            # -- FROZEN-RANGE-COPIED: snapshot, fence, drain, replay ---
            fetched = self._call(addrs, "range_fetch",
                                 {"pid": tpid, "lo": lo, "hi": hi,
                                  "split_id": sid, "donor": donor_info})
            self._fault("copied", sid)
            frozen = self._call(donor_addrs, "range_freeze",
                                {"pid": plan["donor_pid"], "lo": lo,
                                 "hi": hi, "target_pid": tpid,
                                 "split_id": sid})
            if frozen.get("poisoned"):
                raise _Poisoned(frozen["poisoned"])
            replayed = self._call(addrs, "range_replay",
                                  {"pid": tpid, "split_id": sid,
                                   "records": frozen["delta"]})
            self._fault("frozen", sid)
            self._call(addrs, "range_activate",
                       {"pid": tpid, "lo": lo, "hi": hi,
                        "split_id": sid})
            self._fault("activated", sid)
        except _Poisoned as e:
            self._abort(split, name, f"delta tap poisoned: {e}",
                        drop_pids=[tpid], drop_addrs=addrs)
            raise MasterError(
                f"split {sid} aborted: delta tap poisoned ({e}) — "
                f"retry when the racing transaction settles") from None
        except rpc.RpcError as e:
            self._abort(split, name, f"phase rpc failed: {e}",
                        drop_pids=[tpid], drop_addrs=addrs)
            raise MasterError(f"split {sid} failed: {e}") from e

        # -- COMMITTED: ONE apply rewrites the range table -------------
        m._commit({"op": "split_commit", "split_id": sid, "name": name,
                   "op_id": f"{sid}#commit"})
        self._fault("committed", sid)

        # post-commit cleanup is best-effort: a dangling frozen marker
        # on the donor still redirects (453) to the committed owner, so
        # a failed drop costs memory, not correctness
        drop_ok = True
        try:
            self._call(donor_addrs, "range_drop",
                       {"pid": plan["donor_pid"], "lo": lo, "hi": hi,
                        "target_pid": tpid, "split_id": sid})
        except Exception:  # noqa: BLE001
            drop_ok = False
        metrics.meta_range_migrations.inc(kind="split")
        return {"split_id": sid, "donor_pid": plan["donor_pid"],
                "target_pid": tpid, "split_ino": lo, "hi": hi,
                "addrs": addrs, "copied_inodes": fetched.get("inodes"),
                "delta_applied": replayed.get("applied"),
                "delta_failed": replayed.get("failed"),
                "donor_dropped": drop_ok}

    # ---------------- merge ----------------
    def merge(self, name: str, donor_pid: int | None = None,
              absorber_pid: int | None = None) -> dict:
        """Merge a cold partition into its left-adjacent neighbour: the
        same three-phase migration with the absorber as target, then
        ``merge_commit`` removes the donor row and its raft group."""
        from .master import MasterError
        if not self._busy.acquire(False):
            raise MasterError(
                "a metapartition migration is already in flight")
        try:
            plan = self._plan_merge(name, donor_pid, absorber_pid)
            return self._drive_merge(plan)
        finally:
            self._busy.release()

    def _plan_merge(self, name: str, donor_pid: int | None,
                    absorber_pid: int | None) -> dict:
        from .master import MasterError
        with self.m._lock:
            vol = self.m.volumes.get(name)
            if vol is None:
                raise MasterError(f"no volume {name!r}")
            mps = sorted((dict(p) for p in vol["mps"]),
                         key=lambda p: p["start"])
        if len(mps) < 2:
            raise MasterError(f"volume {name!r} has nothing to merge")
        if donor_pid is None:
            cand = self._merge_candidates(mps)
            if not cand:
                raise MasterError(
                    f"no cold mergeable partition in {name!r}")
            donor_pid, absorber_pid = cand[0]
        donor = next((p for p in mps if p["pid"] == donor_pid), None)
        if donor is None:
            raise MasterError(f"no mp {donor_pid} in volume {name!r}")
        if absorber_pid is None:
            left = next((p for p in mps if p["end"] == donor["start"]),
                        None)
            if left is None:
                raise MasterError(
                    f"mp {donor_pid} has no left-adjacent absorber")
            absorber_pid = left["pid"]
        absorber = next((p for p in mps if p["pid"] == absorber_pid),
                        None)
        if absorber is None or absorber["end"] != donor["start"]:
            raise MasterError(
                f"mp {absorber_pid} is not left-adjacent to mp "
                f"{donor_pid} — merge needs absorber.end == donor.start")
        sid = f"mg{donor_pid}-{name}-{absorber_pid}"
        return {"split_id": sid, "kind": "merge", "name": name,
                "donor_pid": donor_pid,
                "donor_addrs": donor.get("addrs") or [donor["addr"]],
                "absorber_pid": absorber_pid,
                "split_ino": donor["start"], "hi": donor["end"],
                "target_pids": [],
                "addrs": absorber.get("addrs") or [absorber["addr"]]}

    def _drive_merge(self, plan: dict) -> dict:
        from .master import MasterError
        m = self.m
        sid, name = plan["split_id"], plan["name"]
        lo, hi = plan["split_ino"], plan["hi"]
        apid = plan["absorber_pid"]
        addrs, donor_addrs = plan["addrs"], plan["donor_addrs"]
        split = {k: v for k, v in plan.items()
                 if k not in ("name", "donor_addrs")}

        split = m._commit({"op": "split_prepare", "name": name,
                           "split": split, "op_id": f"{sid}#prep"})
        self._fault("prepared", sid)

        donor_info = {"pid": plan["donor_pid"], "addrs": donor_addrs,
                      "packet_addrs": self._packet_addrs(donor_addrs)}
        try:
            fetched = self._call(addrs, "range_fetch",
                                 {"pid": apid, "lo": lo, "hi": hi,
                                  "split_id": sid, "donor": donor_info})
            self._fault("copied", sid)
            frozen = self._call(donor_addrs, "range_freeze",
                                {"pid": plan["donor_pid"], "lo": lo,
                                 "hi": hi, "target_pid": apid,
                                 "split_id": sid})
            if frozen.get("poisoned"):
                raise _Poisoned(frozen["poisoned"])
            replayed = self._call(addrs, "range_replay",
                                  {"pid": apid, "split_id": sid,
                                   "records": frozen["delta"]})
            self._fault("frozen", sid)
            self._call(addrs, "range_activate",
                       {"pid": apid, "lo": lo, "hi": hi,
                        "split_id": sid})
            self._fault("activated", sid)
        except _Poisoned as e:
            self._abort(split, name, f"delta tap poisoned: {e}")
            raise MasterError(
                f"merge {sid} aborted: delta tap poisoned ({e})"
            ) from None
        except rpc.RpcError as e:
            self._abort(split, name, f"phase rpc failed: {e}")
            raise MasterError(f"merge {sid} failed: {e}") from e

        m._commit({"op": "merge_commit", "split_id": sid, "name": name,
                   "op_id": f"{sid}#commit"})
        self._fault("committed", sid)

        # the donor row is gone from the table: retire its raft group
        dropped = 0
        for a in donor_addrs:
            try:
                m.nodes.get_direct(a).call("drop_partition",
                                           {"pid": plan["donor_pid"]})
                dropped += 1
            except Exception:  # noqa: BLE001 - orphan costs memory only
                pass
        metrics.meta_range_migrations.inc(kind="merge")
        return {"split_id": sid, "donor_pid": plan["donor_pid"],
                "absorber_pid": apid, "lo": lo, "hi": hi,
                "copied_inodes": fetched.get("inodes"),
                "delta_applied": replayed.get("applied"),
                "delta_failed": replayed.get("failed"),
                "donor_replicas_dropped": dropped}

    # ---------------- abort / recovery ----------------
    def _abort(self, split: dict, name: str, reason: str,
               drop_pids: list[int] | None = None,
               drop_addrs: list[str] | None = None,
               thaw: bool = True) -> None:
        """Unwind a half-done migration: thaw the donor sub-range, drop
        any target partitions (splits only — a merge's absorber is a
        live partition that just holds a redundant, soon-overwritten
        copy), and retire the ledger entry. Every step is idempotent;
        the ledger commit is the only one that must land."""
        sid = split["split_id"]
        if thaw:
            try:
                self._call(split.get("donor_addrs")
                           or self._mp_addrs(name, split["donor_pid"]),
                           "range_thaw",
                           {"pid": split["donor_pid"], "split_id": sid,
                            "lo": split["split_ino"], "hi": split["hi"]})
            except Exception:  # noqa: BLE001
                pass
        pids = drop_pids if drop_pids is not None \
            else split.get("target_pids", [])
        addrs = drop_addrs if drop_addrs is not None \
            else split.get("addrs", [])
        for tp in pids:
            for a in addrs:
                try:
                    self.m.nodes.get_direct(a).call("drop_partition",
                                                    {"pid": tp})
                except Exception:  # noqa: BLE001
                    pass
        self.m._commit({"op": "split_abort", "split_id": sid,
                        "name": name, "reason": reason,
                        "op_id": f"{sid}#abort-{reason[:24]}"})
        metrics.meta_range_migration_aborts.inc(
            reason=split.get("kind", "split"))

    def _mp_addrs(self, name: str, pid: int) -> list[str]:
        try:
            mp = self._mp_of(name, pid)
            return mp.get("addrs") or [mp["addr"]]
        except Exception:  # noqa: BLE001
            return []

    def recover(self) -> list[str]:
        """Abort every in-flight migration left by a crashed/deposed
        leader. The replicated ledger is the whole truth: anything in
        it did not commit, so the donor thaws, targets drop, and the
        plan retries from scratch on a later sweep."""
        with self.m._lock:
            pending = {sid: dict(s) for sid, s in self.m.splits.items()}
        for sid, s in pending.items():
            self._abort(s, s.get("name", ""), "leader recovery")
        return sorted(pending)

    # ---------------- detection / balance sweep ----------------
    def _merge_candidates(self, mps: list[dict]) -> list[tuple[int, int]]:
        """(donor_pid, absorber_pid) pairs: a donor that never allocated
        an inode merges left. Conservative on purpose — empty is the
        one coldness signal that cannot misfire under sampling."""
        out = []
        for left, right in zip(mps, mps[1:]):
            if left["end"] != right["start"]:
                continue
            f = self._fill(right)
            if f is not None and f["next_ino"] == right["start"]:
                out.append((right["pid"], left["pid"]))
        return out

    def detect(self) -> list[dict]:
        """Scan every volume for actionable imbalance and publish the
        ``cubefs_meta_partition_imbalance`` gauge (0 == balanced)."""
        m = self.m
        with m._lock:
            vols = {n: sorted((dict(p) for p in v["mps"]),
                              key=lambda p: p["start"])
                    for n, v in m.volumes.items()}
        burn = (slo.DEFAULT_TRACKER.snapshot()
                .get("meta.write", {}).get("burn_rate", 0.0))
        threshold = m.MP_SPLIT_THRESHOLD
        if burn >= HOT_BURN_RATE:
            # the write plane is burning SLO budget: split sooner
            threshold /= 2
        actions = []
        for name, mps in vols.items():
            for mp in mps:
                span = mp["end"] - mp["start"]
                f = self._fill(mp)
                if f is None or span < MIN_SPLIT_SPAN:
                    continue
                frac = (min(f["next_ino"], mp["end"])
                        - mp["start"]) / span
                if frac >= threshold:
                    actions.append({"kind": "split", "name": name,
                                    "pid": mp["pid"],
                                    "fill": round(frac, 4)})
            for donor_pid, absorber_pid in self._merge_candidates(mps):
                actions.append({"kind": "merge", "name": name,
                                "pid": donor_pid,
                                "absorber_pid": absorber_pid})
        self._last_imbalance = len(actions)
        metrics.meta_partition_imbalance.set(len(actions))
        return actions

    def balance(self, max_moves: int = 1, auto: bool = False) -> dict:
        """Rate-limited sweep (the ``sweep_misplaced`` idiom): recover
        abandoned migrations, then perform at most ``max_moves`` of the
        detected actions. ``auto=True`` is the periodic/automatic entry
        and respects the CUBEFS_META_SPLIT door; operator calls do not."""
        if auto and not door_open():
            return {"skipped": "CUBEFS_META_SPLIT door is off",
                    "actions": [], "imbalance": self._last_imbalance}
        recovered = self.recover()
        work = self.detect()
        done, failed = [], []
        for act in work[:max(0, int(max_moves))]:
            try:
                if act["kind"] == "split":
                    res = self.split(act["name"], pid=act["pid"])
                else:
                    res = self.merge(act["name"], donor_pid=act["pid"],
                                     absorber_pid=act["absorber_pid"])
                done.append(dict(act, result=res))
            except Exception as e:  # noqa: BLE001 - sweep must not die
                failed.append(dict(act, error=str(e)))
        remaining = len(work) - len(done)
        self._last_imbalance = remaining
        metrics.meta_partition_imbalance.set(remaining)
        return {"actions": done, "failed": failed,
                "recovered": recovered, "imbalance": remaining}

    def status(self, name: str | None = None) -> dict:
        """Operator view: in-flight ledger + range table + door state."""
        with self.m._lock:
            splits = {sid: dict(s) for sid, s in self.m.splits.items()
                      if name is None or s.get("name") == name}
            vols = {n: {"mp_version": v.get("mp_version", 0),
                        "mps": [{"pid": p["pid"], "start": p["start"],
                                 "end": p["end"]}
                                for p in sorted(v["mps"],
                                                key=lambda p: p["start"])]}
                    for n, v in self.m.volumes.items()
                    if name is None or n == name}
        return {"door": door_open(), "in_flight": splits,
                "volumes": vols, "imbalance": self._last_imbalance}


class _Poisoned(Exception):
    """Delta tap overflowed or saw an un-normalizable record (straddling
    rename, range-touching transaction): the snapshot+delta pair no
    longer reconstructs the donor state, so the migration must abort."""
