"""fs-plane continuous scrubber + the ONE sanctioned extent healer.

Role parity: datanode's CRC scrub loop — every extent any inode
references gets its replica CRC fingerprints compared on a rolling
cursor (reusing fsck's walk primitives for the work list), and a
divergent replica is rewritten in place through
``DataNode.sync_extent_from`` — the same executor the client-side
read-repair and ``fsck --heal`` use, so there is exactly one code path
that ever rewrites an extent copy ("one sanctioned healer, not two").

Heal decision: majority vote over the replicas' ``(size, crc)``
fingerprints, leader's fingerprint as the tiebreak — the same diffing
repair has always used (data_partition_repair.go role), now continuous.
Multi-way disagreement with no majority is left for operators (healing
from an arbitrary copy could cement wrong data), mirroring the blob
inspector's unique-culprit rule.

Discipline (rate limit, SCRUB-priority admission, resumable persisted
cursor, CUBEFS_SCRUB door, clock injection) all comes from
``utils.scrub.Scrubber``; healed extents are remembered in ``healed``
so a later fsck run dedups instead of re-reporting them.

The port's copy of ``cubefs_tpu/fs/scrub.py``, over the port's
``utils/scrub.Scrubber`` and ``DataNode.sync_extent_from``. Host work: no
kernel runs here.
"""

from __future__ import annotations

import json
import os

from ..utils import metrics, qos, rpc
from ..utils.retry import MONOTONIC, Clock
from ..utils.scrub import Scrubber


def heal_extent(fs, pool, dp_id: int, extent_id: int,
                source: str = "scrub") -> bool:
    """Compare one extent's replica fingerprints; rewrite every
    divergent copy from a majority-fingerprint replica. Returns True
    when divergence was found (and a heal attempted), False when the
    replicas already agree — so callers can count real repairs without
    ever rewriting a clean extent (zero false repairs)."""
    dp = fs.data._dp_by_id(dp_id)
    fps: dict[str, tuple[int, int]] = {}
    for addr in dp["replicas"]:
        try:
            meta, _ = pool.get(addr).call(
                "extent_fingerprint",
                {"dp_id": dp_id, "extent_id": extent_id})
            fps[addr] = (meta["size"], meta["crc"])
        except (rpc.RpcError, OSError):
            continue  # unreachable replica: the repair sweep's problem
    if len(set(fps.values())) <= 1:
        return False  # consistent (or nothing readable): nothing to heal
    votes: dict[tuple[int, int], int] = {}
    for v in fps.values():
        votes[v] = votes.get(v, 0) + 1
    leader_fp = fps.get(dp.get("leader"))
    best = max(votes, key=lambda v: (votes[v], v == leader_fp))
    top = [v for v in votes if votes[v] == votes[best]]
    if len(top) > 1 and leader_fp not in top:
        # no majority and the leader can't break the tie: healing from
        # an arbitrary copy could cement wrong data — leave for operators
        metrics.integrity_repair_failures.inc(plane="fs")
        return True
    healthy = [a for a, v in fps.items() if v == best]
    src = dp["leader"] if dp.get("leader") in healthy else healthy[0]
    for addr in (a for a, v in fps.items() if v != best):
        try:
            pool.get(addr).call(
                "sync_extent_from",
                {"dp_id": dp_id, "extent_id": extent_id,
                 "src_addr": src, "source": source}, timeout=30.0)
        except (rpc.RpcError, OSError):
            metrics.integrity_repair_failures.inc(plane="fs")
    return True


class FsScrubber:
    """Continuous fs-plane scrub loop over the generic Scrubber."""

    def __init__(self, fs, pool, *, clock: Clock = MONOTONIC,
                 rate: float = 0.0, data_dir: str | None = None):
        self.fs = fs
        self.pool = pool
        # (dp_id, extent_id) this scrubber healed — fsck dedups on it
        self.healed: set[tuple[int, int]] = set()
        cursor_load = cursor_save = None
        if data_dir:
            os.makedirs(data_dir, exist_ok=True)
            path = os.path.join(data_dir, "fs_scrub_cursor.json")

            def cursor_load():
                if os.path.exists(path):
                    return json.load(open(path)).get("cursor")
                return None

            def cursor_save(cursor):
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump({"cursor": cursor}, f)
                os.replace(tmp, path)

        self.scrubber = Scrubber("fs", self._list_units, self._scrub_unit,
                                 clock=clock, rate=rate,
                                 cursor_load=cursor_load,
                                 cursor_save=cursor_save)

    def _list_units(self) -> list[str]:
        from .fsck import list_referenced_extents

        # same unit-key shape the at-rest fault plan uses (dpX:eY)
        return [f"dp{d}:e{e}" for d, e in list_referenced_extents(self.fs)]

    def _scrub_unit(self, unit: str) -> str:
        dp_part, e_part = unit.split(":")
        dp_id, eid = int(dp_part[2:]), int(e_part[1:])
        try:
            with qos.admit("fs.scrub", priority=qos.SCRUB, svc="fsck"):
                diverged = heal_extent(self.fs, self.pool, dp_id, eid,
                                       source="scrub")
        except qos.QosRejected:
            return "skipped"  # brownout: give way to foreground
        except (rpc.RpcError, OSError):
            return "skipped"
        if diverged:
            self.healed.add((dp_id, eid))
            return "corrupt"
        return "clean"

    # thin delegation so callers (cli, tests) treat both planes alike
    def run_once(self, max_units: int | None = None) -> dict:
        return self.scrubber.run_once(max_units=max_units)

    def run_full_pass(self) -> dict:
        return self.scrubber.run_full_pass()

    def start(self, interval: float = 1.0, units_per_tick: int = 8) -> None:
        self.scrubber.start(interval, units_per_tick)

    def stop(self) -> None:
        self.scrubber.stop()

    def status(self) -> dict:
        st = self.scrubber.status()
        st["healed"] = len(self.healed)
        return st
