"""LcNode: S3 lifecycle rule executor.

Role parity: lcnode/ — scans volume metadata against lifecycle rules
(lc_scanner.go) and applies expiration actions; the reference also
transitions storage classes (lc_transition.go), which here delegates to
fs/tiering.py's TieringEngine: a crash-safe two-phase migration state
machine instead of the old read->put->truncate sequence (which could
lose bytes if the node died between the put and the truncate, and
rescanned empty files forever).

A scan pass now does four jobs:
  1. resume any migration a previous (crashed) run left mid-flight
     (tiering.state xattr present) — roll forward or roll back,
  2. start new transitions / expirations per the rules,
  3. promote re-heated cold files back to hot extents,
  4. reap orphaned blobs off the metanode's deferred blob freelist.

Time is injected (utils/retry.py Clock protocol) so lifecycle aging is
testable on a FakeClock without sleeping; the default is wall time
because rule age math compares against inode mtimes, which are epoch
stamps.

The port's copy of ``cubefs_tpu/fs/lcnode.py``.
"""

from __future__ import annotations

import fnmatch  # noqa: F401  (rule prefixes may grow glob support)
import logging
import threading
import time
from dataclasses import dataclass, field

from ..utils import faultinject, metrics
from ..utils.retry import Clock
from . import metanode as mn
from .client import FileSystem, FsError
from .tiering import TieringEngine

log = logging.getLogger("cubefs.lcnode")


class _WallClock(Clock):
    """Epoch-time clock: lifecycle ages are computed against inode
    mtimes (time.time() stamps), so the scheduler clock must share
    their origin — unlike utils.retry.MONOTONIC."""

    def now(self) -> float:
        return time.time()


WALL = _WallClock()


@dataclass
class LifecycleRule:
    rule_id: str
    prefix: str = ""  # path prefix, e.g. "/logs/"
    expire_after_s: float | None = None  # delete when mtime older
    transition_after_s: float | None = None  # move payload to blob plane
    enabled: bool = True


@dataclass
class ScanReport:
    scanned: int = 0
    expired: int = 0
    transitioned: int = 0
    resumed: int = 0  # half-done migrations rolled forward/back
    untiered: int = 0  # cold files promoted back to hot
    reaped: int = 0  # orphan blobs deleted off the deferred freelist
    errors: list = field(default_factory=list)


class LcNode:
    def __init__(self, fs: FileSystem, blob_access=None, *,
                 clock: Clock | None = None,
                 engine: TieringEngine | None = None,
                 codemode: int | None = None):
        self.fs = fs
        self.clock = clock or WALL
        if engine is None and blob_access is not None:
            engine = TieringEngine(fs, blob_access, codemode=codemode)
        self.engine = engine
        self.rules: list[LifecycleRule] = []
        self._stop = threading.Event()

    def set_rules(self, rules: list[LifecycleRule]) -> None:
        self.rules = list(rules)

    def load_rules_from_bucket(self) -> int:
        """Adopt the bucket's S3 LifecycleConfiguration (stored by the
        gateway as the s3.lifecycle xattr on the volume root) — the
        master/lifecycle_manager.go -> lcnode task flow, compacted:
        the executor reads the volume's own config. Returns rule count."""
        import json

        from . import s3policy

        try:
            raw = self.fs.getxattr("/", s3policy.XA_LIFECYCLE)
        except FsError:
            raw = None
        if not raw:
            self.rules = []
            return 0
        day = 86400.0
        rules = []
        for r in json.loads(raw):
            rules.append(LifecycleRule(
                rule_id=r["id"],
                prefix="/" + r.get("prefix", "").lstrip("/"),
                expire_after_s=(r["expire_days"] * day
                                if r.get("expire_days") is not None else None),
                transition_after_s=(r["transition_days"] * day
                                    if r.get("transition_days") is not None
                                    else None),
                enabled=r.get("status", "Enabled") == "Enabled",
            ))
        self.rules = rules
        return len(rules)

    def scan_once(self) -> ScanReport:
        report = ScanReport()
        now = self.clock.now()
        self._walk("/", mn.ROOT_INO, now, report)
        if self.engine is not None:
            for ino in self.engine.hot_candidates():
                try:
                    if self.engine.untier(ino) == "promoted":
                        report.untiered += 1
                except FsError as e:
                    report.errors.append((f"ino:{ino}", str(e)))
            report.reaped = self.engine.reap_orphans()
        return report

    def _walk(self, path: str, ino: int, now: float,
              report: ScanReport) -> None:
        try:
            entries = self.fs.meta.readdir(ino)
        except FsError:
            return
        for name, child in sorted(entries.items()):
            cpath = f"{path.rstrip('/')}/{name}"
            try:
                inode = self.fs.meta.inode_get(child)
            except FsError:
                continue
            if inode["type"] == mn.DIR:
                self._walk(cpath, child, now, report)
                continue
            report.scanned += 1
            self._apply_rules(cpath, child, inode, now, report)
        return

    def _apply_rules(self, cpath: str, child: int, inode: dict,
                     now: float, report: ScanReport) -> None:
        if (self.engine is not None
                and inode["xattr"].get("tiering.state") is not None):
            # a previous run died mid-migration: recover FIRST,
            # regardless of rule matching or age
            try:
                out = self.engine.migrate(child)
            except FsError as e:
                report.errors.append((cpath, str(e)))
            else:
                report.resumed += 1
                if out == "resumed":
                    report.transitioned += 1
            return
        for rule in self.rules:
            if not rule.enabled or not cpath.startswith(rule.prefix):
                continue
            age = now - inode["mtime"]
            try:
                if (rule.expire_after_s is not None
                        and age > rule.expire_after_s):
                    self.fs.unlink(cpath)
                    report.expired += 1
                    break
                if (rule.transition_after_s is not None
                        and age > rule.transition_after_s
                        and self.engine is not None
                        and not inode["xattr"].get("cold.location")):
                    if self.engine.migrate(child) == "migrated":
                        report.transitioned += 1
                    break
            except FsError as e:
                report.errors.append((cpath, str(e)))

    def read_through(self, path: str) -> bytes:
        """Read a possibly-cold file: hot extents if present, else fetch
        from the blob plane via the pinned location."""
        inode = self.fs.meta.inode_get(self.fs.resolve(path))
        if inode["extents"]:
            return self.fs.data.read(inode, 0, inode["size"])
        if (self.engine is not None
                and inode["xattr"].get("cold.location")):
            return self.engine.read_cold(inode, 0, inode["size"])
        return b""

    def start(self, interval: float = 60.0) -> None:
        def loop():
            while not self._stop.wait(interval):
                try:
                    self.scan_once()
                except faultinject.InjectedCrash:
                    raise  # a drill kill takes the whole node down
                except Exception:
                    # a broken scan must not silently kill the
                    # lifecycle loop: count it, log it, keep scanning
                    metrics.lc_scan_errors.inc()
                    log.exception("lifecycle scan failed; will retry")

        threading.Thread(target=loop, daemon=True).start()

    def stop(self) -> None:
        self._stop.set()
