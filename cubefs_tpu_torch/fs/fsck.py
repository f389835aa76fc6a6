"""fsck: filesystem consistency checker.

Role parity: tool/fsck — walks the volume's metadata tree, verifies
every extent key resolves to readable bit-identical replicas (CRC
fingerprint agreement), reports dangling extent keys, orphaned dentries
(pointing to missing inodes), and orphaned extents on datanodes that no
inode references (reclaimable leak candidates).

The port's copy of ``cubefs_tpu/fs/fsck.py``: ``--heal`` goes through
``fs/scrub.heal_extent``, the one healer. Host work: no kernel runs here.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..utils import rpc
from . import metanode as mn
from .client import FileSystem, FsError


@dataclass
class FsckReport:
    files: int = 0
    dirs: int = 0
    bytes_checked: int = 0
    dangling_extents: list = field(default_factory=list)  # (path, ek, err)
    replica_mismatches: list = field(default_factory=list)  # (path, ek, fps)
    orphan_dentries: list = field(default_factory=list)  # (parent_path, name)
    orphan_extents: list = field(default_factory=list)  # (dp_id, extent_id)
    orphan_extent_ages: dict = field(default_factory=dict)  # (dp,eid)->sec
    orphan_inodes: list = field(default_factory=list)  # ino (no dentry)
    pending_free: int = 0  # freelist entries awaiting the deletion scan
    reclaimed_extents: int = 0
    reclaimed_inodes: int = 0
    healed_extents: list = field(default_factory=list)  # (dp_id, eid) via --heal
    deduped_mismatches: int = 0  # already healed by the scrubber

    @property
    def clean(self) -> bool:
        return not (self.dangling_extents or self.replica_mismatches
                    or self.orphan_dentries or self.orphan_extents
                    or self.orphan_inodes)

    def summary(self) -> dict:
        return {
            "files": self.files, "dirs": self.dirs,
            "bytes": self.bytes_checked,
            "dangling_extents": len(self.dangling_extents),
            "replica_mismatches": len(self.replica_mismatches),
            "orphan_dentries": len(self.orphan_dentries),
            "orphan_extents": len(self.orphan_extents),
            "orphan_inodes": len(self.orphan_inodes),
            "pending_free": self.pending_free,
            "reclaimed_extents": self.reclaimed_extents,
            "reclaimed_inodes": self.reclaimed_inodes,
            "healed_extents": len(self.healed_extents),
            "deduped_mismatches": self.deduped_mismatches,
            "clean": self.clean,
        }


def fsck(fs: FileSystem, node_pool, check_orphans: bool = True,
         reclaim: bool = False, orphan_grace: float = 3600.0,
         scrubber=None, heal: bool = False) -> FsckReport:
    """Meta-tree coherence plus the meta<->data reachability pass:
    datanode extents referenced by no inode AND no freelist entry are
    orphans (a leak the deferred-deletion design makes impossible for
    crashes after unlink, but disk swaps / partial rebuilds can still
    manufacture). `reclaim` deletes orphan extents from datanodes and
    funnels orphan inodes through rm_inode (whose extents then ride the
    freelist, so reclaim never races the free scan).

    `scrubber` (an fs.scrub.FsScrubber) dedups replica mismatches the
    continuous scrubber already healed — they'd otherwise double-report
    while the heal propagates. `heal=True` routes each remaining
    mismatch through scrub.heal_extent: the SAME sanctioned healer the
    scrubber and client read-repair use, never a second repair path."""
    report = FsckReport()
    referenced: set[tuple[int, int]] = set()
    seen_inos: set[int] = set()
    _walk(fs, node_pool, "/", mn.ROOT_INO, report, referenced, seen_inos)
    if scrubber is not None and report.replica_mismatches:
        healed = getattr(scrubber, "healed", set())
        kept = [m for m in report.replica_mismatches
                if (m[1]["dp_id"], m[1]["extent_id"]) not in healed]
        report.deduped_mismatches = (len(report.replica_mismatches)
                                     - len(kept))
        report.replica_mismatches = kept
    if heal and report.replica_mismatches:
        from .scrub import heal_extent

        still_bad = []
        for cpath, ek, fps in report.replica_mismatches:
            key = (ek["dp_id"], ek["extent_id"])
            try:
                heal_extent(fs, node_pool, key[0], key[1], source="fsck")
                report.healed_extents.append(key)
            except (FsError, rpc.RpcError, OSError):
                still_bad.append((cpath, ek, fps))
        report.replica_mismatches = still_bad
    # freed-but-not-yet-deleted extents are NOT orphans: the metanode
    # free scan owns them
    pending = fs.meta.freelist_all()
    report.pending_free = len(pending)
    for ent in pending.values():
        for ek in ent["extents"]:
            referenced.add((ek["dp_id"], ek["extent_id"]))
    _find_orphan_inodes(fs, seen_inos, referenced, report)
    if check_orphans:
        _find_orphan_extents(fs, node_pool, referenced, report)
    if reclaim:
        _reclaim(fs, node_pool, report, orphan_grace)
    return report


def _find_orphan_inodes(fs, seen_inos, referenced,
                        report: FsckReport) -> None:
    """Inodes no dentry reaches (e.g. a client that crashed between
    dentry_delete and inode_delete). Their extents are still accounted
    to them — marked referenced here so the extent pass doesn't call
    them orphans — but the space only comes back when rm_inode moves
    them to the freelist (reclaim does that)."""
    for ino in sorted(fs.meta.list_inos()):
        if ino != mn.ROOT_INO and ino not in seen_inos:
            report.orphan_inodes.append(ino)
            try:
                for ek in fs.meta.inode_get(ino)["extents"]:
                    referenced.add((ek["dp_id"], ek["extent_id"]))
            except (FsError, rpc.RpcError, OSError):
                pass


def _reclaim(fs, pool, report: FsckReport, orphan_grace: float) -> None:
    import time as _time

    now = _time.time()
    for ino in report.orphan_inodes:
        try:
            inode = fs.meta.inode_get(ino)
            # grace window: a client mid-create (mk_inode committed,
            # dentry_create not yet issued) looks exactly like an orphan;
            # only reclaim inodes old enough that no live create can
            # still be racing us
            if now - inode.get("ctime", 0.0) < orphan_grace:
                continue
            fs.meta.inode_delete(ino)  # extents -> freelist -> free scan
            report.reclaimed_inodes += 1
        except (FsError, rpc.RpcError, OSError):
            pass
    for dp_id, eid in report.orphan_extents:
        # same grace discipline as orphan inodes: an extent a client just
        # wrote but has not yet committed to the metanode (append_extents
        # in flight) looks exactly like an orphan — only reclaim extents
        # old enough that no live write can still be racing us
        if report.orphan_extent_ages.get((dp_id, eid), 0.0) < orphan_grace:
            continue
        try:
            dp = fs.data._dp_by_id(dp_id)
        except FsError:
            continue
        ok = True
        for addr in dp["replicas"]:
            try:
                pool.get(addr).call(
                    "delete_extent", {"dp_id": dp_id, "extent_id": eid})
            except (rpc.RpcError, OSError):
                ok = False
        if ok:
            report.reclaimed_extents += 1


def _walk(fs, pool, path, ino, report: FsckReport,
          referenced: set[tuple[int, int]],
          seen_inos: set[int] | None = None) -> None:
    if seen_inos is not None:
        seen_inos.add(ino)
    try:
        entries = fs.meta.readdir(ino)
    except FsError:
        return
    report.dirs += 1
    for name, child in sorted(entries.items()):
        cpath = f"{path.rstrip('/')}/{name}"
        try:
            inode = fs.meta.inode_get(child)
        except FsError:
            report.orphan_dentries.append((path, name))
            continue
        if seen_inos is not None:
            seen_inos.add(child)
        if inode["type"] == mn.DIR:
            _walk(fs, pool, cpath, child, report, referenced, seen_inos)
            continue
        report.files += 1
        for ek in inode["extents"]:
            referenced.add((ek["dp_id"], ek["extent_id"]))
            try:
                dp = fs.data._dp_by_id(ek["dp_id"])
            except FsError as e:
                report.dangling_extents.append((cpath, ek, str(e)))
                continue
            fps = {}
            for addr in dp["replicas"]:
                try:
                    meta, _ = pool.get(addr).call(
                        "extent_fingerprint",
                        {"dp_id": ek["dp_id"], "extent_id": ek["extent_id"]},
                    )
                    fps[addr] = (meta["size"], meta["crc"])
                except (rpc.RpcError, OSError) as e:
                    fps[addr] = ("unreachable", str(e)[:40])
            values = {v for v in fps.values() if v[0] != "unreachable"}
            if not values:
                report.dangling_extents.append((cpath, ek, "no replica readable"))
            elif len(values) > 1:
                report.replica_mismatches.append((cpath, ek, fps))
            else:
                report.bytes_checked += ek["size"]


def list_referenced_extents(fs) -> list[tuple[int, int]]:
    """Every (dp_id, extent_id) any inode references — the cheap subset
    of the fsck walk (no fingerprinting), reused as the fs-plane
    scrubber's work list."""
    out: list[tuple[int, int]] = []
    seen: set[tuple[int, int]] = set()
    for ino in sorted(fs.meta.list_inos()):
        try:
            inode = fs.meta.inode_get(ino)
        except (FsError, rpc.RpcError, OSError):
            continue
        for ek in inode.get("extents", []):
            key = (ek["dp_id"], ek["extent_id"])
            if key not in seen:
                seen.add(key)
                out.append(key)
    return out


def _find_orphan_extents(fs, pool, referenced, report: FsckReport) -> None:
    seen_dps = set()
    for dp in fs.data.dps:
        if dp["dp_id"] in seen_dps:
            continue
        seen_dps.add(dp["dp_id"])
        for addr in dp["replicas"]:
            try:
                meta, _ = pool.get(addr).call(
                    "list_extents", {"dp_id": dp["dp_id"], "want_ages": True})
            except (rpc.RpcError, OSError):
                continue
            ages = meta.get("ages", {})
            for eid in meta["extents"]:
                if (dp["dp_id"], eid) not in referenced:
                    key = (dp["dp_id"], eid)
                    if key not in report.orphan_extents:
                        report.orphan_extents.append(key)
                        report.orphan_extent_ages[key] = ages.get(
                            str(eid), 0.0)
            break
