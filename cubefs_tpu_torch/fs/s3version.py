"""S3 bucket versioning + object lock over the FS volume adapter.

Role parity: objectnode/router.go:244-312 (bucket versioning routes,
ListObjectVersions, versionId subresources) and objectnode/object_lock.go
(retention / legal hold configuration and enforcement).

Storage model (no side database — everything rides the volume):

- The plain object path ``/key`` is ALWAYS the newest version. A
  versioned overwrite or delete first *renames* the current file into
  the archive — no data copy, and the version's xattrs travel with it.
- Archived versions live at ``/.versions/<quoted-key>/<vid>`` where
  <quoted-key> is the key percent-encoded into a single path component
  (so ``a`` and ``a/b`` can both have version histories without the
  directory trees colliding).
- A delete marker is an empty archived file with ``s3.dm=1``.
- Per-version metadata is xattrs: ``s3.vid`` (version id; "null" for
  versions written while suspended or before versioning), ``s3.vts``
  (creation time, ns — the version ordering), ``s3.etag``, and the
  object-lock fields ``s3.ret.mode`` / ``s3.ret.until`` /
  ``s3.legalhold``.

Lock enforcement matches AWS semantics: an unversioned DELETE (which
only adds a marker) is always allowed; permanently deleting or
overwriting a protected *version* is denied — COMPLIANCE
unconditionally, GOVERNANCE unless the caller set
``x-amz-bypass-governance-retention``.

The port's copy of ``cubefs_tpu/fs/s3version.py``.
"""

from __future__ import annotations

import json
import secrets
import time
import urllib.parse

from . import metanode as mn
from .client import FileSystem, FsError

VDIR = ".versions"

XA_VERSIONING = "s3.versioning"  # bucket root: "Enabled" | "Suspended"
XA_OBJLOCK = "s3.objectlock"     # bucket root: JSON lock configuration
XA_VID = "s3.vid"
XA_VTS = "s3.vts"
XA_DM = "s3.dm"
XA_ETAG = "s3.etag"
XA_RET_MODE = "s3.ret.mode"      # "GOVERNANCE" | "COMPLIANCE"
XA_RET_UNTIL = "s3.ret.until"    # unix seconds, str
XA_LEGAL_HOLD = "s3.legalhold"   # "ON" | "OFF"

NULL_VID = "null"


class S3VersionError(Exception):
    def __init__(self, http: int, code: str, msg: str):
        super().__init__(msg)
        self.http = http
        self.code = code


class Locked(S3VersionError):
    def __init__(self, why: str):
        super().__init__(403, "AccessDenied", why)


def _now_ns() -> int:
    return time.time_ns()


def new_vid() -> str:
    return secrets.token_hex(16)


def iso8601(unix: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S.000Z", time.gmtime(unix))


def parse_iso8601(s: str) -> float:
    import calendar

    s = s.strip().rstrip("Z")
    if "." in s:
        s = s[: s.index(".")]
    return calendar.timegm(time.strptime(s, "%Y-%m-%dT%H:%M:%S"))


class VersionStore:
    """All version/lock operations for one bucket (= one FileSystem)."""

    def __init__(self, fs: FileSystem):
        self.fs = fs

    # ---- bucket configuration -------------------------------------
    def status(self) -> str | None:
        try:
            return self.fs.getxattr("/", XA_VERSIONING)
        except FsError:
            return None

    def set_status(self, status: str) -> None:
        if status not in ("Enabled", "Suspended"):
            raise S3VersionError(400, "MalformedXML",
                                 f"bad versioning status {status!r}")
        if status == "Suspended" and self.lock_config() is not None:
            # AWS: a bucket with object lock can never suspend versioning
            raise S3VersionError(
                409, "InvalidBucketState",
                "versioning cannot be suspended with object lock enabled")
        self.fs.setxattr("/", XA_VERSIONING, status)

    def lock_config(self) -> dict | None:
        try:
            raw = self.fs.getxattr("/", XA_OBJLOCK)
        except FsError:
            return None
        return json.loads(raw) if raw else None

    def set_lock_config(self, conf: dict) -> None:
        if self.status() != "Enabled":
            raise S3VersionError(
                409, "InvalidBucketState",
                "object lock requires versioning to be enabled")
        self.fs.setxattr("/", XA_OBJLOCK, json.dumps(conf))

    # ---- path helpers ---------------------------------------------
    def _vdir(self, key: str) -> str:
        return f"/{VDIR}/" + urllib.parse.quote(key, safe="")

    def _ensure_vdir(self, key: str) -> str:
        for d in (f"/{VDIR}", self._vdir(key)):
            try:
                self.fs.mkdir(d)
            except FsError as e:
                if e.errno != mn.EEXIST:
                    raise
        return self._vdir(key)

    def _meta(self, path: str) -> dict:
        """Inode + version xattrs for one version file."""
        ino = self.fs.resolve(path)
        inode = self.fs.meta.inode_get(ino)
        xa = inode["xattr"]
        return {
            "path": path,
            "dir": inode["type"] == mn.DIR,
            "size": inode["size"],
            "vid": xa.get(XA_VID) or NULL_VID,
            "vts": int(xa.get(XA_VTS) or 0),
            "dm": xa.get(XA_DM) == "1",
            "etag": xa.get(XA_ETAG) or "",
            "ret_mode": xa.get(XA_RET_MODE),
            "ret_until": float(xa[XA_RET_UNTIL]) if xa.get(XA_RET_UNTIL)
            else None,
            "legal_hold": xa.get(XA_LEGAL_HOLD) == "ON",
        }

    def _archived(self, key: str) -> list[dict]:
        """Archived versions of `key`, newest first."""
        vdir = self._vdir(key)
        try:
            names = self.fs.readdir(vdir)
        except FsError:
            return []
        out = [self._meta(f"{vdir}/{n}") for n in names]
        out.sort(key=lambda m: m["vts"], reverse=True)
        return out

    def _current(self, key: str) -> dict | None:
        try:
            m = self._meta("/" + key)
        except FsError:
            return None
        # a directory is key-prefix structure, never an object version:
        # without this guard a versioned DELETE of "a" would archive the
        # whole /a subtree as one "version"
        return None if m["dir"] else m

    # ---- lock enforcement ------------------------------------------
    def check_unlocked(self, meta: dict, bypass_governance: bool) -> None:
        """Raise Locked if this version may not be destroyed/overwritten."""
        if meta["dm"]:
            return  # markers carry no payload and are never locked
        if meta["legal_hold"]:
            raise Locked(f"version {meta['vid']} is under legal hold")
        until = meta["ret_until"]
        if until is not None and until > time.time():
            mode = meta["ret_mode"] or "GOVERNANCE"
            if mode == "COMPLIANCE":
                raise Locked(
                    f"version {meta['vid']} is locked (COMPLIANCE) "
                    f"until {iso8601(until)}")
            if not bypass_governance:
                raise Locked(
                    f"version {meta['vid']} is locked (GOVERNANCE) "
                    f"until {iso8601(until)}; bypass not requested")

    def _apply_default_retention(self, path: str) -> None:
        conf = self.lock_config()
        rule = (conf or {}).get("default") or None
        if not rule:
            return
        days = rule.get("days") or 0
        years = rule.get("years") or 0
        until = time.time() + days * 86400 + years * 365 * 86400
        self.fs.setxattr(path, XA_RET_MODE, rule["mode"])
        self.fs.setxattr(path, XA_RET_UNTIL, str(until))

    # ---- version lifecycle -----------------------------------------
    def _stamp(self, path: str, vid: str, dm: bool = False,
               etag: str = "") -> None:
        self.fs.setxattr(path, XA_VID, vid)
        self.fs.setxattr(path, XA_VTS, str(_now_ns()))
        if dm:
            self.fs.setxattr(path, XA_DM, "1")
        if etag:
            self.fs.setxattr(path, XA_ETAG, etag)

    def _archive_current(self, key: str) -> None:
        """Move /key (always the newest version) into the archive."""
        cur = self._current(key)
        if cur is None:
            return
        vdir = self._ensure_vdir(key)
        self.fs.rename("/" + key, f"{vdir}/{cur['vid']}")

    def put(self, key: str, write_fn, etag: str,
            bypass_governance: bool = False) -> str:
        """Versioned PutObject. `write_fn()` performs the actual object
        write to /key (the caller owns directory creation etc). Returns
        the new version id."""
        st = self.status()
        if st == "Enabled":
            self._archive_current(key)
            write_fn()
            vid = new_vid()
            self._stamp("/" + key, vid, etag=etag)
            self._apply_default_retention("/" + key)
            return vid
        # Suspended: the write replaces the null version wherever it is;
        # a LOCKED null version must refuse the overwrite (its data
        # would be destroyed)
        cur = self._current(key)
        if cur is not None and cur["vid"] != NULL_VID:
            self._archive_current(key)
        elif cur is not None:
            self.check_unlocked(cur, bypass_governance)
        for m in self._archived(key):
            if m["vid"] == NULL_VID:
                self.check_unlocked(m, bypass_governance)
                self.fs.unlink(m["path"])
        write_fn()
        self._stamp("/" + key, NULL_VID, etag=etag)
        return NULL_VID

    def delete(self, key: str) -> str:
        """Versioned DeleteObject without versionId: archive the current
        version and leave a delete marker as the newest version. Always
        allowed (no data is destroyed). Returns the marker's vid."""
        st = self.status()
        vdir = self._ensure_vdir(key)
        if st == "Enabled":
            self._archive_current(key)
            vid = new_vid()
            self.fs.write_file(f"{vdir}/{vid}", b"")
            self._stamp(f"{vdir}/{vid}", vid, dm=True)
            return vid
        # Suspended: a null delete marker replaces the null version
        cur = self._current(key)
        if cur is not None:
            if cur["vid"] == NULL_VID:
                # replacing a marker is fine; replacing DATA destroys it
                self.check_unlocked(cur, bypass_governance=False)
                self.fs.unlink("/" + key)
            else:
                self._archive_current(key)
        for m in self._archived(key):
            if m["vid"] == NULL_VID:
                self.check_unlocked(m, bypass_governance=False)
                self.fs.unlink(m["path"])
        self.fs.write_file(f"{vdir}/{NULL_VID}", b"")
        self._stamp(f"{vdir}/{NULL_VID}", NULL_VID, dm=True)
        return NULL_VID

    def find(self, key: str, vid: str) -> dict:
        cur = self._current(key)
        if cur is not None and cur["vid"] == vid:
            return cur
        for m in self._archived(key):
            if m["vid"] == vid:
                return m
        raise S3VersionError(404, "NoSuchVersion",
                             f"{key} has no version {vid}")

    def delete_version(self, key: str, vid: str,
                       bypass_governance: bool) -> bool:
        """Permanently delete one version (DELETE ?versionId=...).
        Returns True if the deleted version was a delete marker."""
        meta = self.find(key, vid)
        self.check_unlocked(meta, bypass_governance)
        self.fs.unlink(meta["path"])
        if self._current(key) is None:
            # the newest version went away (the current file, or the
            # marker that was shadowing the archive): newest remaining
            # real version becomes the object again
            self._promote(key)
        self._prune(key)
        return meta["dm"]

    def _ensure_parents(self, key: str) -> None:
        path = ""
        for d in [p for p in key.split("/") if p][:-1]:
            path += "/" + d
            try:
                self.fs.mkdir(path)
            except FsError as e:
                if e.errno != mn.EEXIST:
                    raise

    def _promote(self, key: str) -> None:
        """After the newest version went away with /key absent: if the
        newest remaining version is real data, it becomes /key again
        (rename keeps its vid/lock xattrs). A marker stays archived —
        its presence is what makes GET return 404. The key's parent
        directories were pruned when the object went away, so recreate
        them first."""
        arch = self._archived(key)
        if arch and not arch[0]["dm"]:
            self._ensure_parents(key)
            self.fs.rename(arch[0]["path"], "/" + key)

    def _prune(self, key: str) -> None:
        vdir = self._vdir(key)
        try:
            if not self.fs.readdir(vdir):
                self.fs.unlink(vdir)
        except FsError:
            pass

    # ---- reads ------------------------------------------------------
    def latest_is_marker(self, key: str) -> bool:
        """True when the object's newest version is a delete marker
        (GET must 404 with x-amz-delete-marker: true)."""
        if self._current(key) is not None:
            return False
        arch = self._archived(key)
        return bool(arch) and arch[0]["dm"]

    def read_version(self, key: str, vid: str) -> tuple[bytes, dict]:
        meta = self.find(key, vid)
        if meta["dm"]:
            # AWS: GET with a delete marker's versionId is 405
            raise S3VersionError(405, "MethodNotAllowed",
                                 "the specified version is a delete marker")
        return self.fs.read_file(meta["path"]), meta

    # ---- retention / legal hold -------------------------------------
    def _target(self, key: str, vid: str | None) -> dict:
        # retention/legal hold only mean something on a bucket with
        # object lock configured — without it no delete path enforces
        # them, and claiming WORM protection that nothing enforces is
        # worse than refusing (AWS: 400 InvalidRequest)
        if self.lock_config() is None:
            raise S3VersionError(
                400, "InvalidRequest",
                "bucket has no object lock configuration")
        if vid:
            return self.find(key, vid)
        cur = self._current(key)
        if cur is None:
            raise S3VersionError(404, "NoSuchKey", key)
        return cur

    def get_retention(self, key: str, vid: str | None) -> dict | None:
        m = self._target(key, vid)
        if m["ret_until"] is None:
            return None
        return {"mode": m["ret_mode"] or "GOVERNANCE",
                "until": m["ret_until"]}

    def set_retention(self, key: str, vid: str | None, mode: str,
                      until: float, bypass_governance: bool) -> None:
        if mode not in ("GOVERNANCE", "COMPLIANCE"):
            raise S3VersionError(400, "MalformedXML",
                                 f"bad retention mode {mode!r}")
        m = self._target(key, vid)
        if m["dm"]:
            raise S3VersionError(400, "InvalidRequest",
                                 "cannot set retention on a delete marker")
        old_until = m["ret_until"]
        if old_until is not None and old_until > time.time():
            shortening = until < old_until
            if m["ret_mode"] == "COMPLIANCE" and shortening:
                raise Locked("COMPLIANCE retention cannot be shortened")
            if (m["ret_mode"] or "GOVERNANCE") == "GOVERNANCE" \
                    and shortening and not bypass_governance:
                raise Locked("GOVERNANCE retention shortening requires "
                             "bypass")
        self.fs.setxattr(m["path"], XA_RET_MODE, mode)
        self.fs.setxattr(m["path"], XA_RET_UNTIL, str(until))

    def get_legal_hold(self, key: str, vid: str | None) -> bool:
        return self._target(key, vid)["legal_hold"]

    def set_legal_hold(self, key: str, vid: str | None, on: bool) -> None:
        m = self._target(key, vid)
        if m["dm"]:
            raise S3VersionError(400, "InvalidRequest",
                                 "cannot set legal hold on a delete marker")
        self.fs.setxattr(m["path"], XA_LEGAL_HOLD, "ON" if on else "OFF")

    # ---- ListObjectVersions -----------------------------------------
    def list_versions(self, list_keys_fn, prefix: str,
                      max_keys: int, key_marker: str,
                      vid_marker: str) -> tuple[list[dict], bool, str, str]:
        """All versions of all keys under `prefix`, key order then
        newest-first within a key. `list_keys_fn(prefix)` enumerates
        live keys (the gateway's walker); archived-only keys (latest is
        a marker) are found through the archive directory itself."""
        keys = {t[0] for t in list_keys_fn(prefix)}
        # keys whose only remnants are archived versions/markers
        try:
            for qname in self.fs.readdir(f"/{VDIR}"):
                k = urllib.parse.unquote(qname)
                if k.startswith(prefix):
                    keys.add(k)
        except FsError:
            pass
        entries: list[dict] = []
        for k in sorted(keys):
            versions = []
            cur = self._current(k)
            if cur is not None:
                versions.append(cur)
            versions.extend(self._archived(k))
            for i, m in enumerate(versions):
                entries.append({**m, "key": k, "is_latest": i == 0})
        if key_marker:
            # resume strictly after the marker pair IN LISTED ORDER
            # (vids are random tokens, so comparing them would be
            # meaningless): skip up to and including the marker entry
            start = 0
            for i, e in enumerate(entries):
                if e["key"] > key_marker:
                    break
                start = i + 1
                if (e["key"] == key_marker and vid_marker
                        and e["vid"] == vid_marker):
                    break
            entries = entries[start:]
        truncated = len(entries) > max_keys
        page = entries[:max_keys]
        nk = page[-1]["key"] if truncated else ""
        nv = page[-1]["vid"] if truncated else ""
        return page, truncated, nk, nv
