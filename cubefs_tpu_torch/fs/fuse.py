"""FUSE client: POSIX access via the kernel, speaking the /dev/fuse ABI.

Role parity: client/ (the cfs-client FUSE daemon: mount at
client/fuse.go:885 via a forked bazil/fuse, VFS impl under client/fs/).
The reference leans on a vendored Go FUSE library; here the kernel wire
protocol (FUSE_INIT handshake + request/reply framing + the core opcode
set) is implemented directly on the raw device fd — no libfuse — and
dispatches into the FileSystem facade (cubefs_tpu/fs/client.py), so
`ls`, `cat`, `cp`, `mkdir` on the mountpoint hit metanode/datanode like
any other client.

Requires root (direct mount(2) via ctypes) or fusermount. Linux only.

The port's copy of ``cubefs_tpu/fs/fuse.py``. ``unmount`` detaches the
mount (``MNT_DETACH``) and closes the device once, however often it is
called: a watchdog may call it beside the owner, and a second ``close``
could hit a descriptor the number was handed to since. While the serve
thread is busy on a request, closing the device aborts the connection,
so a call blocked on the mount returns ``ENOTCONN`` instead of waiting
on a daemon that will not answer. A read of a tiered file goes through
the cold tier, as ``FileSystem.read_file`` serves it, where the
reference's reads the released extents and answers zeros; the object
read stays with the mount until the file is released. The INIT reply
takes the kernel's readahead and the flags that make it honour
``max_write`` and ``max_pages`` (1 MiB): the reference's sets neither, so
its kernel sends every write and read as one 4 KiB page.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import errno
import os
import stat as stat_mod
import struct
import threading

from ..utils import lockwitness
from . import metanode as mn
from .client import FileSystem, FsError

# ---- fuse kernel ABI constants ----
FUSE_KERNEL_VERSION = 7
FUSE_KERNEL_MINOR = 31

(FUSE_LOOKUP, FUSE_FORGET, FUSE_GETATTR, FUSE_SETATTR) = (1, 2, 3, 4)
FUSE_READLINK, FUSE_SYMLINK = 5, 6
FUSE_MKDIR, FUSE_UNLINK, FUSE_RMDIR, FUSE_RENAME = 9, 10, 11, 12
FUSE_LINK = 13
FUSE_OPEN, FUSE_READ, FUSE_WRITE, FUSE_STATFS, FUSE_RELEASE = 14, 15, 16, 17, 18
FUSE_FSYNC, FUSE_SETXATTR, FUSE_GETXATTR, FUSE_FLUSH = 20, 21, 22, 25
FUSE_LISTXATTR, FUSE_REMOVEXATTR = 23, 24
FUSE_RENAME2 = 45
RENAME_NOREPLACE = 1  # renameat2(2) flag
FUSE_INIT, FUSE_OPENDIR, FUSE_READDIR, FUSE_RELEASEDIR = 26, 27, 28, 29
FUSE_ACCESS, FUSE_CREATE = 34, 35
FUSE_DESTROY = 38
FUSE_BIG_WRITES, FUSE_MAX_PAGES = 1 << 5, 1 << 22  # fuse_init_in/out flags

_IN_HDR = struct.Struct("<IIQQIIII")  # len opcode unique nodeid uid gid pid pad
_OUT_HDR = struct.Struct("<IiQ")  # len error unique
_ATTR = struct.Struct("<QQQQQQIIIIIIIIII")  # ino size blocks a/m/ctime + nsec*3 mode nlink uid gid rdev blksize flags
_ENTRY_OUT = struct.Struct("<QQQQII")  # nodeid generation entry_valid attr_valid nsecs


def _attr_bytes(inode: dict) -> bytes:
    mode = inode["mode"]
    if inode["type"] == mn.DIR:
        mode |= stat_mod.S_IFDIR
    elif inode["type"] == mn.SYMLINK:
        mode |= stat_mod.S_IFLNK
    else:
        mode |= stat_mod.S_IFREG
    size = inode["size"]
    t = lambda x: int(x)
    return _ATTR.pack(
        inode["ino"], size, (size + 511) // 512,
        t(inode["atime"]), t(inode["mtime"]), t(inode["ctime"]),
        0, 0, 0, mode, inode["nlink"], inode["uid"], inode["gid"], 0, 4096, 0,
    )


class FuseMount:
    """One mounted volume; a daemon thread serves kernel requests."""

    def __init__(self, fs: FileSystem, mountpoint: str):
        self.fs = fs
        self.mnt = os.path.abspath(mountpoint)
        self.fd = -1
        self._thread: threading.Thread | None = None
        self._write_buffers: dict[int, int] = {}  # fh -> ino (open handles)
        self._next_fh = 1
        self._lock = lockwitness.make_lock("FuseMount._lock")
        self._cold: tuple | None = None  # ((ino, size, location), bytes): the last tiered read

    # ---------------- mount / unmount ----------------
    def mount(self) -> "FuseMount":
        os.makedirs(self.mnt, exist_ok=True)
        self.fd = os.open("/dev/fuse", os.O_RDWR)
        opts = (f"fd={self.fd},rootmode=40755,user_id=0,group_id=0,"
                f"allow_other,default_permissions")
        libc = ctypes.CDLL(ctypes.util.find_library("c"), use_errno=True)
        rc = libc.mount(b"cubefs-tpu", self.mnt.encode(), b"fuse.cubefs-tpu",
                        0, opts.encode())
        if rc != 0:
            e = ctypes.get_errno()
            os.close(self.fd)
            self.fd = -1
            raise OSError(e, f"mount(2) failed: {os.strerror(e)}")
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()
        return self

    def unmount(self) -> None:
        with self._lock:
            fd, self.fd = self.fd, -1
        if fd < 0:
            return
        libc = ctypes.CDLL(ctypes.util.find_library("c"), use_errno=True)
        libc.umount2(self.mnt.encode(), 2)  # MNT_DETACH
        try:
            os.close(fd)
        except OSError:
            pass

    MAX_WRITE = 1 << 20
    # the kernel EINVALs reads whose buffer is smaller than max_write
    # plus the request headers — pad generously
    READ_BUF = MAX_WRITE + (1 << 16)

    # ---------------- serve loop ----------------
    def _serve(self) -> None:
        fd = self.fd
        while self.fd == fd:  # unmount hands the number back to the process
            try:
                req = os.read(fd, self.READ_BUF)
            except OSError:
                return  # unmounted
            if not req:
                return
            try:
                self._dispatch(req)
            except Exception:
                hdr = _IN_HDR.unpack_from(req)
                self._reply_err(hdr[2], errno.EIO)

    def _reply(self, unique: int, payload: bytes = b"") -> None:
        out = _OUT_HDR.pack(_OUT_HDR.size + len(payload), 0, unique) + payload
        try:
            os.write(self.fd, out)
        except OSError:
            pass

    def _reply_err(self, unique: int, err: int) -> None:
        try:
            os.write(self.fd, _OUT_HDR.pack(_OUT_HDR.size, -err, unique))
        except OSError:
            pass

    def _entry_reply(self, unique: int, inode: dict) -> None:
        payload = _ENTRY_OUT.pack(inode["ino"], 0, 1, 1, 0, 0) + _attr_bytes(inode)
        self._reply(unique, payload)

    # ---------------- dispatch ----------------
    def _dispatch(self, req: bytes) -> None:
        (length, opcode, unique, nodeid, uid, gid, pid, _) = _IN_HDR.unpack_from(req)
        body = req[_IN_HDR.size : length]
        fs = self.fs

        if opcode == FUSE_INIT:
            major, minor, max_readahead, offered = struct.unpack_from("<IIII", body)
            minor = min(minor, FUSE_KERNEL_MINOR)
            # fuse_init_out (7.23+ layout, zero-extended). The kernel honours
            # max_write and max_pages only with these flags: without them
            # every write arrives as one page, and without readahead every
            # read as one page. FUSE_BIG_WRITES goes out even unoffered: a
            # gVisor (runsc) kernel offers only FUSE_MAX_PAGES, sends page
            # writes without it, and honours it
            out = struct.pack(
                "<IIIIHHIIHHI28x",
                FUSE_KERNEL_VERSION, minor,
                max_readahead,  # the kernel's offer
                FUSE_BIG_WRITES | offered & FUSE_MAX_PAGES,  # flags
                0, 0,  # max_background, congestion_threshold
                self.MAX_WRITE,  # max_write
                1,  # time_gran
                256, 0, 0,  # max_pages, map_alignment, flags2
            )
            self._reply(unique, out)
            return

        if opcode in (FUSE_FORGET, FUSE_DESTROY):
            return  # no reply

        if opcode == FUSE_STATFS:
            # fuse_kstatfs: blocks bfree bavail files ffree bsize namelen frsize pad
            out = struct.pack("<QQQQQIIII4x", 1 << 30, 1 << 29, 1 << 29,
                              1 << 20, 1 << 19, 4096, 255, 4096, 0)
            self._reply(unique, out)
            return

        try:
            self._dispatch_fs(opcode, unique, nodeid, body, fs)
        except FsError as e:
            self._reply_err(unique, e.errno if 0 < e.errno < 130 else errno.EIO)

    def _read_cold(self, inode: dict, offset: int, size: int) -> bytes:
        """A tiered file's extents are released: its bytes come from the
        blob plane, as ``FileSystem.read_file`` serves them. The tier
        reads a whole object, and the kernel asks in pieces of at most
        ``max_pages``, so the last object read stays here, keyed by inode,
        size and location, until its file is released."""
        key = (inode["ino"], inode["size"], inode["xattr"]["cold.location"])
        with self._lock:
            data = self._cold[1] if self._cold is not None and self._cold[0] == key else None
        if data is None:
            data = self.fs.tiering.read_cold(inode, 0, inode["size"])
            with self._lock:
                self._cold = (key, data)
        return data[offset:offset + size]

    def _dispatch_fs(self, opcode, unique, nodeid, body, fs: FileSystem) -> None:
        if opcode == FUSE_LOOKUP:
            name = body.split(b"\x00", 1)[0].decode()
            ino = fs.meta.lookup(nodeid, name)
            self._entry_reply(unique, fs.meta.inode_get(ino))

        elif opcode == FUSE_GETATTR:
            inode = fs.meta.inode_get(nodeid)
            payload = struct.pack("<QII", 1, 0, 0) + _attr_bytes(inode)
            self._reply(unique, payload)

        elif opcode == FUSE_SETATTR:
            # fuse_setattr_in: valid, pad, fh, size, lock_owner,
            # a/m/ctime (+nsecs), then mode at offset 68
            valid, _pad, fh, size = struct.unpack_from("<IIQQ", body)
            attrs = {}
            if valid & (1 << 3):  # FATTR_SIZE
                # EVERY size change rides the real truncate op: a bare
                # size attr leaves stale extents, and a later extend
                # resurrects pre-truncate bytes instead of zeros (POSIX
                # violation caught by tests/conformance/test_posix_ltp)
                fs.meta.truncate(nodeid, size)
                fs.data.close_stream(nodeid)
                # freed extents ride the metanode freelist
            if valid & (1 << 0):  # FATTR_MODE
                mode = struct.unpack_from("<I", body, 68)[0]
                attrs["mode"] = mode & 0o7777
            if attrs:
                fs.meta.set_attr(nodeid, **attrs)
            inode = fs.meta.inode_get(nodeid)
            self._reply(unique, struct.pack("<QII", 1, 0, 0) + _attr_bytes(inode))

        elif opcode in (FUSE_OPEN, FUSE_OPENDIR):
            with self._lock:
                fh = self._next_fh
                self._next_fh += 1
            self._reply(unique, struct.pack("<QII", fh, 0, 0))

        elif opcode in (FUSE_RELEASE, FUSE_RELEASEDIR, FUSE_FLUSH, FUSE_FSYNC,
                        FUSE_ACCESS):
            if opcode == FUSE_RELEASE:
                fs.data.close_stream(nodeid)
                with self._lock:
                    if self._cold is not None and self._cold[0][0] == nodeid:
                        self._cold = None
            self._reply(unique)

        elif opcode == FUSE_READDIR:
            fh, offset, size, *_ = struct.unpack_from("<QQI", body)
            entries = sorted(fs.meta.readdir(nodeid).items())
            listing = [(".", nodeid, stat_mod.S_IFDIR), ("..", nodeid, stat_mod.S_IFDIR)]
            for name, ino in entries:
                typ = fs.meta.inode_get(ino)["type"]
                mode = stat_mod.S_IFDIR if typ == mn.DIR else stat_mod.S_IFREG
                listing.append((name, ino, mode))
            out = bytearray()
            for i, (name, ino, mode) in enumerate(listing):
                if i < offset:
                    continue
                nb = name.encode()
                ent = struct.pack("<QQII", ino, i + 1, len(nb), mode >> 12) + nb
                ent += b"\x00" * ((8 - len(ent) % 8) % 8)
                if len(out) + len(ent) > size:
                    break
                out += ent
            self._reply(unique, bytes(out))

        elif opcode == FUSE_READ:
            fh, offset, size, *_ = struct.unpack_from("<QQI", body)
            inode = fs.meta.inode_get(nodeid)
            if (fs.tiering is not None and not inode["extents"]
                    and inode["xattr"].get("cold.location")):
                self._reply(unique, self._read_cold(inode, offset, size))
            else:
                self._reply(unique, fs.data.read(inode, offset, size))

        elif opcode == FUSE_WRITE:
            fh, offset, size, flags = struct.unpack_from("<QQII", body)
            # write payload follows the fuse_write_in struct (40 bytes)
            data = body[40 : 40 + size]
            fs.data.write(fs.meta, nodeid, offset, data)
            self._reply(unique, struct.pack("<II", len(data), 0))

        elif opcode == FUSE_CREATE:
            flags, mode, umask, _pad = struct.unpack_from("<IIII", body)
            name = body[16:].split(b"\x00", 1)[0].decode()
            inode = fs.meta.inode_create(mn.FILE, mode & 0o7777)
            try:
                fs.meta.dentry_create(nodeid, name, inode["ino"])
            except FsError:
                fs.meta.inode_delete(inode["ino"])
                raise
            with self._lock:
                fh = self._next_fh
                self._next_fh += 1
            payload = (_ENTRY_OUT.pack(inode["ino"], 0, 1, 1, 0, 0)
                       + _attr_bytes(inode)
                       + struct.pack("<QII", fh, 0, 0))
            self._reply(unique, payload)

        elif opcode == FUSE_MKDIR:
            mode, umask = struct.unpack_from("<II", body)
            name = body[8:].split(b"\x00", 1)[0].decode()
            inode = fs.meta.inode_create(mn.DIR, mode & 0o7777)
            try:
                fs.meta.dentry_create(nodeid, name, inode["ino"])
            except FsError:
                fs.meta.inode_delete(inode["ino"])
                raise
            self._entry_reply(unique, inode)

        elif opcode == FUSE_SYMLINK:
            name, target = body.split(b"\x00")[:2]
            inode = fs.meta.inode_create(mn.SYMLINK, 0o777,
                                         target=target.decode())
            try:
                fs.meta.dentry_create(nodeid, name.decode(), inode["ino"])
            except FsError:
                fs.meta.inode_delete(inode["ino"])
                raise
            self._entry_reply(unique, inode)

        elif opcode == FUSE_READLINK:
            inode = fs.meta.inode_get(nodeid)
            if inode["type"] != mn.SYMLINK or not inode.get("target"):
                self._reply_err(unique, errno.EINVAL)
            else:
                self._reply(unique, inode["target"].encode())

        elif opcode in (FUSE_UNLINK, FUSE_RMDIR):
            name = body.split(b"\x00", 1)[0].decode()
            ino = fs.meta.lookup(nodeid, name)
            inode = fs.meta.inode_get(ino)
            if opcode == FUSE_RMDIR and fs.meta.dentry_count(ino) > 0:
                raise FsError(mn.ENOTEMPTY, "directory not empty")
            fs.meta.dentry_delete(nodeid, name)
            # last link removes the inode (extents ride the freelist);
            # other hardlinks keep it alive
            if fs.meta.dec_nlink(ino):
                fs.data.close_stream(ino)
            self._reply(unique)

        elif opcode == FUSE_LINK:
            (old_ino,) = struct.unpack_from("<Q", body)
            name = body[8:].split(b"\x00", 1)[0].decode()
            # link_at returns the post-link inode: no extra round trip
            self._entry_reply(unique, fs.link_at(old_ino, nodeid, name))

        elif opcode == FUSE_RENAME:
            newdir = struct.unpack_from("<Q", body)[0]
            names = body[8:].split(b"\x00")
            old_name, new_name = names[0].decode(), names[1].decode()
            # atomic rename(2) semantics (replace-existing) via the
            # client's single-apply / two-phase-tx path
            fs.rename_at(nodeid, old_name, newdir, new_name)
            self._reply(unique)

        elif opcode == FUSE_GETXATTR:
            size, _pad = struct.unpack_from("<II", body)
            name = body[8:].split(b"\x00", 1)[0].decode()
            value = fs.meta.inode_get(nodeid)["xattr"].get(name)
            if value is None:
                self._reply_err(unique, 61)  # ENODATA
                return
            raw = str(value).encode()
            if size == 0:
                self._reply(unique, struct.pack("<II", len(raw), 0))
            elif size < len(raw):
                self._reply_err(unique, errno.ERANGE)
            else:
                self._reply(unique, raw)

        elif opcode == FUSE_SETXATTR:
            size, flags = struct.unpack_from("<II", body)
            rest = body[8:]
            name, value = rest.split(b"\x00", 1)[0], None
            value = rest[len(name) + 1 : len(name) + 1 + size]
            fs.meta.set_xattr(nodeid, name.decode(), value.decode("utf-8", "replace"))
            self._reply(unique)

        elif opcode == FUSE_LISTXATTR:
            size, _pad = struct.unpack_from("<II", body)
            names = sorted(fs.meta.inode_get(nodeid)["xattr"])
            raw = b"".join(n.encode() + b"\x00" for n in names)
            if size == 0:
                self._reply(unique, struct.pack("<II", len(raw), 0))
            elif size < len(raw):
                self._reply_err(unique, errno.ERANGE)
            else:
                self._reply(unique, raw)

        elif opcode == FUSE_REMOVEXATTR:
            name = body.split(b"\x00", 1)[0].decode()
            if name not in fs.meta.inode_get(nodeid)["xattr"]:
                self._reply_err(unique, 61)  # ENODATA
                return
            fs.meta.set_xattr(nodeid, name, None)
            self._reply(unique)

        elif opcode == FUSE_RENAME2:
            newdir, flags, _pad = struct.unpack_from("<QII", body)
            names = body[16:].split(b"\x00")
            old_name, new_name = names[0].decode(), names[1].decode()
            if flags & ~RENAME_NOREPLACE:
                # EXCHANGE/WHITEOUT are unsupported: rejecting beats a
                # silent destructive replace where the kernel contract
                # promises a lossless swap
                self._reply_err(unique, errno.EINVAL)
                return
            # NOREPLACE is enforced atomically inside the rename apply
            fs.rename_at(nodeid, old_name, newdir, new_name,
                         noreplace=bool(flags & RENAME_NOREPLACE))
            self._reply(unique)

        else:
            self._reply_err(unique, errno.ENOSYS)


def mount(fs: FileSystem, mountpoint: str) -> FuseMount:
    return FuseMount(fs, mountpoint).mount()
