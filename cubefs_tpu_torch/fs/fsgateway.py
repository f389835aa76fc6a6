"""FsGateway: path-level RPC surface for the native POSIX C ABI.

Role parity: client/libsdk (libcfs.so embeds the whole Go SDK via cgo,
libsdk.go:289-840 exporting cfs_open/cfs_read/...). This framework's
native boundary is a daemon instead of an embedded runtime (the
blockcache-daemon pattern): the C client (runtime/src/native_client.cc
cfs_fs_* / cfs_open family) speaks the framework's RPC wire to this
gateway, which runs the Python SDK (FileSystem facade). Stat results
travel as a fixed-layout binary record so the C side needs no JSON
parser.

The port's copy of ``cubefs_tpu/fs/fsgateway.py``; its C client is
``csrc/host/native_client.cc`` (``runtime/nativeclient.py``). A gateway
over a ``FileSystem`` with a blob client and ``CUBEFS_TIERING=1`` reads
tiered files cold, with kernel A rebuilding a blob that lost a data unit.
"""

from __future__ import annotations

import struct

from ..utils import rpc
from . import metanode as mn
from .client import FileSystem, FsError

# fixed binary stat record: u64 size, u32 mode, u32 type, u64 mtime_sec
STAT_FMT = "<QIIQ"
TYPE_CODES = {mn.FILE: 0, mn.DIR: 1, mn.SYMLINK: 2}


def _err(e: FsError) -> rpc.RpcError:
    return rpc.errno_error(e.errno, str(e))


class FsGateway:
    """One mounted volume served to native clients."""

    def __init__(self, fs: FileSystem):
        self.fs = fs

    # ---- metadata ----
    def rpc_fs_stat(self, args, body):
        try:
            st = self.fs.stat(args["path"])
        except FsError as e:
            raise _err(e) from None
        rec = struct.pack(STAT_FMT, st["size"], st["mode"],
                          TYPE_CODES.get(st["type"], 0), int(st["mtime"]))
        return {"size": st["size"], "type": st["type"]}, rec

    def rpc_fs_mkdir(self, args, body):
        try:
            ino = self.fs.mkdir(args["path"], args.get("mode", 0o755))
        except FsError as e:
            raise _err(e) from None
        return {"ino": ino}

    def rpc_fs_create(self, args, body):
        try:
            ino = self.fs.create(args["path"], args.get("mode", 0o644))
        except FsError as e:
            raise _err(e) from None
        return {"ino": ino}

    def rpc_fs_readdir(self, args, body):
        try:
            entries = self.fs.readdir(args["path"])
        except FsError as e:
            raise _err(e) from None
        return {"count": len(entries)}, "\n".join(sorted(entries)).encode()

    def rpc_fs_unlink(self, args, body):
        try:
            self.fs.unlink(args["path"])
        except FsError as e:
            raise _err(e) from None
        return {}

    def rpc_fs_rename(self, args, body):
        try:
            self.fs.rename(args["old"], args["new"])
        except FsError as e:
            raise _err(e) from None
        return {}

    def rpc_fs_truncate(self, args, body):
        try:
            self.fs.truncate_file(args["path"], args["size"])
        except FsError as e:
            raise _err(e) from None
        return {}

    # ---- data ----
    def rpc_fs_read(self, args, body):
        try:
            data = self.fs.read_file(args["path"], offset=args.get("offset", 0),
                                     length=args.get("length"))
        except FsError as e:
            raise _err(e) from None
        return {"n": len(data)}, data

    def rpc_fs_write(self, args, body):
        try:
            self.fs.pwrite_file(args["path"], args.get("offset", 0), body)
        except FsError as e:
            raise _err(e) from None
        return {"n": len(body)}
