"""The native client library: the libcfs-analog C ABI (ctypes, no pybind11).

The port's counterpart of the ``cfs_*`` part of
``cubefs_tpu/runtime/build.py``. One source,
``csrc/host/native_client.cc`` (the port's copy of the reference's), is
a dependency-free HTTP/1.1 client of the RPC wire (JSON args in
``X-Rpc-Args``, a binary body, the reply's meta in ``X-Rpc-Resp``). Its
exports drive:

- the codec role (``cfs_codec_encode``, ``cfs_codec_encode_shm``,
  ``cfs_codec_crc32``), which runs kernels A and B on the card;
- the access role (``cfs_blob_put``, ``cfs_blob_get``,
  ``cfs_blob_delete``), which runs A on its PUT stacks and degraded GETs;
- an ``fsgateway`` (``cfs_mount`` and the POSIX calls), whose
  ``FileSystem`` reads tiered files cold through A.

A failed call answers ``-errno`` (or -1) and leaves ``cfs_last_errno``
and ``cfs_last_error`` set. The library stands alone, holding no extent
store and no read plane. g++ compiles it at first use into
``cubefs_tpu_torch/_build/``, named by a hash of the source and flags. A
failed build raises. C programs link it by the path ``lib_path()``
gives, after ``build()``.
"""

from __future__ import annotations

import ctypes
import os
import threading

from ..ops._build import SRC_DIR, build_host, host_lib_path

SOURCES = (os.path.join(SRC_DIR, "host", "native_client.cc"),)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def lib_path() -> str:
    return host_lib_path("nativeclient", SOURCES)


def build() -> str:
    """The library's path, built first if missing."""
    return build_host(lib_path(), SOURCES, "native client library")


def load() -> ctypes.CDLL:
    """The bound library, built first if missing."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            c = ctypes
            lib.cfs_last_error.restype = c.c_char_p
            lib.cfs_last_error.argtypes = []
            lib.cfs_last_meta.restype = c.c_char_p
            lib.cfs_last_meta.argtypes = []
            lib.cfs_last_errno.restype = c.c_int
            lib.cfs_last_errno.argtypes = []
            # blob plane (access role)
            lib.cfs_blob_put.restype = c.c_int
            lib.cfs_blob_put.argtypes = [
                c.c_char_p, c.c_int, c.c_char_p, c.c_uint64, c.c_char_p, c.c_uint64]
            lib.cfs_blob_get.restype = c.c_int64
            lib.cfs_blob_get.argtypes = [
                c.c_char_p, c.c_int, c.c_char_p, c.c_void_p, c.c_uint64]
            lib.cfs_blob_delete.restype = c.c_int
            lib.cfs_blob_delete.argtypes = [c.c_char_p, c.c_int, c.c_char_p]
            # codec role
            lib.cfs_codec_encode.restype = c.c_int
            lib.cfs_codec_encode.argtypes = [
                c.c_char_p, c.c_int, c.c_int, c.c_int, c.c_uint64, c.c_int,
                c.c_char_p, c.c_void_p]
            lib.cfs_codec_encode_shm.restype = c.c_int
            lib.cfs_codec_encode_shm.argtypes = [
                c.c_char_p, c.c_int, c.c_int, c.c_int, c.c_uint64, c.c_int,
                c.c_void_p, c.c_void_p]
            lib.cfs_codec_crc32.restype = c.c_int
            lib.cfs_codec_crc32.argtypes = [
                c.c_char_p, c.c_int, c.c_uint64, c.c_char_p, c.c_uint64, c.c_void_p]
            # POSIX file surface over an fsgateway
            lib.cfs_mount.restype = c.c_void_p
            lib.cfs_mount.argtypes = [c.c_char_p, c.c_int]
            lib.cfs_unmount.restype = None
            lib.cfs_unmount.argtypes = [c.c_void_p]
            lib.cfs_open.restype = c.c_int
            lib.cfs_open.argtypes = [c.c_void_p, c.c_char_p, c.c_int, c.c_int]
            lib.cfs_close.restype = c.c_int
            lib.cfs_close.argtypes = [c.c_void_p, c.c_int]
            lib.cfs_read.restype = c.c_int64
            lib.cfs_read.argtypes = [c.c_void_p, c.c_int, c.c_void_p, c.c_uint64]
            lib.cfs_pread.restype = c.c_int64
            lib.cfs_pread.argtypes = [c.c_void_p, c.c_int, c.c_void_p, c.c_uint64, c.c_uint64]
            lib.cfs_write.restype = c.c_int64
            lib.cfs_write.argtypes = [c.c_void_p, c.c_int, c.c_char_p, c.c_uint64]
            lib.cfs_pwrite.restype = c.c_int64
            lib.cfs_pwrite.argtypes = [c.c_void_p, c.c_int, c.c_char_p, c.c_uint64, c.c_uint64]
            lib.cfs_lseek.restype = c.c_int64
            lib.cfs_lseek.argtypes = [c.c_void_p, c.c_int, c.c_int64, c.c_int]
            lib.cfs_stat_path.restype = c.c_int
            lib.cfs_stat_path.argtypes = [
                c.c_void_p, c.c_char_p, c.POINTER(c.c_uint64), c.POINTER(c.c_uint32),
                c.POINTER(c.c_uint32), c.POINTER(c.c_uint64)]
            lib.cfs_mkdirs.restype = c.c_int
            lib.cfs_mkdirs.argtypes = [c.c_void_p, c.c_char_p]
            lib.cfs_readdir.restype = c.c_int64
            lib.cfs_readdir.argtypes = [c.c_void_p, c.c_char_p, c.c_void_p, c.c_uint64]
            lib.cfs_unlink.restype = c.c_int
            lib.cfs_unlink.argtypes = [c.c_void_p, c.c_char_p]
            lib.cfs_rmdir.restype = c.c_int
            lib.cfs_rmdir.argtypes = [c.c_void_p, c.c_char_p]
            lib.cfs_rename.restype = c.c_int
            lib.cfs_rename.argtypes = [c.c_void_p, c.c_char_p, c.c_char_p]
            lib.cfs_truncate.restype = c.c_int
            lib.cfs_truncate.argtypes = [c.c_void_p, c.c_char_p, c.c_uint64]
            lib.cfs_flush.restype = c.c_int
            lib.cfs_flush.argtypes = [c.c_void_p, c.c_int]
            _lib = lib
        return _lib
