"""The file-system plane's native runtime (ctypes, no pybind11).

The port's counterpart of the ``es_*``, ``ds_*`` and ``ms_*`` parts of
``cubefs_tpu/runtime/build.py``. One library holds the extent store
(``csrc/host/extentstore.cc``), the datanode's read plane
(``dataserve.cc``) and the metanode's (``metaserve.cc``): a datanode
hands its extent-store handle to the read plane
(``ds_add_partition(h, dp_id, store.handle, serving)``), so the store and
the plane that reads it must share one copy of the code. The sources are
the port's copies of the reference's, so an extent directory written by
either package opens in the other and both planes speak the reference's
64-byte packet wire (``packetwire.h``). g++ compiles them at first use
into ``cubefs_tpu_torch/_build/`` (a library named by a hash of the
sources and flags); a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import threading

from ..ops._build import SRC_DIR, build_host, host_lib_path

SOURCES = tuple(os.path.join(SRC_DIR, "host", f) for f in (
    "extentstore.cc", "dataserve.cc", "metaserve.cc", "bufpool.cc", "crc32cpu.cc"))

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def lib_path() -> str:
    return host_lib_path("fsnative", SOURCES)


def load() -> ctypes.CDLL:
    """The bound library, built first if missing."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_host(lib_path(), SOURCES, "file-system native library"))
            c = ctypes
            # extent store (datanode engine)
            lib.es_open.restype = c.c_void_p
            lib.es_open.argtypes = [c.c_char_p]
            lib.es_close.argtypes = [c.c_void_p]
            lib.es_last_error.restype = c.c_char_p
            lib.es_last_error.argtypes = [c.c_void_p]
            lib.es_create.argtypes = [c.c_void_p, c.c_uint64]
            lib.es_write.argtypes = [
                c.c_void_p, c.c_uint64, c.c_uint64, c.c_char_p, c.c_uint64,
            ]
            lib.es_read.restype = c.c_int64
            lib.es_read.argtypes = [
                c.c_void_p, c.c_uint64, c.c_uint64, c.c_void_p, c.c_uint64,
            ]
            lib.es_size.restype = c.c_uint64
            lib.es_size.argtypes = [c.c_void_p, c.c_uint64]
            lib.es_block_crcs.restype = c.c_int64
            lib.es_block_crcs.argtypes = [c.c_void_p, c.c_uint64, c.c_void_p, c.c_int64]
            lib.es_delete.argtypes = [c.c_void_p, c.c_uint64]
            lib.es_sync.argtypes = [c.c_void_p, c.c_uint64]
            # the metanode's read plane (metaserve.cc)
            lib.ms_create.restype = c.c_void_p
            lib.ms_destroy.argtypes = [c.c_void_p]
            lib.ms_add_partition.argtypes = [
                c.c_void_p, c.c_uint64, c.c_uint64, c.c_uint64]
            lib.ms_drop_partition.argtypes = [c.c_void_p, c.c_uint64]
            lib.ms_set_serving.argtypes = [
                c.c_void_p, c.c_uint64, c.c_int, c.c_char_p]
            lib.ms_set_moved.argtypes = [
                c.c_void_p, c.c_uint64, c.c_void_p, c.c_uint64]
            lib.ms_put_inode.argtypes = [
                c.c_void_p, c.c_uint64, c.c_uint64, c.c_char_p, c.c_uint32]
            lib.ms_del_inode.argtypes = [c.c_void_p, c.c_uint64, c.c_uint64]
            lib.ms_ensure_dir.argtypes = [c.c_void_p, c.c_uint64, c.c_uint64]
            lib.ms_del_dir.argtypes = [c.c_void_p, c.c_uint64, c.c_uint64]
            lib.ms_put_dentry.argtypes = [
                c.c_void_p, c.c_uint64, c.c_uint64, c.c_char_p, c.c_uint32,
                c.c_uint64]
            lib.ms_del_dentry.argtypes = [
                c.c_void_p, c.c_uint64, c.c_uint64, c.c_char_p, c.c_uint32]
            lib.ms_clear.argtypes = [c.c_void_p, c.c_uint64]
            lib.ms_op_count.restype = c.c_uint64
            lib.ms_op_count.argtypes = [c.c_void_p]
            lib.ms_serve.restype = c.c_int
            lib.ms_serve.argtypes = [c.c_void_p, c.c_char_p, c.c_int]
            lib.ms_stop.argtypes = [c.c_void_p]
            lib.ms_bench.restype = c.c_double
            lib.ms_bench.argtypes = [c.c_char_p, c.c_int, c.c_int,
                                     c.c_char_p, c.c_int, c.c_int]
            # the datanode's read plane (dataserve.cc)
            lib.ds_create.restype = c.c_void_p
            lib.ds_destroy.argtypes = [c.c_void_p]
            lib.ds_add_partition.argtypes = [
                c.c_void_p, c.c_uint64, c.c_void_p, c.c_int]
            lib.ds_set_serving.argtypes = [c.c_void_p, c.c_uint64, c.c_int]
            lib.ds_drop_partition.argtypes = [c.c_void_p, c.c_uint64]
            lib.ds_set_down.argtypes = [c.c_void_p, c.c_int]
            lib.ds_op_count.restype = c.c_uint64
            lib.ds_op_count.argtypes = [c.c_void_p]
            lib.ds_take_failed.restype = c.c_int
            lib.ds_take_failed.argtypes = [c.c_void_p, c.c_void_p, c.c_int]
            lib.ds_serve.restype = c.c_int
            lib.ds_serve.argtypes = [c.c_void_p, c.c_char_p, c.c_int]
            lib.ds_stop.argtypes = [c.c_void_p]
            _lib = lib
        return _lib
