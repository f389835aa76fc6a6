"""Build the port's host GF(2^8) library with g++ and bind it with ctypes.

``csrc/host/gfcpu.cc`` holds the host codec legs' native code: ``gf_apply``
(the ``cpp`` engine), ``xor_apply`` (the ``cpp-xor`` engine, replaying
``ops/xorprog.py`` schedules) and ``gf_cpu_level``. It is compiled at
first use into ``cubefs_tpu_torch/_build/`` by ``_build.build_host``,
under the name ``_build.host_lib_path`` gives it. A failed build raises
with g++'s output.
"""

from __future__ import annotations

import ctypes
import os
import threading

from ._build import BUILD_DIR, SRC_DIR, build_host, host_lib_path

SOURCE = os.path.join(SRC_DIR, "host", "gfcpu.cc")

_U64, _P = ctypes.c_uint64, ctypes.c_void_p
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def build() -> str:
    """Compile the library unless it is there; returns its path."""
    return build_host(host_lib_path("gfcpu", [SOURCE], build_dir=BUILD_DIR), [SOURCE],
                      "host GF library")


def load() -> ctypes.CDLL:
    """The bound library, built first if missing."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            # (mat, m, n, in, out, s, batch)
            lib.gf_apply.argtypes = [_P, _U64, _U64, _P, _P, _U64, _U64]
            lib.gf_apply.restype = None
            # (ops, ops_words, in, out, cin, rout, nslots, s, batch, block)
            lib.xor_apply.argtypes = [_P, _U64, _P, _P, _U64, _U64, _U64, _U64, _U64, _U64]
            lib.xor_apply.restype = None
            lib.gf_cpu_level.argtypes = []
            lib.gf_cpu_level.restype = ctypes.c_int
            _lib = lib
        return _lib


def cpu_level() -> int:
    """The SIMD path ``gf_apply`` takes on this host: 2 AVX2, 1 SSSE3, 0 scalar."""
    return int(load().gf_cpu_level())
