"""Build the port's host GF(2^8) library with g++ and bind it with ctypes.

``csrc/host/gfcpu.cc`` holds the host codec legs' native code: ``gf_apply``
(the ``cpp`` engine), ``xor_apply`` (the ``cpp-xor`` engine, replaying
``ops/xorprog.py`` schedules) and ``gf_cpu_level``. It is compiled at
first use into ``cubefs_tpu_torch/_build/``, named by a hash of the source
and the flags, so an edit rebuilds and an unchanged tree reuses the
library. Processes that build at once (test workers) each write a file
of their own and move it into place with ``os.replace``. A failed build
raises with g++'s output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

from ._build import BUILD_DIR, SRC_DIR

SOURCE = os.path.join(SRC_DIR, "host", "gfcpu.cc")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_U64, _P = ctypes.c_uint64, ctypes.c_void_p
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def lib_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libgfcpu-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless it is there; returns its path."""
    out = lib_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"host GF library build failed: g++ exited {proc.returncode}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


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
