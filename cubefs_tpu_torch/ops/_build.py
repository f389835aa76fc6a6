"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` exports a plain C launcher that takes device
pointers, sizes and a CUDA stream, launches its kernel and returns
``cudaGetLastError()``. The sources are compiled for Hopper
(``sm_90a``) at first use into ``cubefs_tpu_torch/_build/``, one shared
library per source, named by a hash of the sources and flags so an edit
rebuilds and an unchanged tree reuses the library. Several kernel names
may share one source (each with its own C launcher). ``build()`` starts
one nvcc per missing library, all at once.

``LAUNCHES`` counts successful kernel launches per kernel. ``launch()``
is the only place that adds to it, so a run that resets the counts and
reads them afterwards sees which kernels its path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _U, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong

# name -> (source, C launcher, launcher argtypes)
KERNELS = {
    # (in, in_stripe_stride, out, out_stripe_stride, out_row_stride, products,
    #  R, C, S, B, stream)
    "gf_apply": ("gf_apply.cu", "gf_apply_launch",
                 [_P, _LL, _P, _LL, _LL, _P, _I, _I, _LL, _I, _P]),
    # (in, outer, inner, outer_stride, inner_stride, out, tables, span_cols,
    #  zeros_crc, block_len, rows, n_spans, stream)
    "crc32_blocks": ("crc32_blocks.cu", "crc32_blocks_launch",
                     [_P, _I, _I, _LL, _LL, _P, _P, _P, _U, _LL, _I, _I, _P]),
    # (in, in_stripe_stride, out, w, R, C, S, B, tile, extract, stream)
    "gf_bitmajor": ("gf_bitmajor.cu", "gf_bitmajor_launch",
                    [_P, _LL, _P, _P, _I, _I, _LL, _I, _I, _I, _P]),
    # (in, in_stripe_stride, out, w, R, C, S, B, tile, extract, probe, stream)
    "gf_bitmajor_probe": ("gf_bitmajor.cu", "gf_bitmajor_probe_launch",
                          [_P, _LL, _P, _P, _I, _I, _LL, _I, _I, _I, _I, _P]),
}

# the __global__ functions the sources define: the profiler names the
# record of each launch by its kernel's symbol, which holds one of these
SYMBOLS = ("gf_apply_kernel", "crc32_span_kernel", "gf_bitmajor_kernel")

LAUNCHES = {name: 0 for name in KERNELS}

_lock = threading.Lock()
_launchers: dict[str, ctypes._CFuncPtr] = {}
_errstr: dict[str, ctypes._CFuncPtr] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc() -> str:
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found at {path}; the CUDA kernels need the "
                           "CUDA toolkit (set CUDA_HOME)")
    return path


def _stem(name: str) -> str:
    return os.path.splitext(KERNELS[name][0])[0]


def lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(SRC_DIR)):
        if fn == KERNELS[name][0] or fn.endswith(".cuh"):
            with open(os.path.join(SRC_DIR, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return os.path.join(BUILD_DIR, f"lib{_stem(name)}-{h.hexdigest()[:16]}.so")


def log_path(name: str) -> str:
    """nvcc's output (ptxas' register and shared-memory report) of the
    build of ``lib_path(name)``, beside it under the same hashed name."""
    return os.path.splitext(lib_path(name))[0] + ".log"


def build(names=None) -> dict[str, float]:
    """Compile every named kernel whose library is missing, one nvcc per
    source, all started together. Returns seconds per kernel built (0.0
    where the library was already there); raises with nvcc's output if
    a build fails. Names are reported by source (``gf_bitmajor`` for both
    kernels of ``gf_bitmajor.cu``). ptxas' register and shared-memory
    report lands in ``log_path``."""
    by_source = {}  # one kernel name per source stands for its library
    for n in (KERNELS if names is None else names):
        by_source.setdefault(_stem(n), n)
    os.makedirs(BUILD_DIR, exist_ok=True)
    started, secs = {}, {stem: 0.0 for stem in by_source}
    for stem, kernel in by_source.items():
        out = lib_path(kernel)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(SRC_DIR, KERNELS[kernel][0])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        started[stem] = (proc, tmp, out, log_path(kernel), time.perf_counter())
    failed = []
    for name, (proc, tmp, out, log_file, t0) in started.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        with open(log_file, "w") as f:
            f.write(log)
        if proc.returncode:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return secs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of a kernel's source, built first if missing."""
    _launcher(name)
    return ctypes.CDLL(lib_path(name))  # the loader hands back the same handle


def _launcher(name: str):
    with _lock:
        if name not in _launchers:
            build([name])
            lib = ctypes.CDLL(lib_path(name))
            fn = getattr(lib, KERNELS[name][1])
            fn.argtypes = KERNELS[name][2]
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{_stem(name)}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _launchers[name], _errstr[name] = fn, err
        return _launchers[name]


def launch(name: str, *args) -> None:
    """Call a kernel's launcher; raise if CUDA refused the launch."""
    code = _launcher(name)(*args)
    if code:
        msg = _errstr[name](code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} ({msg})")
    LAUNCHES[name] += 1
