"""The codec's engines and the routing between them.

The port's counterpart of ``cubefs_tpu/codec/engine.py``. Engines expose
the raw shard math over (..., C, S) uint8 stripes; ``codec/encoder.py``
layers the Encoder semantics on top.

Engines (``get_engine(name, device)``):
  * ``cuda``: GF(2^8) math on tensors of one device, kernel A
    (``csrc/gf_apply.cu``) on a card and its plain PyTorch version with
    ``device="cpu"``. Tensors in, tensors out. The counterpart of the
    reference's ``tpu`` engine.
  * ``numpy``: table-driven GF(2^8) on the host, the golden.
  * ``cpp``: the native split-nibble SIMD engine (``csrc/host/gfcpu.cc``
    ``gf_apply``, built by ``ops/gfcpu.py``).
  * ``numpy-xor`` / ``cpp-xor``: compiled XOR programs (``ops/xorprog.py``)
    replayed by numpy or by the native executor (``xor_apply``).
  * ``auto``: each call goes to the leg the crossover table names for the
    stripes' size.
The host engines and ``auto`` take numpy (or CPU tensors) and return
numpy. ``auto``'s ``cuda`` leg is ``hostio.staged`` (one copy in, one
out), so its time counts the copies.

Routing (``auto``, and the batcher's steps of host-resident stripes):
  * The crossover table: ``measure_crossover`` times RS(6+3) single
    stripes of 64 KiB to 16 MiB on every leg and keeps, per size class,
    the fastest. It is persisted to ``_build/CROSSOVER.json`` beside the
    built kernels, stamped with ``_platform()``; a table stamped with
    another platform is refused, logged and re-measured, and an
    unreadable or malformed one is logged and replaced by the static
    split (``_static_policy``). Sizes beyond the table go to the default
    engine, ``cuda``.
  * The ``CUBEFS_CODEC_XOR`` door (``resolve_leg``, default open): a
    routed ``numpy`` becomes ``numpy-xor``; closed, the XOR legs fall
    back to ``numpy`` and ``cpp``.
  * The drill: ``CUBEFS_CODEC_DEAD`` names legs an operator declares
    lost. Routed dispatch skips them down ``_FALLBACK_CHAIN`` (``cuda``,
    ``cpp``, ``cpp-xor``, ``numpy-xor``, ``numpy``), logs one WARNING per
    (requested, served) pair and drill, and records the leg in
    ``last_dispatch``. Nothing is quarantined: clearing the variable
    restores the leg.
No error moves a call to another leg: an engine that raises raises to
its caller (the reference's demotion of a failing engine is not carried
over). An engine asked for by name is never routed.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time

import numpy as np
import torch

from .. import device as devlib
from ..ops import gf256, gfcpu, rs_kernel, xorprog
from ..ops._build import BUILD_DIR
from . import hostio

_log = logging.getLogger("cubefs.codec")


def _host(x) -> np.ndarray:
    """Host stripes as numpy: an array as it is, a CPU tensor as a view."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(f"host engines take numpy arrays or CPU tensors, got a "
                             f"tensor on {x.device}")
        return x.numpy()
    return np.asarray(x)


class CudaEngine:
    """Shard-level GF(2^8) math over (..., C, S) uint8 tensors."""

    name = "cuda"

    def __init__(self, device: str | torch.device | None = None):
        self.device = devlib.resolve(device)

    def _on_device(self, x) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint8))
        return x.to(self.device)

    def matrix_apply(self, coeff: np.ndarray, shards, out: torch.Tensor | None = None
                     ) -> torch.Tensor:
        """(R, C) GF matrix x (..., C, S) shards -> (..., R, S) on the
        engine's device, written into ``out`` if given."""
        return rs_kernel.gf_matrix_apply(coeff, self._on_device(shards), out=out)

    def encode_parity(self, data, n_parity: int, out: torch.Tensor | None = None
                      ) -> torch.Tensor:
        """(..., N, S) data -> (..., M, S) parity on the engine's device,
        written into ``out`` if given."""
        return rs_kernel.encode_parity(self._on_device(data), n_parity, out=out)


class NumpyEngine:
    name = "numpy"

    def matrix_apply(self, coeff: np.ndarray, shards) -> np.ndarray:
        coeff = np.asarray(coeff, dtype=np.uint8)
        shards = np.asarray(_host(shards), dtype=np.uint8)
        if shards.ndim == 2:
            return gf256.gf_matmul(coeff, shards)
        # one table-gather pass for the whole batch: the batch axis folds
        # into the byte axis, (..., C, S) -> (C, B*S)
        lead, (c, s) = shards.shape[:-2], shards.shape[-2:]
        b = int(np.prod(lead))  # not -1: an empty S leaves it ambiguous
        flat = np.ascontiguousarray(np.moveaxis(shards.reshape(b, c, s), 1, 0)).reshape(c, -1)
        out = np.moveaxis(gf256.gf_matmul(coeff, flat).reshape(coeff.shape[0], b, s), 0, 1)
        return np.ascontiguousarray(out).reshape(*lead, coeff.shape[0], s)

    def encode_parity(self, data, n_parity: int) -> np.ndarray:
        return self.matrix_apply(gf256.parity_matrix(data.shape[-2], n_parity), data)


class CppEngine:
    """The native split-nibble SIMD engine (``csrc/host/gfcpu.cc``)."""

    name = "cpp"

    def __init__(self):
        self._lib = gfcpu.load()

    def matrix_apply(self, coeff: np.ndarray, shards) -> np.ndarray:
        coeff = np.ascontiguousarray(coeff, dtype=np.uint8)
        shards = np.ascontiguousarray(_host(shards), dtype=np.uint8)
        lead, (c, s) = shards.shape[:-2], shards.shape[-2:]
        m = coeff.shape[0]
        if coeff.shape[1] != c:
            raise ValueError(f"matrix is {coeff.shape}, shards have {c} rows")
        batch = int(np.prod(lead)) if lead else 1
        out = np.empty((batch, m, s), dtype=np.uint8)
        self._lib.gf_apply(coeff.ctypes.data, m, c, shards.ctypes.data, out.ctypes.data, s, batch)
        return out.reshape(*lead, m, s)

    def encode_parity(self, data, n_parity: int) -> np.ndarray:
        return self.matrix_apply(gf256.parity_matrix(data.shape[-2], n_parity), data)


class XorNumpyEngine:
    """Compiled XOR programs (``ops/xorprog.py``) replayed word-wide by numpy."""

    name = "numpy-xor"

    def matrix_apply(self, coeff: np.ndarray, shards) -> np.ndarray:
        return xorprog.apply(coeff, _host(shards))

    def encode_parity(self, data, n_parity: int) -> np.ndarray:
        return xorprog.apply(gf256.parity_matrix(data.shape[-2], n_parity), _host(data))


class XorCppEngine:
    """The same compiled XOR schedules replayed by the native executor
    (``xor_apply``): one schedule, same digest and op stream, as the
    ``numpy-xor`` leg."""

    name = "cpp-xor"

    def __init__(self):
        self._lib = gfcpu.load()

    def matrix_apply(self, coeff: np.ndarray, shards) -> np.ndarray:
        prog = xorprog.program_for(coeff)
        shards = np.ascontiguousarray(_host(shards), dtype=np.uint8)
        lead, (c, s) = shards.shape[:-2], shards.shape[-2:]
        if c != prog.cols:
            raise ValueError(f"program is {prog.rows}x{prog.cols}, shards have {c} rows")
        batch = int(np.prod(lead)) if lead else 1
        flat = shards.reshape(batch, c, s)
        s2 = (s + 63) & ~63  # the executor takes 64-byte multiples
        if s2 != s:
            padded = np.zeros((batch, c, s2), dtype=np.uint8)
            padded[:, :, :s] = flat
            flat = padded
        out = np.empty((batch, prog.rows, s2), dtype=np.uint8)
        ops = prog.opstream()
        self._lib.xor_apply(ops.ctypes.data, len(ops), flat.ctypes.data, out.ctypes.data, c,
                            prog.rows, prog.nslots, s2, batch, prog.block_bytes)
        if s2 != s:
            out = np.ascontiguousarray(out[:, :, :s])
        return out.reshape(*lead, prog.rows, s)

    def encode_parity(self, data, n_parity: int) -> np.ndarray:
        return self.matrix_apply(gf256.parity_matrix(data.shape[-2], n_parity), data)


HOST_ENGINES = {
    "numpy": NumpyEngine,
    "cpp": CppEngine,
    "numpy-xor": XorNumpyEngine,
    "cpp-xor": XorCppEngine,
}
ENGINES = ("cuda", *HOST_ENGINES, "auto")

_instances: dict[str, object] = {}


def default_name() -> str:
    """The engine a caller that names none gets: ``CUBEFS_TPU_EC_ENGINE``
    or ``cuda`` (the reference's device default)."""
    return os.environ.get("CUBEFS_TPU_EC_ENGINE", "cuda")


def get_engine(name: str | None = None, device: str | torch.device | None = None):
    """An engine by name; the default is ``CUBEFS_TPU_EC_ENGINE`` or
    ``cuda``. ``device`` is the card of ``cuda`` and of ``auto``'s ``cuda``
    leg (None: the current CUDA device, ``"cpu"``: the plain version);
    the host engines ignore it. Never routed: the engine named is the one
    that runs."""
    name = name or default_name()
    if name == "cuda":
        return CudaEngine(device)
    if name == "auto":
        return AutoEngine(device)
    if name not in HOST_ENGINES:
        raise KeyError(f"unknown ec engine {name!r}; have {sorted(ENGINES)}")
    eng = _instances.get(name)
    if eng is None:
        eng = _instances.setdefault(name, HOST_ENGINES[name]())
    return eng


def host_call(name: str, method: str, device, *args, out: np.ndarray | None = None
              ) -> np.ndarray:
    """Run leg ``name`` on host stripes and return numpy, written into
    ``out`` if given. The ``cuda`` leg is ``hostio.staged``: the stripes
    copied in once, kernel A (or the plain version on ``device="cpu"``),
    the result copied out once."""
    if name != "cuda":
        y = getattr(get_engine(name), method)(*args)
        if out is None:
            return y
        np.copyto(out, y)
        return out
    eng = CudaEngine(device)
    if method == "matrix_apply":
        coeff, x = args
        return hostio.staged(np.asarray(_host(x), dtype=np.uint8), eng.device,
                             lambda xd: eng.matrix_apply(coeff, xd), out)
    x, n_parity = args
    return hostio.staged(np.asarray(_host(x), dtype=np.uint8), eng.device,
                         lambda xd: eng.encode_parity(xd, n_parity), out)


# ---------------- measured size-class crossover ----------------
# Per stripe size, host CPU or card: one small stripe cannot amortise
# the copies and the launch, a large one leaves the CPU behind. The
# table is measured on this host and card, not assumed.

_POLICY_SIZES = (64 << 10, 256 << 10, 1 << 20, 4 << 20, 16 << 20)
_CANDIDATES = ("cpp", "cpp-xor", "numpy-xor", "cuda")
_policy: list | None = None
_policy_lock = threading.Lock()


def _platform(device=None) -> str:
    """``"cuda"`` when the device leg is a card, ``"cpu"`` otherwise (no
    card, or ``device="cpu"``). Stamped into the persisted table: a table
    measured with the plain version routes every size to the host, which
    is wrong where a card is attached, and the other way round."""
    if device is not None and torch.device(device).type == "cpu":
        return "cpu"
    return "cuda" if torch.cuda.is_available() else "cpu"


def _policy_path() -> str:
    return os.path.join(BUILD_DIR, "CROSSOVER.json")


def _default_leg() -> str:
    name = default_name()
    return "cuda" if name == "auto" else name


def measure_crossover(sizes=_POLICY_SIZES, repeats: int = 3, save: bool = True,
                      device=None) -> list:
    """Time every leg on RS(6+3) single stripes of each total size in
    ``sizes`` (the ``cuda`` leg whole, numpy in to numpy out, copies
    included) and return ``[[max_total_bytes, leg], ...]``, the fastest
    leg per size, ascending. With ``save``, the table, the timings and
    ``device_crossover_bytes`` (the first size at which ``cuda`` beats
    every host leg, None if none) are persisted for later processes."""
    table, timings = [], {}
    rng = np.random.default_rng(11)
    for total in sizes:
        stripe = rng.integers(0, 256, (6, max(1, total // 6)), dtype=np.uint8)
        per = {}
        for name in _CANDIDATES:
            host_call(name, "encode_parity", device, stripe, 3)  # warm: build, compile, tables
            t0 = time.perf_counter()
            for _ in range(repeats):
                host_call(name, "encode_parity", device, stripe, 3)
            per[name] = (time.perf_counter() - t0) / repeats
        timings[str(total)] = per
        table.append([total, min(per, key=per.get)])
    crossover = next((total for total in sizes
                      if timings[str(total)]["cuda"]
                      < min(v for k, v in timings[str(total)].items() if k != "cuda")), None)
    if save:
        path = _policy_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "w") as f:
            json.dump({"table": table, "platform": _platform(device), "timings_s": timings,
                       "device_crossover_bytes": crossover}, f, indent=1)
        os.replace(tmp, path)
    global _policy
    _policy = table
    return table


def _static_policy() -> list:
    """Unmeasured host: the native engine for sub-MiB stripes, the card beyond."""
    return [[1 << 20, "cpp"], [1 << 62, "cuda"]]


def _load_policy(device=None) -> list:
    """The crossover table of this process: the persisted one when its
    stamp matches ``_platform(device)``, re-measured when it does not,
    the static split when there is none or it cannot be read."""
    global _policy
    with _policy_lock:
        if _policy is not None:
            return _policy
        path = _policy_path()
        try:
            with open(path) as f:
                data = json.load(f)
        except FileNotFoundError:
            _policy = _static_policy()
            return _policy
        except (OSError, ValueError) as e:
            _log.warning("unreadable crossover policy %s (%s); falling back to the static "
                         "size split - re-run measure_crossover() to refresh it", path, e)
            _policy = _static_policy()
            return _policy
        stamped = data.get("platform", "cpu") if isinstance(data, dict) else None
        here = _platform(device)
        if stamped is not None and stamped != here:
            _log.warning("stale crossover policy %s: measured on %r but this process "
                         "dispatches to %r; re-measuring", path, stamped, here)
            stale = True
        else:
            stale = False
            try:
                table = data["table"]
                if not (isinstance(table, list) and table
                        and all(isinstance(row, list) and len(row) == 2
                                and isinstance(row[0], int) and row[1] in _FALLBACK_CHAIN
                                for row in table)):
                    raise ValueError(f"malformed table {table!r}")
                _policy = table
            except (KeyError, TypeError, ValueError) as e:
                _log.warning("stale crossover policy %s (%s); falling back to the static "
                             "size split", path, e)
                _policy = _static_policy()
    if stale:
        return measure_crossover(device=device)
    return _policy


# Drill order: the card, then the native SIMD engine, the native XOR
# programs, the numpy XOR programs and the table-driven golden.
_FALLBACK_CHAIN = ("cuda", "cpp", "cpp-xor", "numpy-xor", "numpy")

# CUBEFS_CODEC_XOR aliasing, the reference's. A routed `numpy` becomes its
# compiled-XOR leg (same bytes, no table gathers); `cpp` is not aliased:
# the measured table, which times cpp-xor too, decides between them.
_XOR_UP = {"numpy": "numpy-xor"}
# door closed: a routed XOR leg drops back to its naive base
_XOR_BASE = {"numpy-xor": "numpy", "cpp-xor": "cpp"}

# The last routed dispatch of the process: the leg requested and the leg
# that served it.
last_dispatch: dict = {"method": None, "requested": None, "served": None}
_warned: set[tuple[str, str, frozenset]] = set()


def _xor_enabled() -> bool:
    """The CUBEFS_CODEC_XOR door (default open; ``0`` closes it), read per call."""
    return os.environ.get("CUBEFS_CODEC_XOR", "1") != "0"


def _drilled_dead() -> set[str]:
    """CUBEFS_CODEC_DEAD: comma-separated legs a drill declares lost, read per call."""
    v = os.environ.get("CUBEFS_CODEC_DEAD", "")
    return {x.strip() for x in v.split(",") if x.strip()}


def resolve_leg(name: str) -> str:
    """The leg a routed dispatch of ``name`` takes under the XOR door:
    ``numpy`` becomes ``numpy-xor`` while the door is open (unless the
    drill declares it lost), and the XOR legs drop back to their bases
    when it is closed."""
    if _xor_enabled():
        alias = _XOR_UP.get(name)
        return alias if alias and alias not in _drilled_dead() else name
    return _XOR_BASE.get(name, name)


def _fallback_for(name: str, drilled: set[str]) -> str | None:
    """The next leg after ``name`` down the chain that the drill spares."""
    if name not in _FALLBACK_CHAIN:
        return None
    for nxt in _FALLBACK_CHAIN[_FALLBACK_CHAIN.index(name) + 1:]:
        if nxt in drilled or (nxt in _XOR_BASE and not _xor_enabled()):
            continue
        return nxt
    return None


def route(name: str) -> str:
    """The leg that serves a routed dispatch of ``name``: the XOR door's
    leg, moved down the chain past every leg the drill names, with one
    WARNING per (requested, served) pair of each drill."""
    drilled = _drilled_dead()
    if not drilled:
        _warned.clear()
    leg = resolve_leg(name)
    while leg in drilled:
        nxt = _fallback_for(leg, drilled)
        if nxt is None:
            raise RuntimeError(f"engine {leg!r} drilled dead and no leg left down the chain")
        leg = resolve_leg(nxt)
    if leg != resolve_leg(name):
        key = (name, leg, frozenset(drilled))
        if key not in _warned:
            _warned.add(key)
            _log.warning("CUBEFS_CODEC_DEAD=%s: %r served by %r", ",".join(sorted(drilled)),
                         name, leg)
    return leg


def dispatch(name: str, method: str, device, *args, out: np.ndarray | None = None
             ) -> tuple[np.ndarray, str]:
    """A routed call of ``method`` on host stripes: (numpy result, written
    into ``out`` if given; the leg that served). An error of the leg
    raises to the caller."""
    leg = route(name)
    y = host_call(leg, method, device, *args, out=out)
    last_dispatch.update(method=method, requested=name, served=leg)
    return y, leg


def policy_leg(nbytes: int, device=None) -> str:
    """The table's leg for stripes of ``nbytes`` in all (before the door
    and the drill); beyond the table, the default engine."""
    for limit, name in _load_policy(device):
        if nbytes <= limit:
            return name
    return _default_leg()


def engine_for(nbytes: int, device=None):
    """The engine a routed dispatch of ``nbytes`` of stripes runs on."""
    return get_engine(route(policy_leg(nbytes, device)), device)


class AutoEngine:
    """Per call, the leg the crossover table names for the stripes' size,
    through the door and the drill. Host stripes (numpy or CPU tensors)
    in, numpy out; the ``cuda`` leg copies through ``hostio``."""

    name = "auto"

    def __init__(self, device: str | torch.device | None = None):
        self.device = devlib.resolve(device)

    def matrix_apply(self, coeff: np.ndarray, shards) -> np.ndarray:
        shards = _host(shards)
        return dispatch(policy_leg(int(shards.nbytes), self.device), "matrix_apply",
                        self.device, coeff, shards)[0]

    def encode_parity(self, data, n_parity: int) -> np.ndarray:
        data = _host(data)
        return dispatch(policy_leg(int(data.nbytes), self.device), "encode_parity",
                        self.device, data, n_parity)[0]
