"""Batched codec admission: coalesce concurrent submissions into
device-sized steps.

The port's counterpart of ``cubefs_tpu/codec/batcher.py``. Every
``encode_parity`` / ``matrix_apply`` submission with the same key
``(op, device, geometry)`` parks in a per-key queue, and whichever
submitter (or collector) finds the queue idle drains it: each swap of
the queue lands as one device step, or a few when ``max_batch`` /
``max_step_bytes`` split it. The step's own duration is the batching
window, so an uncontended caller waits for nothing and batch width
follows contention (the first-caller-drains shape of the raft proposal
batcher). Results and errors fan back per submission: a malformed
submission is rejected alone, and a failed step fails exactly its own
submissions. A bounded count of pending stripes gives backpressure.

A step of one submission hands that submission's tensor, and its
``out=`` view if any, straight to the engine: kernel A reads the
caller's stripes and writes the caller's rows, no copy. A step of
several concatenates them on the device and hands back views of one
output (copied into each submission's ``out=`` where one was given).

Streams: a step launches on the draining thread's current stream of
the device, and nothing in this module synchronizes the host. A CUDA
submission notes its caller's current stream; a drainer on another
stream makes its stream wait for the caller's before the step (for all
the caller has queued by then, which includes the stripes it made
before submitting), marks the caller's tensors as used on its stream
(``record_stream``: a free by the caller cannot hand their memory to
new work before the step is done) and records an event after
the step, on which ``result()`` makes the collecting thread's current
stream wait. A result the drainer allocated is marked as used on the
caller's stream. Where the drainer's stream is the caller's, stream
order alone does all of this: the result is ordered on the stream the
submission was made on, as any PyTorch result is.

Engines. A queue's key also holds the engine its submissions were
admitted with (``admit(engine=...)``, the reference's names). ``cuda``
(the default) takes tensors on its device, as above. Every other name
takes host-resident stripes, numpy arrays or CPU tensors, which
coalesce per geometry the same way; their step runs on the leg the
engine module routes it to (``engine.dispatch``: ``auto`` picks the
leg by the coalesced step's bytes, ``engine.policy_leg``, then the XOR
door and the ``CUBEFS_CODEC_DEAD`` drill apply), and a step on the
``cuda`` leg is ``hostio.staged``: one copy of the step's stack in and
one of its result out, straight into the submission's ``out=`` rows
where a one-submission step has them. Results come back as numpy, or
in the submission's ``out=`` rows. The step counter
is labelled with the leg that served.

The dp split. A step on the ``cuda`` leg (device tensors of ``cuda``,
or host stripes that ``engine.dispatch`` would serve on ``cuda``) is
cut along its batch axis into ``dp = min(len(devices), B)`` blocks of
whole stripes (``array_split``: no padding), one a device, as the
reference's ``_maybe_dp`` shards it over a ``(dp, 1, 1)`` mesh. No
block needs another's bytes, so nothing is exchanged: the blocks run in
this process, with no ranks and no collective. A device tensor's block
is copied to its card after the step has joined its callers' streams,
kernel A runs there, and the result is copied back into the step's
output rows on the home card (a block on the home card is written in
place). Host stripes go block by block through ``hostio.staged`` on
their card, into the step's ``out=`` rows or one result array. The
split engages only when ``dp_enabled``, the step holds at least
``dp_min_bytes`` bytes, B >= 2 and at least two devices are listed
(``devices=None``: every visible card, so one card never splits). A
device may be listed more than once: the blocks then run one after
another on it, which is how one card and the CPU drive the split. Once
engaged, any error (a card that is not there, a launch, a copy) goes to
the step's futures like any failed step: there is no retry unsplit
(the reference returns to the unsplit engine). The reference's retry
of a failed engine through a fallback chain is not carried over either.

Counters (``utils/metrics.py``, where the reference increments them):
stripes admitted per swap, device steps per engine call (a split step
counts once, under the leg that served), split steps by ``dp``
(``codec_batch_dp_steps``), stripes per step, each submission's wait
for its step, submitters that met backpressure, and submissions
rejected alone. Tracing (``utils/trace.py``):
each submission captures its caller's span; each step opens one
``stage:codec_step`` span that follows from them (tags ``stage``, ``op``,
``stripes``) and observes the ``codec_step`` stage.

Knobs (environment, read at construction):
  CUBEFS_CODEC_BATCH=0        submissions call the engine directly
  CUBEFS_CODEC_BATCH_MAX      most stripes per device step (1024)
  CUBEFS_CODEC_BATCH_WAIT_MS  drainer linger before its first swap (0)
  CUBEFS_CODEC_BATCH_PENDING  pending stripes before submitters block (4096)
  CUBEFS_CODEC_STEP_BYTES     most input bytes per device step (64 MiB)
  CUBEFS_CODEC_DP=0           no dp split
  CUBEFS_CODEC_DP_MIN_BYTES   least input bytes of a split step (1 MiB)
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from .. import device as devlib
from ..utils import metrics
from ..utils import trace as tracelib
from . import engine as engines
from .engine import CudaEngine


class CodecAdmissionError(Exception):
    """Submission rejected or lost by the admission layer itself."""


class BackpressureError(CodecAdmissionError):
    """The bounded pending queue stayed full past the deadline."""


class CodecFuture:
    """One caller's stripes parked in a queue. Resolved exactly once by
    the drainer, with a result or an error, then its private event
    fires. A collector whose queue has no drain in flight drains it
    itself (there is no drainer thread); the event is allocated lazily
    by the one collector, since a pipelined future is usually resolved
    by the time it is collected."""

    __slots__ = ("arr", "out", "stripes", "value", "exc", "done", "event", "stream",
                 "finished", "enq_t", "ref", "_batcher", "_key")

    def __init__(self, batcher: "BatchCodec", key: tuple, arr: torch.Tensor,
                 out: torch.Tensor | None):
        self.arr = arr
        self.out = out
        self.stripes = int(arr.shape[0])
        self.value = None
        self.exc: BaseException | None = None
        self.done = False
        self.event: threading.Event | None = None
        # CUDA only: the caller's current stream at submit, and the
        # step's event if it ran on another
        self.stream: torch.cuda.Stream | None = None
        self.finished: torch.cuda.Event | None = None
        self.enq_t = time.perf_counter()
        # span handoff: the drainer runs in ONE submitter's context;
        # every other submitter's span survives only through this ref,
        # which the drain span records as a follows-from link
        self.ref = tracelib.capture()
        self._batcher = batcher
        self._key = key

    def resolve(self, value, exc: BaseException | None) -> None:
        self.value = value
        self.exc = exc
        # done first, then read the event slot: with result()'s order
        # (event set, then done read) one of the two sees the other
        self.done = True
        ev = self.event
        if ev is not None:
            ev.set()

    def result(self, timeout: float = 120.0) -> torch.Tensor:
        """Block until resolved; return the (B, R, S) result or raise the
        submission's error. Drains the queue first if nobody is."""
        if not self.done:
            self._batcher._drain_if_idle(self._key)
            if not self.done:
                ev = self.event
                if ev is None:
                    ev = self.event = threading.Event()
                if not self.done and not ev.wait(timeout):
                    raise CodecAdmissionError(
                        f"{self._key[0]}: submission not drained within {timeout:.1f}s")
        if self.exc is not None:
            raise self.exc
        if self.finished is not None:  # the step ran on another stream
            torch.cuda.current_stream(self._key[1]).wait_event(self.finished)
        return self.value


class _GeometryQueue:
    """Pending submissions of one key."""

    __slots__ = ("subs", "busy", "coeff", "engine")

    def __init__(self, coeff: np.ndarray | None, engine: CudaEngine | None):
        self.subs: list[CodecFuture] = []
        self.busy = False
        self.coeff = coeff  # identical for every submission of the key
        self.engine = engine  # the device leg; None for a host engine's queue


def _is_u8(x) -> bool:
    return x.dtype == (torch.uint8 if isinstance(x, torch.Tensor) else np.uint8)


def _host_array(name: str, x) -> np.ndarray:
    """Host-resident stripes as numpy (a CPU tensor as a view), or a ValueError."""
    if isinstance(x, torch.Tensor) and x.device.type == "cpu":
        return x.numpy()
    if isinstance(x, np.ndarray):
        return x
    raise ValueError(f"{name} takes host-resident stripes (numpy or CPU tensors) for a "
                     f"host engine, got {type(x).__name__}"
                     + (f" on {x.device}" if isinstance(x, torch.Tensor) else ""))


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


class BatchCodec:
    """The submit surface. One instance per process is the norm
    (``DEFAULT`` below); tests build private ones. ``steps`` and
    ``submissions`` count the device steps and the submissions that went
    through the queues. ``devices`` lists the devices a step on the
    ``cuda`` leg is split over (None: every visible card)."""

    def __init__(self, enabled: bool | None = None, max_batch: int | None = None,
                 max_wait_ms: float | None = None, max_pending: int | None = None,
                 max_step_bytes: int | None = None, devices=None):
        self.enabled = (os.environ.get("CUBEFS_CODEC_BATCH", "1") != "0"
                        if enabled is None else enabled)
        self.max_batch = (max_batch if max_batch is not None
                          else _env_int("CUBEFS_CODEC_BATCH_MAX", 1024))
        self.max_wait = (max_wait_ms if max_wait_ms is not None
                         else _env_float("CUBEFS_CODEC_BATCH_WAIT_MS", 0.0)) / 1e3
        self.max_pending = (max_pending if max_pending is not None
                            else _env_int("CUBEFS_CODEC_BATCH_PENDING", 4096))
        self.max_step_bytes = (max_step_bytes if max_step_bytes is not None
                               else _env_int("CUBEFS_CODEC_STEP_BYTES", 64 << 20))
        self.dp_enabled = os.environ.get("CUBEFS_CODEC_DP", "1") != "0"
        self.dp_min_bytes = _env_int("CUBEFS_CODEC_DP_MIN_BYTES", 1 << 20)
        self.devices = None if devices is None else [torch.device(d) for d in devices]
        self.steps = 0
        self.submissions = 0
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queues: dict[tuple, _GeometryQueue] = {}
        self._engines: dict[torch.device, CudaEngine] = {}
        self._pending = 0  # stripes parked across all queues
        self._n_busy = 0  # queues with a drain in flight

    # ---------------- public submit surface ----------------
    def submit_encode(self, device, data, n_parity: int, out=None, timeout: float = 120.0,
                      engine: str = "cuda"):
        """(B, N, S) data -> (B, M, S) parity, coalesced with every
        concurrent submission of the same (engine, device, N, M, S);
        written into ``out`` if given. ``engine`` is ``cuda`` (tensors on
        ``device``) or a host engine's name or ``auto`` (host stripes;
        ``device`` is the card of the ``cuda`` leg)."""
        return self.submit_encode_async(device, data, n_parity, out, timeout,
                                        engine).result(timeout)

    def submit_apply(self, device, coeff: np.ndarray, shards, out=None,
                     timeout: float = 120.0, engine: str = "cuda"):
        """(R, C) GF matrix x (B, C, S) shards -> (B, R, S), coalesced with
        concurrent submissions sharing the engine, the device and the
        identical matrix."""
        return self.submit_apply_async(device, coeff, shards, out, timeout,
                                       engine).result(timeout)

    def submit_encode_async(self, device, data, n_parity: int, out=None,
                            timeout: float = 120.0, engine: str = "cuda") -> CodecFuture:
        """submit_encode that parks and returns at once: collect with
        ``.result()``. K submissions before the first collect keep K
        stripes admitted, and they land as one step."""
        eng = self._engine(device, engine)
        data, out = self._check("submit_encode", "(B, N, S)", engine, eng, data, int(n_parity),
                                out)
        key = ("encode", eng and eng.device, int(data.shape[1]), int(n_parity),
               int(data.shape[2]), engine)
        return self._submit(key, None, eng, data, out, timeout)

    def submit_apply_async(self, device, coeff: np.ndarray, shards, out=None,
                           timeout: float = 120.0, engine: str = "cuda") -> CodecFuture:
        """submit_apply that parks and returns at once."""
        eng = self._engine(device, engine)
        coeff = np.ascontiguousarray(coeff, dtype=np.uint8)
        shards, out = self._check("submit_apply", "(B, C, S)", engine, eng, shards,
                                  coeff.shape[0], out)
        key = ("apply", eng and eng.device, coeff.tobytes(), int(shards.shape[1]),
               int(shards.shape[2]), engine)
        return self._submit(key, coeff, eng, shards, out, timeout)

    # ---------------- admission ----------------
    def _engine(self, device, engine: str = "cuda") -> CudaEngine | None:
        """The device leg of ``engine`` (None for a host engine, which
        needs no card)."""
        if engine != "cuda" and engine != "auto":
            if engine not in engines.HOST_ENGINES:
                raise KeyError(f"unknown ec engine {engine!r}; have {sorted(engines.ENGINES)}")
            return None
        dev = devlib.resolve(device)
        eng = self._engines.get(dev)
        if eng is None:
            eng = self._engines.setdefault(dev, CudaEngine(dev))
        return eng

    @staticmethod
    def _check(name: str, shape: str, engine: str, eng: CudaEngine | None, x, rows: int,
               out):
        """The submission's stripes and ``out``: tensors on the device for
        ``cuda``, numpy for any other engine; or a ValueError."""
        if engine != "cuda":
            x = _host_array(name, x)
            if x.ndim != 3:
                raise ValueError(f"{name} takes a {shape} array, got {x.shape}")
            if out is not None:
                out = _host_array(name, out)
                want = (x.shape[0], rows, x.shape[2])
                if out.shape != want or out.dtype != np.uint8 or not out.flags.writeable:
                    raise ValueError(f"{name}: out must be a writable {want} uint8 array, "
                                     f"got {out.shape} {out.dtype}")
            return x, out
        if not isinstance(x, torch.Tensor) or x.dim() != 3:
            raise ValueError(f"{name} takes a {shape} tensor, got "
                             f"{tuple(getattr(x, 'shape', ()))} {type(x).__name__}")
        if x.device != eng.device:
            raise ValueError(f"{name}: shards are on {x.device}, the engine on {eng.device}")
        want = (x.shape[0], rows, x.shape[2])
        if out is not None and (tuple(out.shape) != want or out.dtype != torch.uint8
                                or out.device != eng.device):
            raise ValueError(f"{name}: out must be a {want} uint8 tensor on {eng.device}, "
                             f"got {tuple(out.shape)} {out.dtype} on {out.device}")
        return x, out

    def _submit(self, key: tuple, coeff, eng: CudaEngine | None, arr, out,
                timeout: float) -> CodecFuture:
        if self.enabled:
            return self._enqueue(key, coeff, eng, arr, out, timeout)
        # the door closed: execute now, return resolved
        fut = CodecFuture(self, key, arr, out)
        try:
            fut.resolve(self._engine_call(key, eng, coeff, arr, out), None)
        except Exception as e:
            fut.resolve(None, e)
        return fut

    def _enqueue(self, key: tuple, coeff, eng: CudaEngine | None, arr, out,
                 timeout: float) -> CodecFuture:
        sub = CodecFuture(self, key, arr, out)
        if key[5] == "cuda" and eng.device.type == "cuda":
            sub.stream = torch.cuda.current_stream(eng.device)
        with self._lock:
            # block only while a drain in flight will free space: the
            # submitter that finds everything idle is the drainer
            deadline = None
            while self._pending + sub.stripes > self.max_pending and self._n_busy > 0:
                if deadline is None:
                    metrics.codec_batch_backpressure.inc(op=key[0])
                    deadline = time.monotonic() + timeout
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cond.wait(remaining):
                    raise BackpressureError(
                        f"{key[0]}: {self._pending} stripes pending > bound "
                        f"{self.max_pending} for {timeout:.1f}s")
            q = self._queues.get(key)
            if q is None:
                q = self._queues[key] = _GeometryQueue(coeff, eng)
            q.subs.append(sub)
            self._pending += sub.stripes
        return sub

    def _drain_if_idle(self, key: tuple) -> None:
        """Become the drainer of ``key`` unless one is already running."""
        q = self._queues.get(key)
        # unlocked peek: a running drainer exits only once the queue is
        # empty, so a True `busy` means it will take this submission
        if q is not None and q.busy:
            return
        with self._lock:
            q = self._queues.get(key)
            if q is None or q.busy or not q.subs:
                return
            q.busy = True
            self._n_busy += 1
        if self.max_wait > 0:
            time.sleep(self.max_wait)  # linger: latency of the first collector for width
        self._drain(key, q)

    def _drain(self, key: tuple, q: _GeometryQueue) -> None:
        """Swap the queue out and land each swap as one or a few device
        steps, until the queue is empty. Submissions that arrive during a
        step ride the next swap."""
        try:
            while True:
                with self._lock:
                    batch = q.subs
                    if not batch:
                        q.busy = False
                        self._n_busy -= 1
                        self._forget(key, q)
                        self._cond.notify_all()
                        return
                    q.subs = []
                total = sum(s.stripes for s in batch)
                metrics.codec_batch_submissions.inc(total, op=key[0])
                steps = 0
                try:
                    steps = self._run_steps(key, q, batch)
                finally:
                    with self._lock:
                        self._pending -= total
                        self.steps += steps
                        self.submissions += len(batch)
                        self._cond.notify_all()
        except BaseException as e:
            # a dying drainer must not strand the queue busy: fail what
            # is still parked and reopen the queue
            with self._lock:
                orphans = q.subs
                q.subs = []
                self._pending -= sum(s.stripes for s in orphans)
                q.busy = False
                self._n_busy -= 1
                self._forget(key, q)
                self._cond.notify_all()
            for sub in orphans:
                if not sub.done:
                    sub.resolve(None, CodecAdmissionError(f"{key[0]}: drainer died: {e!r}"))
            raise

    def _forget(self, key: tuple, q: _GeometryQueue) -> None:
        """Drop an idle, empty queue (under the lock): keys hold S and
        matrix bytes, so a long-lived process would otherwise keep one
        queue for every payload size and erasure pattern it ever saw.
        The next submission of the key makes a new one."""
        if self._queues.get(key) is q:
            del self._queues[key]

    def _run_steps(self, key: tuple, q: _GeometryQueue, batch: list[CodecFuture]) -> int:
        """Validate, chunk, execute and fan back one swap; returns the
        number of device steps. Every submission is resolved exactly once,
        even when a step fails or a batch-mate is malformed."""
        op = key[0]
        # input bytes per stripe are fixed by the key: encode reads N*S,
        # apply C*S (the key is (op, device, N or matrix, M or C, S, engine))
        per_stripe = (key[3] if op == "apply" else key[2]) * key[4]
        stripe_cap = min(self.max_batch, max(1, self.max_step_bytes // max(1, per_stripe)))
        steps = 0
        try:
            step: list[CodecFuture] = []
            stripes = 0
            for sub in batch:
                # the key fixes the shape; the dtype is the one thing left
                # to reject, alone (a concatenation would upcast the step)
                if not _is_u8(sub.arr):
                    metrics.codec_batch_errors.inc(op=op, kind="dtype")
                    sub.resolve(None, CodecAdmissionError(
                        f"{op}: stripe dtype must be uint8, got {sub.arr.dtype}"))
                    continue
                if step and stripes + sub.stripes > stripe_cap:
                    self._one_step(key, q, step)
                    steps += 1
                    step, stripes = [], 0
                step.append(sub)
                stripes += sub.stripes
            if step:
                self._one_step(key, q, step)
                steps += 1
        finally:
            for sub in batch:  # nobody waits forever
                if not sub.done:
                    sub.resolve(None, CodecAdmissionError(
                        f"{op}: drain failed before this submission"))
        return steps

    def _one_step(self, key: tuple, q: _GeometryQueue, step: list[CodecFuture]) -> None:
        """Run one step and resolve each of its submissions, with its
        result or with the step's error."""
        op = key[0]
        try:
            others = self._join_streams(key, step)
            one = len(step) == 1  # the caller's own stripes and rows, no copy
            arr = step[0].arr if one else (torch.cat if key[5] == "cuda" else np.concatenate)(
                [s.arr for s in step])
            now = time.perf_counter()
            metrics.codec_batch_wait.observe_many([now - s.enq_t for s in step], op=op)
            # one drain-step span around the engine call, following from
            # every submitter's captured context (the drainer's own span is
            # the parent)
            span = tracelib.start_span("stage:codec_step",
                                       links=[s.ref for s in step if s.ref is not None])
            span.set_tag("stage", "codec_step").set_tag("op", op)
            span.set_tag("stripes", int(arr.shape[0]))
            with span:
                try:
                    out = self._engine_call(key, q.engine, q.coeff, arr,
                                            step[0].out if one else None)
                except Exception as e:  # the step's failure goes to its submissions
                    for sub in step:
                        sub.resolve(None, e)
                    return
            tracelib.observe_stage("codec_step", span.path, time.perf_counter() - now)
            metrics.codec_batch_stripes.observe(int(arr.shape[0]), op=op)
            results, off = [], 0
            for sub in step:
                v = out if one else out[off:off + sub.stripes]
                results.append(v if one or sub.out is None else _copy_into(sub.out, v))
                off += sub.stripes
            if others:
                self._hand_back(key, step, others, out)
        except Exception as e:
            for sub in step:
                sub.resolve(None, e)
            return
        for sub, v in zip(step, results):
            sub.resolve(v, None)
            sub.arr = None

    @staticmethod
    def _join_streams(key: tuple, step: list[CodecFuture]) -> list[CodecFuture]:
        """Order the step after each caller's stream; returns the
        submissions made on a stream other than the drainer's."""
        if key[5] != "cuda" or key[1].type != "cuda":
            return []
        cur = torch.cuda.current_stream(key[1])
        others = [s for s in step if s.stream != cur]
        for sub in others:
            cur.wait_stream(sub.stream)
            sub.arr.record_stream(cur)
            if sub.out is not None:
                sub.out.record_stream(cur)
        return others

    @staticmethod
    def _hand_back(key: tuple, step: list[CodecFuture], others: list[CodecFuture],
                   out: torch.Tensor) -> None:
        """After the step: the drainer's output marked as used on the
        other callers' streams, and an event for their collectors."""
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(key[1]))
        caller_out = len(step) == 1 and step[0].out is not None  # else out is the drainer's
        for sub in others:
            if not caller_out:
                out.record_stream(sub.stream)
            sub.finished = done

    # ---------------- device step ----------------
    def _engine_call(self, key: tuple, eng: CudaEngine | None, coeff: np.ndarray | None,
                     arr, out):
        """One step: ``cuda`` on the device's tensors, any other engine
        routed on host stripes (``auto`` by the step's bytes). Counted
        under the leg that served."""
        op, engine = key[0], key[5]
        method = "encode_parity" if op == "encode" else "matrix_apply"
        if engine == "cuda":
            devs = self._dp_devices(arr)
            if devs:
                y = self._split(key, method, coeff, arr, out, devs, host=False)
            elif op == "encode":
                y = eng.encode_parity(arr, key[3], out=out)
            else:
                y = eng.matrix_apply(coeff, arr, out=out)
            served = eng.name
        else:
            dev = None if eng is None else eng.device
            name = engines.policy_leg(int(arr.nbytes), dev) if engine == "auto" else engine
            args = (arr, key[3]) if op == "encode" else (coeff, arr)
            devs = self._dp_devices(arr)
            if devs and engines.route(name) == "cuda":
                y, served = self._split(key, method, coeff, arr, out, devs, host=True), "cuda"
                engines.last_dispatch.update(method=method, requested=name, served=served)
            else:
                y, served = engines.dispatch(name, method, dev, *args, out=out)
        metrics.codec_batch_steps.inc(op=op, engine=served)
        return y

    def _dp_devices(self, arr) -> list[torch.device] | None:
        """The devices a step of ``arr`` on the ``cuda`` leg is split
        over, one block each, or None where the split does not apply."""
        b = int(arr.shape[0])
        if not self.dp_enabled or int(arr.nbytes) < self.dp_min_bytes or b < 2:
            return None
        devs = self.devices
        if devs is None:
            devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return devs[:b] if len(devs) >= 2 else None

    @staticmethod
    def _split(key: tuple, method: str, coeff: np.ndarray | None, arr, out,
               devs: list[torch.device], host: bool):
        """One step cut into ``len(devs)`` blocks of whole stripes, block
        i run on ``devs[i]``; the result in ``out`` (the step's rows) or
        a new array (host) or tensor on ``arr``'s device."""
        op = key[0]
        n_out = key[3] if op == "encode" else coeff.shape[0]
        for d in devs:  # fail before any block runs
            d = devlib.resolve(d)
            if d.type == "cuda" and d.index >= torch.cuda.device_count():
                raise RuntimeError(f"{op}: the dp split names {d}, which is not there "
                                   f"({torch.cuda.device_count()} cards visible)")
        if out is None:
            shape = (arr.shape[0], n_out, arr.shape[2])
            out = (np.empty(shape, dtype=np.uint8) if host
                   else torch.empty(shape, dtype=torch.uint8, device=arr.device))

        def args(x):
            return (x, n_out) if op == "encode" else (coeff, x)

        for d, rows in zip(devs, np.array_split(np.arange(arr.shape[0]), len(devs))):
            blk = slice(int(rows[0]), int(rows[-1]) + 1)
            if host:
                engines.host_call("cuda", method, d, *args(arr[blk]), out=out[blk])
                continue
            eng = CudaEngine(d)
            here = out[blk] if eng.device == arr.device else None
            y = getattr(eng, method)(*args(arr[blk].to(eng.device)), out=here)
            if here is None:
                out[blk].copy_(y)
        metrics.codec_batch_dp_steps.inc(dp=len(devs))
        return out


def _copy_into(dst, src):
    """``src`` copied into the caller's rows ``dst``; returns ``dst``."""
    if isinstance(dst, torch.Tensor):
        return dst.copy_(src)
    np.copyto(dst, src)
    return dst


def _view3(x):
    """(..., C, S) as (B, C, S) without a copy (raises where it would need one)."""
    if isinstance(x, np.ndarray):
        if not x.flags.writeable:
            raise ValueError("out is read-only")
        return torch.from_numpy(x).view(-1, *x.shape[-2:]).numpy()
    return x.view(-1, *x.shape[-2:])


class AdmittedEngine:
    """Engine-shaped facade over the admission layer, the way every
    encoder reaches shard math. Takes the same (..., C, S) shapes as an
    engine, flattening leading dimensions into the batch; an ``out``
    given for such a shape must be viewable so. With ``engine="cuda"``
    (the default) stripes are tensors on ``device``; with any other
    engine they are host-resident, numpy in and numpy out (a CPU tensor
    in, a CPU tensor out), and ``device`` is the card of ``auto``'s
    ``cuda`` leg (None for a host engine)."""

    def __init__(self, batcher: BatchCodec, device=None, engine: str = "cuda"):
        if engine not in engines.ENGINES:
            raise KeyError(f"unknown ec engine {engine!r}; have {sorted(engines.ENGINES)}")
        self.batcher = batcher
        self.engine = engine
        self.device = None if engine in engines.HOST_ENGINES else devlib.resolve(device)

    @property
    def host(self) -> bool:
        """Whether the stripes are host-resident (every engine but ``cuda``)."""
        return self.engine != "cuda"

    def _flat(self, x, out):
        ok = (isinstance(x, (torch.Tensor, np.ndarray)) if self.host
              else isinstance(x, torch.Tensor))
        if not ok or x.ndim < 2:
            kind = "(..., C, S) array" if self.host else "(..., C, S) tensor"
            raise ValueError(f"shards must be a {kind}, got "
                             f"{tuple(getattr(x, 'shape', ()))} {type(x).__name__}")
        x3 = x.reshape(-1, *x.shape[-2:])
        return x3, None if out is None else _view3(out)

    def _result(self, x, y, out):
        if out is not None:
            return out
        y = y.reshape(*x.shape[:-2], *y.shape[-2:])
        return torch.from_numpy(y) if self.host and isinstance(x, torch.Tensor) else y

    def encode_parity(self, data, n_parity: int, out=None):
        x, o = self._flat(data, out)
        y = self.batcher.submit_encode(self.device, x, n_parity, out=o, engine=self.engine)
        return self._result(data, y, out)

    def matrix_apply(self, coeff: np.ndarray, shards, out=None):
        x, o = self._flat(shards, out)
        y = self.batcher.submit_apply(self.device, coeff, x, out=o, engine=self.engine)
        return self._result(shards, y, out)


DEFAULT = BatchCodec()


def admit(device=None, batcher: BatchCodec | None = None, engine: str = "cuda"
          ) -> AdmittedEngine:
    """The admission surface: an engine-shaped handle whose calls coalesce
    with every other admitted caller of the process. ``engine`` takes the
    reference's names (``cuda``, ``numpy``, ``cpp``, ``numpy-xor``,
    ``cpp-xor``, ``auto``); ``device`` is the card of ``cuda`` (None: the
    current CUDA device, ``"cpu"``: the plain path) and of ``auto``'s
    ``cuda`` leg. ``auto`` picks the leg for each drained step by its
    coalesced size."""
    return AdmittedEngine(batcher or DEFAULT, device, engine)
