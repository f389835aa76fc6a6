"""Tracing: span tree with RPC-header propagation + tail forensics.

Role parity: blobstore/common/trace (OpenTracing-compatible spans,
span.go:36-44; HTTP header propagation, propagation.go; per-request
track-logs appended to responses, access/stream/stream_put.go:101).
contextvars carry the active span; the RPC layer injects/extracts the
`X-Trace` header automatically so a request's spans stitch across
services.

On top of the span tree this module carries the request-observability
substrate:

- `stage(name)` opens a child span AND observes the shared
  `cubefs_request_stage_seconds{path,stage}` histogram, keyed by the
  request family (`path`) stamped on the root span and propagated in
  the header, so every hot path shares one per-stage latency surface.
- first-caller-drains batchers (codec steps, fan-out drains, raft
  proposal batches) lose contextvars for all but the draining caller;
  `capture()` snapshots a submitter's context into a `SpanRef` and the
  drain span records **follows-from** links to every submitter.
- head sampling (`CUBEFS_TRACE_SAMPLE`, decided once at the root and
  propagated) and a `CUBEFS_TRACE=0` kill door that turns the whole
  layer into no-ops for A/B overhead runs.
- roots slower than `CUBEFS_SLOW_MS` capture their reconstructed span
  tree to a rotating JSONL beside the audit log (slow-request
  forensics), and feed the SLO tracker in `utils/slo.py`.

Determinism: spans never touch `time.time()` / module-global `random`
directly — timestamps come from an injectable Clock (the
`utils/retry.py` protocol, `set_clock`) and ids from a seedable source
(`seed_ids`), so chaos / tier-1 runs can reproduce span trees exactly.

The port's copy of ``cubefs_tpu/utils/trace.py``, with the same behaviour.
"""

from __future__ import annotations

import contextvars
import heapq
import json
import os
import random
import threading
from typing import NamedTuple

from . import metrics
from .retry import MONOTONIC

_current: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "cubefs_span", default=None
)
# tenant identity of the request being served: stamped by the front
# doors (objectnode auth, blob access admission), consumed by
# path_span tags, audit records, and QoS admission defaults.
_tenant: contextvars.ContextVar[str] = contextvars.ContextVar(
    "cubefs_tenant", default=""
)

_collector_lock = threading.Lock()
# trace_id -> {"root_start": float, "seq": int, "spans": [dict]}; dict
# insertion order doubles as arrival order for eviction tie-breaks.
_traces: dict[str, dict] = {}
_span_total = 0
_arrival_seq = 0
MAX_KEPT = 2048
# eviction order (oldest-root-first, arrival tie-break) as a lazy-
# deletion heap of (root_start-or-inf, seq, trace_id): a linear
# min() scan per collected span turns every packet-plane request
# into an O(MAX_KEPT) stall once the store fills — at wire rates
# that is a hard throughput cliff, not an observability tax.
# Entries go stale when a trace's root_start improves or the trace
# is evicted; pops skip entries whose key no longer matches.
_evict_heap: list[tuple] = []

# slow-request forensics: in-memory index for `cubefs-cli trace slow`
# plus a rotating JSONL capture (configured beside the audit log).
_slow_index: list[dict] = []
MAX_SLOW_KEPT = 256
_slow_log: "_SlowTraceLog | None" = None

_clock = MONOTONIC
_id_lock = threading.Lock()
_ids = random.Random()


# ---------------------------------------------------------------- knobs

def enabled() -> bool:
    """The CUBEFS_TRACE=0 A/B door: everything no-ops when off."""
    return os.environ.get("CUBEFS_TRACE", "1") != "0"


def _sample_rate() -> float:
    try:
        return float(os.environ.get("CUBEFS_TRACE_SAMPLE", "1.0"))
    except ValueError:
        return 1.0


def _slow_ms() -> float:
    try:
        return float(os.environ.get("CUBEFS_SLOW_MS", "0"))
    except ValueError:
        return 0.0


def slow_threshold_ms() -> float:
    """Active slow-request threshold in ms (0 = forensics disabled)."""
    return _slow_ms()


def set_clock(clock) -> None:
    """Install a Clock (utils/retry.py protocol). FakeClock makes span
    timestamps deterministic for chaos / tier-1 runs."""
    global _clock
    _clock = clock


def seed_ids(seed) -> None:
    """Reseed the span/trace id source for reproducible trees."""
    with _id_lock:
        _ids.seed(seed)


def _rand_id() -> str:
    with _id_lock:
        return f"{_ids.getrandbits(64):016x}"


def set_tenant(tenant: str):
    """Bind the serving tenant for the current context; returns a
    token for reset_tenant(). Front doors call this per request."""
    return _tenant.set(tenant or "")


def reset_tenant(token) -> None:
    _tenant.reset(token)


def current_tenant() -> str:
    return _tenant.get()


def _sample_decision() -> bool:
    rate = _sample_rate()
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    with _id_lock:
        return _ids.random() < rate


# ---------------------------------------------------------------- spans

class SpanRef(NamedTuple):
    """Immutable snapshot of a span context: what a batcher submission
    carries across the first-caller-drains boundary so the drain span
    can record a follows-from link back to it."""
    trace_id: str
    span_id: str
    sampled: bool
    path: str


class Span:
    def __init__(self, operation: str, trace_id: str | None = None,
                 parent_id: str | None = None, sampled: bool | None = None,
                 path: str = "", tenant: str = ""):
        self.operation = operation
        self.trace_id = trace_id or _rand_id()
        self.span_id = _rand_id()
        self.parent_id = parent_id
        # head sampling: roots decide once, children/remote hops inherit
        self.sampled = _sample_decision() if sampled is None else sampled
        self.path = path
        self.tenant = tenant
        self.start = _clock.now()
        self.finish_ts: float | None = None
        self.tags: dict = {"tenant": tenant} if tenant else {}
        self.logs: list[tuple[float, str]] = []
        self.follows: list[dict] = []
        self._token = None

    # ---- lifecycle ----
    def __enter__(self) -> "Span":
        self._token = _current.set(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is not None:
            self.set_tag("error", f"{type(exc).__name__}: {exc}")
        self.finish()
        if self._token is not None:
            _current.reset(self._token)
            self._token = None

    def finish(self) -> None:
        if self.finish_ts is not None:
            return
        self.finish_ts = _clock.now()
        if self.parent_id is None and self.path:
            # end-to-end sample: the "total" pseudo-stage is what the
            # SLO tracker windows its quantiles and burn rates over
            metrics.request_stage_seconds.observe(
                self.duration(), path=self.path, stage="total")
        if not self.sampled:
            return
        _collect(self)
        if self.parent_id is None:
            _maybe_slow(self)

    # ---- data ----
    def set_tag(self, key: str, value) -> "Span":
        self.tags[key] = value
        return self

    def set_path(self, path: str) -> "Span":
        """Stamp the request family used as the `path` label by every
        stage() under this span (and propagated in the header)."""
        self.path = path
        return self

    def set_tenant(self, tenant: str) -> "Span":
        """Stamp the serving tenant (propagated in the header) so
        slowtrace forensics can attribute tail latency to a tenant."""
        if tenant:
            self.tenant = tenant
            self.tags["tenant"] = tenant
        return self

    def link(self, ref: "SpanRef | Span | None") -> "Span":
        """Record a follows-from link: this span was caused by `ref`
        but is not its child (a drained batch follows every submitter)."""
        if ref is None:
            return self
        self.follows.append(
            {"trace_id": ref.trace_id, "span_id": ref.span_id})
        return self

    def ref(self) -> SpanRef:
        return SpanRef(self.trace_id, self.span_id, self.sampled, self.path)

    def log(self, message: str) -> None:
        self.logs.append((_clock.now(), message))

    def duration(self) -> float:
        return (self.finish_ts if self.finish_ts is not None
                else _clock.now()) - self.start

    def track_log(self) -> str:
        """Compact per-hop record (the reference appends these to
        responses for request forensics)."""
        return f"{self.operation}:{self.duration() * 1000:.1f}ms"

    def to_dict(self) -> dict:
        d = {
            "trace_id": self.trace_id, "span_id": self.span_id,
            "parent_id": self.parent_id, "op": self.operation,
            "start": self.start, "duration": self.duration(),
            "tags": dict(self.tags), "logs": list(self.logs),
        }
        if self.path:
            d["path"] = self.path
        if self.follows:
            d["follows"] = list(self.follows)
        return d

    # ---- propagation ----
    def header(self) -> str:
        h = (f"{self.trace_id}:{self.span_id}:"
             f"{1 if self.sampled else 0}:{self.path}")
        if self.tenant:
            h += f":{self.tenant}"
        return h


class _NoopSpan:
    """Stand-in when CUBEFS_TRACE=0: the full Span surface, zero work.
    Never enters the contextvar, so nothing downstream records either."""
    __slots__ = ()
    trace_id = ""
    span_id = ""
    parent_id = None
    sampled = False
    path = ""
    tenant = ""
    operation = ""
    tags: dict = {}
    follows: list = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def finish(self):
        pass

    def set_tag(self, key, value):
        return self

    def set_path(self, path):
        return self

    def set_tenant(self, tenant):
        return self

    def link(self, ref):
        return self

    def ref(self):
        return None

    def log(self, message):
        pass

    def duration(self):
        return 0.0

    def track_log(self):
        return ""

    def to_dict(self):
        return {}

    def header(self):
        return ""


NOOP = _NoopSpan()


def start_span(operation: str, links=()) -> "Span | _NoopSpan":
    """Child of the context's active span (or a fresh root)."""
    if not enabled():
        return NOOP
    parent = _current.get()
    if parent is not None:
        sp = Span(operation, parent.trace_id, parent.span_id,
                  sampled=parent.sampled, path=parent.path,
                  tenant=parent.tenant)
    else:
        sp = Span(operation)
    for ref in links:
        sp.link(ref)
    return sp


def path_span(path: str, operation: str | None = None,
              tenant: str | None = None) -> "Span | _NoopSpan":
    """Span for a hot-path entry point: child of the active request
    span (the RPC hop) when one exists, else a fresh root. Stamps the
    `path` request family consumed by every stage() beneath it — and
    back-stamps an un-labelled enclosing hop span, so the serving RPC
    root records the end-to-end "total" sample on finish. The serving
    tenant (explicit, context-bound, or inherited from the hop span)
    rides along as a span tag and a propagated header field."""
    if tenant is None:
        tenant = _tenant.get()
    parent = _current.get()
    if parent is not None:
        if not parent.path:
            parent.set_path(path)
        if tenant and not parent.tenant:
            parent.set_tenant(tenant)
        elif not tenant:
            tenant = parent.tenant
    sp = start_span(operation or path)
    return sp.set_path(path).set_tenant(tenant)


def from_header(operation: str, header: str | None) -> "Span | _NoopSpan":
    if not enabled():
        return NOOP
    if header:
        parts = header.split(":", 4)
        if len(parts) >= 2 and parts[0]:
            trace_id, parent_id = parts[0], parts[1]
            sampled = parts[2] != "0" if len(parts) >= 3 else True
            path = parts[3] if len(parts) >= 4 else ""
            tenant = parts[4] if len(parts) >= 5 else ""
            return Span(operation, trace_id, parent_id,
                        sampled=sampled, path=path, tenant=tenant)
    return Span(operation)


def current() -> Span | None:
    return _current.get()


def capture() -> SpanRef | None:
    """Snapshot the active span context for a batcher submission; the
    eventual drain span records follows-from links through these."""
    sp = _current.get()
    return sp.ref() if sp is not None else None


# ---------------------------------------------------------------- stages

class _StageTimer:
    """Context manager behind stage(): a child span + one observation
    of cubefs_request_stage_seconds{path,stage}."""
    __slots__ = ("name", "path", "span", "t0")

    def __init__(self, name: str, path: str | None):
        self.name = name
        self.path = path
        self.span = None
        self.t0 = 0.0

    def __enter__(self):
        parent = _current.get()
        if self.path is None:
            self.path = parent.path if parent is not None else ""
        if parent is not None:
            self.span = start_span(f"stage:{self.name}")
            self.span.set_tag("stage", self.name)
            self.span.__enter__()
        self.t0 = _clock.now()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = _clock.now() - self.t0
        if self.path:
            metrics.request_stage_seconds.observe(
                dt, path=self.path, stage=self.name)
        if self.span is not None:
            self.span.__exit__(exc_type, exc, tb)
        return None


class _NoopStage:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NOOP_STAGE = _NoopStage()


def stage(name: str, path: str | None = None):
    """Time one stage of a hot path: child span + histogram sample.

    The `path` label comes from the enclosing span (stamped by
    path_span / propagated in the header); pass it explicitly from
    contexts that have no request span (e.g. the raft apply loop,
    which serves submitters it cannot see). No-ops entirely when the
    CUBEFS_TRACE door is closed or no path can be resolved.
    """
    if not enabled():
        return _NOOP_STAGE
    if path is None and _current.get() is None:
        return _NOOP_STAGE
    return _StageTimer(name, path)


def observe_stage(name: str, path: str, seconds) -> None:
    """Record already-measured stage samples (scalar or iterable) —
    for queue waits measured from a submission timestamp rather than
    around a with-block. Honors the CUBEFS_TRACE door."""
    if not enabled() or not path:
        return
    if hasattr(seconds, "__iter__"):
        metrics.request_stage_seconds.observe_many(
            list(seconds), path=path, stage=name)
    else:
        metrics.request_stage_seconds.observe(
            seconds, path=path, stage=name)


# ------------------------------------------------------------- collector

def _heap_key(t: dict) -> float:
    rs = t["root_start"]
    return rs if rs is not None else float("inf")


def _collect(span: Span) -> None:
    global _span_total, _arrival_seq
    d = span.to_dict()
    with _collector_lock:
        t = _traces.get(span.trace_id)
        if t is None:
            _arrival_seq += 1
            t = {"root_start": None, "seq": _arrival_seq, "spans": []}
            _traces[span.trace_id] = t
            heapq.heappush(_evict_heap,
                           (float("inf"), _arrival_seq, span.trace_id))
        t["spans"].append(d)
        if span.parent_id is None:
            rs = t["root_start"]
            t["root_start"] = span.start if rs is None else min(rs, span.start)
            if t["root_start"] != rs:
                # key improved: push a fresh entry, the old one goes
                # stale and is skipped at pop time
                heapq.heappush(_evict_heap,
                               (t["root_start"], t["seq"], span.trace_id))
        _span_total += 1
        metrics.trace_spans_total.inc()
        # evict WHOLE traces, oldest-root-first, so a reconstructed
        # tree is never torn by dropping only its early spans
        while _span_total > MAX_KEPT and len(_traces) > 1 and _evict_heap:
            key, seq, victim = heapq.heappop(_evict_heap)
            vt = _traces.get(victim)
            if vt is None or (_heap_key(vt), vt["seq"]) != (key, seq):
                continue  # stale entry (evicted, or root_start improved)
            _span_total -= len(_traces.pop(victim)["spans"])
            metrics.trace_evictions.inc()


def finished_spans(trace_id: str | None = None) -> list[dict]:
    with _collector_lock:
        if trace_id:
            t = _traces.get(trace_id)
            return list(t["spans"]) if t else []
        return [s for t in _traces.values() for s in t["spans"]]


def reset_collector() -> None:
    """Test hook: drop all collected spans and slow-trace index."""
    global _span_total, _arrival_seq
    with _collector_lock:
        _traces.clear()
        _span_total = 0
        _arrival_seq = 0
        del _evict_heap[:]
        del _slow_index[:]


def known_trace_ids() -> list[str]:
    with _collector_lock:
        return list(_traces)


# ------------------------------------------------ tree reconstruction

def trace_tree(trace_id: str) -> list[dict]:
    """Reconstruct the span forest for one trace: a list of root nodes
    `{"span": dict, "children": [...]}` ordered by start time. Spans
    whose parent was never collected (remote parent, eviction race)
    surface as roots so the tree is always renderable."""
    spans = finished_spans(trace_id)
    nodes = {s["span_id"]: {"span": s, "children": []} for s in spans}
    roots = []
    for s in spans:
        parent = s.get("parent_id")
        node = nodes[s["span_id"]]
        if parent and parent in nodes:
            nodes[parent]["children"].append(node)
        else:
            roots.append(node)
    def _sort(nlist):
        nlist.sort(key=lambda n: n["span"]["start"])
        for n in nlist:
            _sort(n["children"])
    _sort(roots)
    return roots


def render_tree(tree: list[dict]) -> str:
    """Indented text rendering of trace_tree() output with per-hop
    durations — what `cubefs-cli trace show` prints."""
    lines: list[str] = []

    def _walk(node, depth):
        s = node["span"]
        pad = "  " * depth
        svc = s["tags"].get("svc", "")
        extra = f" [{svc}]" if svc else ""
        follows = s.get("follows")
        if follows:
            extra += f" follows={len(follows)}"
        err = s["tags"].get("error")
        if err:
            extra += f" ERROR({err})"
        lines.append(
            f"{pad}{s['op']}  {s['duration'] * 1000:.2f}ms{extra}")
        for c in node["children"]:
            _walk(c, depth + 1)

    for root in tree:
        _walk(root, 0)
    return "\n".join(lines)


def stage_summary(trace_id: str) -> str:
    """Compact `stage=ms` breakdown of a trace's stage spans — the
    forensics string appended to slow-request audit records."""
    parts = []
    for s in finished_spans(trace_id):
        st = s["tags"].get("stage")
        if st:
            parts.append(f"{st}={s['duration'] * 1000:.1f}ms")
    return " ".join(parts)


# -------------------------------------------- slow-request forensics

class _SlowTraceLog:
    """Rotating JSONL of captured slow-trace trees (audit-log shaped)."""

    def __init__(self, path: str, max_bytes: int = 16 << 20, keep: int = 4):
        self.path = path
        self.max_bytes = max_bytes
        self.keep = keep
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def write(self, rec: dict) -> None:
        line = json.dumps(rec) + "\n"
        with self._lock:
            self._f.write(line)
            self._f.flush()
            if self._f.tell() >= self.max_bytes:
                self._rotate()

    def _rotate(self) -> None:
        self._f.close()
        for i in range(self.keep - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        os.replace(self.path, f"{self.path}.1")
        self._f = open(self.path, "a")

    def close(self) -> None:
        with self._lock:
            self._f.close()


def configure_slow_log(path: str) -> None:
    """Install the slow-trace capture file (the RPC server points this
    beside its audit log). Idempotent per path."""
    global _slow_log
    if _slow_log is not None and _slow_log.path == path:
        return
    old, _slow_log = _slow_log, _SlowTraceLog(path)
    if old is not None:
        old.close()


def slow_log_path() -> str | None:
    return _slow_log.path if _slow_log is not None else None


def _maybe_slow(root: Span) -> None:
    threshold_ms = _slow_ms()
    if threshold_ms <= 0:
        return
    dur_ms = root.duration() * 1000.0
    if dur_ms < threshold_ms:
        return
    path = root.path or root.operation
    metrics.slow_traces.inc(path=path)
    rec = {
        "trace_id": root.trace_id, "root_op": root.operation,
        "path": path, "duration_ms": round(dur_ms, 3),
        "threshold_ms": threshold_ms, "start": root.start,
        "stages": stage_summary(root.trace_id),
    }
    with _collector_lock:
        _slow_index.append(rec)
        if len(_slow_index) > MAX_SLOW_KEPT:
            del _slow_index[: len(_slow_index) - MAX_SLOW_KEPT]
    log = _slow_log
    if log is not None:
        log.write(dict(rec, tree=trace_tree(root.trace_id)))


def slow_traces(top: int = 10) -> list[dict]:
    """Slowest captured roots, worst-first (`cubefs-cli trace slow`)."""
    with _collector_lock:
        idx = list(_slow_index)
    idx.sort(key=lambda r: r["duration_ms"], reverse=True)
    return idx[: max(0, top)]
