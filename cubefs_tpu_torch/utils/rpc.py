"""Minimal HTTP RPC: JSON args and binary payloads (stdlib only).

The port's copy of ``cubefs_tpu/utils/rpc.py``: the codec service's and
the blob plane's transport. Handlers are plain methods on service
objects; the same objects can be called in-process (``Client`` over the
object, the reference's mocktest pattern) or served over HTTP, so the
reference's clients (its ``rpc.call`` and the native C client) and the
port's serve each other unchanged.

Wire shape: ``POST /<method>`` with JSON args in the ``X-Rpc-Args``
header and an optional binary body, whose zlib CRC32 may ride in
``X-Rpc-Crc``; the reply mirrors it (JSON meta in ``X-Rpc-Resp``, binary
body). Errors are HTTP 4xx/5xx with ``{"error": message}`` as the meta.
``GET /metrics`` serves the process's registry in Prometheus text,
``GET /spans`` the collected spans and ``GET /traces`` a trace's tree
(or the known trace ids and the slowest captured roots). A client sends
the active span in ``X-Trace`` and the server continues it
(``utils/trace.py``). With an audit logger (``utils/auditlog.py``) the
server writes one record per POST, and the slow-trace capture
(``slowtrace.jsonl``) beside it.

Chaos hook: ``utils/faultinject.py`` installs a plan as ``_fault``;
``call`` and the in-process ``Client`` then route every attempt through
it. The server listens with a backlog of 128.
"""

from __future__ import annotations

import http.client
import json
import os
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import lockwitness
from .retry import CircuitBreaker, RetryPolicy

# Chaos hook (utils/faultinject.py): None in production, a FaultPlan in
# chaos tests. A single module-level identity check is the ONLY cost on
# the fast path — no allocations, no locks when uninstalled.
_fault = None

# The one retry/backoff discipline (utils/retry.py) that replaced the
# ad-hoc sleep(0.05)/sleep(0.1)/3-attempt loops: redirect chasing and
# election waits ride ELECTION_POLICY, replica failover rides
# FAILOVER_POLICY with the caller's deadline.
ELECTION_POLICY = RetryPolicy(base=0.05, cap=0.4, deadline=3.0)
FAILOVER_POLICY = RetryPolicy(base=0.05, cap=0.4, deadline=10.0)


class RpcError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(f"rpc {code}: {message}")
        self.code = code
        self.message = message


class ServiceUnavailable(RpcError):
    pass


# Geo-replication redirect (utils/georepl.py): a follower-region
# service bounces mutations with this code and a "primary=<addr>"
# message; the redirect loops below follow it like a 421 leader
# redirect, so a client pointed at the follower region transparently
# writes to the primary while its reads keep serving locally.
GEO_REDIRECT = 452

# Elastic-metadata routing redirect (fs/split.py): a metanode bounces
# mutations/reads aimed at an inode range that is frozen for, or has
# been handed off by, a live metapartition split/merge with this code
# and a "pid=<target>" message; the sdk refreshes its partition map
# and re-routes (fs/client.py MetaWrapper._call_wire) the same way it
# follows a 421 leader redirect.
RANGE_MOVED = 453


def errno_error(errno_: int, msg: str) -> RpcError:
    """THE errno-on-the-wire encoding, shared by every plane that maps
    POSIX errnos onto RPC statuses: 400+errno for small errnos, except
    that 404 (not-found pass-through), 421 (leader redirect, whose
    message is parsed as an address), 452 (geo redirect, same) and 453
    (range-moved redirect, whose message is parsed as a pid) are
    reserved transport codes — those and errnos >= 100 (EDQUOT=122 must
    not collide with 5xx failover semantics) ride 499 with an
    "errno=NN: " message prefix. Decoders: fs/client.py
    MetaWrapper._call and native_client.cc status_to_errno."""
    if errno_ < 99 and 400 + errno_ not in (404, 421, GEO_REDIRECT, RANGE_MOVED):
        return RpcError(400 + errno_, msg)
    return RpcError(499, f"errno={errno_}: {msg}")


def expose(obj) -> dict:
    """Collect rpc_* methods from a service object into a route table."""
    return {
        name[len("rpc_") :]: getattr(obj, name)
        for name in dir(obj)
        if name.startswith("rpc_") and callable(getattr(obj, name))
    }


def resolve_route(target, name: str):
    """Find a handler on a service object: its live `extra_routes` dict
    (dynamically mounted handlers, e.g. per-partition raft) first, then
    rpc_* methods. Returns None if absent."""
    extra = getattr(target, "extra_routes", None)
    if extra and name in extra:
        return extra[name]
    fn = getattr(target, f"rpc_{name}", None)
    return fn if callable(fn) else None


class _Server(ThreadingHTTPServer):
    # socketserver's default backlog of 5 resets connections when dozens
    # of storage-node clients connect at once
    request_queue_size = 128


class RpcServer:
    """Threaded HTTP server over a route table of callables
    fn(args: dict, body: bytes) -> (dict, bytes) | dict | bytes | None.
    Pass a service OBJECT instead of a dict to get live resolution
    (rpc_* methods + its extra_routes), so handlers mounted after server
    start (per-partition raft) are reachable."""

    def __init__(self, routes, host: str = "127.0.0.1", port: int = 0,
                 service: str = "svc", audit=None):
        self._target = None
        if isinstance(routes, dict):
            self.routes = dict(routes)
        else:
            self._target = routes
            self.routes = {}
        self.service = service
        self.audit = audit  # AuditLogger or None
        if audit is not None and getattr(audit, "path", None):
            from . import trace as _tracelib

            _tracelib.configure_slow_log(os.path.join(
                os.path.dirname(audit.path) or ".", "slowtrace.jsonl"))
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # a reply is two writes (headers, then body): with Nagle on, the
            # body waits for the client's delayed ACK of the headers, ~40 ms
            disable_nagle_algorithm = True

            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                # observability endpoints (util/exporter + pprof analog)
                from urllib.parse import parse_qs, urlsplit

                from . import metrics, trace as tracelib

                parts = urlsplit(self.path)
                if parts.path == "/metrics":
                    from . import slo

                    slo.refresh()
                    body = metrics.DEFAULT.render_text().encode()
                    self._reply_raw(200, body, "text/plain; version=0.0.4")
                elif parts.path == "/spans":
                    q = parse_qs(parts.query)
                    tid = (q.get("trace_id") or [None])[0]
                    body = json.dumps(tracelib.finished_spans(tid)).encode()
                    self._reply_raw(200, body, "application/json")
                elif parts.path == "/traces":
                    q = parse_qs(parts.query)
                    tid = (q.get("trace_id") or [None])[0]
                    if tid:
                        tree = tracelib.trace_tree(tid)
                        out = {
                            "trace_id": tid,
                            "tree": tree,
                            "render": tracelib.render_tree(tree),
                        }
                    else:
                        top = int((q.get("top") or ["10"])[0])
                        out = {
                            "trace_ids": tracelib.known_trace_ids(),
                            "slow": tracelib.slow_traces(top=top),
                        }
                    self._reply_raw(200, json.dumps(out).encode(),
                                    "application/json")
                else:
                    self._reply_raw(404, b"not found", "text/plain")

            def _reply_raw(self, code, body, ctype):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                import time as _time

                from . import metrics, trace as tracelib

                name = self.path.lstrip("/")
                fn = outer.routes.get(name)
                if fn is None and outer._target is not None:
                    fn = resolve_route(outer._target, name)
                if fn is None:
                    self._reply(404, {"error": f"no such method {name!r}"}, b"")
                    return
                span = tracelib.from_header(
                    f"{outer.service}.{name}", self.headers.get("X-Trace")
                )
                t0 = _time.perf_counter()
                code = 200
                try:
                    with span:
                        args = json.loads(self.headers.get("X-Rpc-Args") or "{}")
                        n = int(self.headers.get("Content-Length") or 0)
                        body = self.rfile.read(n) if n else b""
                        want_crc = self.headers.get("X-Rpc-Crc")
                        if want_crc is not None:
                            import zlib as _z

                            try:
                                expect = int(want_crc)
                            except ValueError:
                                raise RpcError(400, "malformed X-Rpc-Crc") from None
                            if _z.crc32(body) != expect:
                                raise RpcError(400, "request body crc mismatch")
                        out = fn(args, body)
                        meta, payload = _normalize(out)
                    self._reply(200, meta, payload)
                except RpcError as e:
                    code = e.code
                    self._reply(e.code, {"error": e.message}, b"")
                except Exception as e:  # surface as 500 with the message
                    code = 500
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"}, b"")
                finally:
                    dt = _time.perf_counter() - t0
                    metrics.rpc_requests.inc(method=name, code=code)
                    metrics.rpc_latency.observe(dt, method=name)
                    if outer.audit is not None:
                        detail = ""
                        slow_ms = tracelib.slow_threshold_ms()
                        if slow_ms > 0 and dt * 1000.0 >= slow_ms:
                            detail = tracelib.stage_summary(span.trace_id)
                        outer.audit.record(outer.service, name, code, dt,
                                           trace_id=span.trace_id,
                                           detail=detail,
                                           tenant=getattr(span, "tenant", ""))

            def _reply(self, code: int, meta: dict, payload: bytes):
                self.send_response(code)
                self.send_header("X-Rpc-Resp", json.dumps(meta))
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

        self._httpd = _Server((host, port), Handler)
        self._httpd.daemon_threads = True
        self.addr = f"{host}:{self._httpd.server_address[1]}"
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)

    def start(self) -> "RpcServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


def _normalize(out) -> tuple[dict, bytes]:
    if out is None:
        return {}, b""
    if isinstance(out, tuple):
        meta, payload = out
        return meta or {}, payload or b""
    if isinstance(out, (bytes, bytearray, memoryview)):
        return {}, bytes(out)
    return out, b""


class _KeepAlivePool:
    """Per-address keep-alive HTTP connections (util/conn_pool.go role).

    urllib opens a fresh TCP connection per request — measured at
    ~2.3 ms per raft append on the deployed single-core topology, which
    was the direct ceiling on meta create throughput. The RpcServer
    already speaks HTTP/1.1 with Content-Length on every reply, so
    connections are reusable; this pool keeps a bounded set idle per
    address."""

    MAX_IDLE = 8

    def __init__(self):
        self._idle: dict[str, list[http.client.HTTPConnection]] = {}
        self._lock = threading.Lock()

    def get(self, addr: str,
            timeout: float) -> tuple[http.client.HTTPConnection, bool]:
        """Returns (conn, reused). A reused conn may be stale — the
        caller retries once on a fresh one if it fails before any
        response bytes arrive."""
        with self._lock:
            lst = self._idle.get(addr)
            while lst:
                conn = lst.pop()
                if conn.sock is not None:
                    conn.sock.settimeout(timeout)
                    return conn, True
        host, port = addr.rsplit(":", 1)
        return http.client.HTTPConnection(host, int(port),
                                          timeout=timeout), False

    def put(self, addr: str, conn: http.client.HTTPConnection) -> None:
        with self._lock:
            lst = self._idle.setdefault(addr, [])
            if len(lst) < self.MAX_IDLE and conn.sock is not None:
                lst.append(conn)
                return
        conn.close()

    def clear(self) -> None:
        with self._lock:
            idle, self._idle = self._idle, {}
        for lst in idle.values():
            for conn in lst:
                try:
                    conn.close()
                except OSError:
                    pass


_POOL = _KeepAlivePool()

# fork safety: a child inheriting pooled sockets would interleave its
# requests with the parent's on ONE TCP stream (crossed responses /
# framing desync). Drop the inherited pool in the child; it reconnects.
if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=lambda: _POOL._idle.clear())


def call(
    addr: str, method: str, args: dict | None = None, body: bytes = b"",
    timeout: float = 30.0,
) -> tuple[dict, bytes]:
    """Invoke method on a remote RpcServer; returns (meta, payload).

    Rides pooled keep-alive connections. A STALE reused connection
    (peer closed while idle) is retried once on a fresh connection; a
    TIMEOUT is never retried (the request may be executing).

    IDEMPOTENCY CONTRACT — the stale retry can re-send a request whose
    FIRST send was already processed (the peer died after executing but
    before responding). Every MUTATING method called through here must
    therefore satisfy one of:

      1. carry an ``op_id`` in its args/record — the server dedups it
         and replays the first outcome (fs/metanode.py
         MetaPartition.apply; utils/fsm.py ReplicatedFsm._apply_deduped
         for master/clustermgr commits; alloc_ino/alloc_extent caches);
      2. be idempotent by its own contract — absolute-value writes,
         caller-keyed creates, sticky transitions — and be recorded
         with a justification in tool/lint/rpc_allowlist.py.

    The reference's lint (checker rpc-idempotency, CFR001) holds its
    call sites to this; the port's blob plane makes the same calls.

    The chaos harness (utils/faultinject.py) interposes here when a
    FaultPlan is installed; drop-after-execute faults simulate exactly
    the lost-reply case the contract above covers."""
    if lockwitness._active is not None:  # sanitizer door (same pattern)
        lockwitness.note_rpc(addr, method)
    if _fault is not None:
        return _fault.around_http(addr, method, args, body, timeout,
                                  _http_call)
    return _http_call(addr, method, args, body, timeout)


def _http_call(addr, method, args, body, timeout,
               _corrupt=False, _stale=False):
    """One HTTP invocation (the body of `call`). The keyword-only fault
    knobs exist for faultinject: `_corrupt` flips a body byte AFTER the
    CRC header is computed (the server's CRC door must reject it);
    `_stale` kills the pooled idle sockets for `addr` first so the
    reuse path hits a genuinely dead connection."""
    from . import trace as tracelib

    headers = {"X-Rpc-Args": json.dumps(args or {})}
    if body:  # every hop carries a body CRC (packet-CRC framing parity)
        import zlib as _z

        headers["X-Rpc-Crc"] = str(_z.crc32(body))
    span = tracelib.current()
    if span is not None:
        headers["X-Trace"] = span.header()
    if _corrupt and body:
        body = bytes(body)  # may be a zero-copy memoryview
        body = bytes([body[0] ^ 0xFF]) + body[1:]
    if _stale:
        with _POOL._lock:
            for conn in _POOL._idle.get(addr, []):
                if conn.sock is not None:
                    try:  # half-close: fd stays valid, next send EPIPEs
                        conn.sock.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
    for attempt in (0, 1):
        if attempt == 0:
            conn, reused = _POOL.get(addr, timeout)
        else:
            # the retry must be a genuinely FRESH connection — drawing
            # from the pool again could yield another stale idle conn
            # (e.g. after a server restart) and fail a healthy replica
            host, port = addr.rsplit(":", 1)
            conn, reused = http.client.HTTPConnection(
                host, int(port), timeout=timeout), False
        try:
            conn.request("POST", f"/{method}", body=body or b"",
                         headers=headers)
            resp = conn.getresponse()
            payload = resp.read()
        except socket.timeout:
            conn.close()
            raise ServiceUnavailable(
                503, f"{addr}/{method}: timed out") from None
        except (http.client.HTTPException, OSError) as e:
            conn.close()
            if reused and attempt == 0:
                continue  # stale keep-alive conn: one fresh retry
            raise ServiceUnavailable(503, f"{addr}/{method}: {e}") from None
        meta_raw = resp.headers.get("X-Rpc-Resp")
        if resp.will_close:
            conn.close()
        else:
            _POOL.put(addr, conn)
        if resp.status >= 400:
            try:
                msg = json.loads(meta_raw or "{}").get(
                    "error", f"http {resp.status}")
            except Exception:
                msg = f"http {resp.status}"
            raise RpcError(resp.status, msg)
        return json.loads(meta_raw or "{}"), payload
    raise ServiceUnavailable(503, f"{addr}/{method}: unreachable")


class NodePool:
    """Address -> client map, supporting in-process targets (tests) and
    HTTP addresses transparently."""

    def __init__(self):
        self._clients: dict[str, "Client"] = {}
        self._direct: dict[str, "Client"] = {}
        self._lock = threading.Lock()
        # per-pool (not global) so test clusters never share state;
        # consulted by call_replicas and the blob access SDK
        self.breaker = CircuitBreaker()

    def bind(self, addr: str, target) -> None:
        with self._lock:
            client = Client(target)
            client._fault_addr = addr  # addressable by FaultPlan rules
            self._clients[addr] = client
            self._direct.pop(addr, None)

    def get(self, addr: str) -> "Client":
        with self._lock:
            if addr not in self._clients:
                self._clients[addr] = Client(addr)  # HTTP
            return self._clients[addr]

    def get_direct(self, addr: str) -> "Client":
        """Client that never follows leader redirects — REQUIRED for
        point-to-point protocols (raft vote/append/heartbeat). The
        default client's learned-leader cache is per address and shared
        with the SDKs, so a 421 learned from a data/meta op would
        silently reroute raft messages addressed to a follower back to
        the leader — the leader then receives its own heartbeat, sees a
        'peer' claiming leadership at its own term, and steps down (a
        livelock observed on multi-group HTTP topologies)."""
        with self._lock:
            c = self._clients.get(addr)
            if c is not None and c._target is not None:
                return c  # in-process: no redirect cache exists
            if addr not in self._direct:
                self._direct[addr] = Client(addr, follow_redirects=False)
            return self._direct[addr]


class Client:
    """Bound client: in-process (direct route table) or HTTP by address.

    Keeps access/scheduler logic transport-agnostic — the in-process mode
    is the test fixture analog of the reference's mocktest servers.
    """

    def __init__(self, target, follow_redirects: bool = True):
        self._target = None
        self._addr = None
        self._follow = follow_redirects
        self._fault_addr = None  # set by NodePool.bind for in-process
        # learned-leader cache: written/read from many SDK threads, so
        # every access goes through _lock (satellite fix: the cache used
        # to be a bare attribute raced without synchronization)
        self._leader: str | None = None
        self._lock = threading.Lock()
        if isinstance(target, str):
            self._addr = target
        elif isinstance(target, RpcServer):
            self._addr = target.addr
        else:
            self._target = target  # live resolution (see resolve_route)

    REDIRECT = 421

    def _invoke_direct(self, method: str, args, body):
        # in-process transport is still "the network" to the sanitizer:
        # chaos clusters are in-process, and a lock held here would be
        # held across real HTTP in production
        if lockwitness._active is not None:
            lockwitness.note_rpc(
                self._fault_addr or f"<{type(self._target).__name__}>",
                method)
        fn = resolve_route(self._target, method)
        if fn is None:
            raise RpcError(404, f"no such method {method!r}")
        try:
            return _normalize(fn(args or {}, body))
        except RpcError:
            raise
        except Exception as e:
            # transport parity with HTTP: an unexpected handler error
            # is a 500, never a raw exception leaking into (and
            # killing) the caller's thread
            raise RpcError(500, f"{type(e).__name__}: {e}") from e

    def call(self, method: str, args: dict | None = None, body: bytes = b"",
             timeout: float = 30.0) -> tuple[dict, bytes]:
        if self._target is not None:
            if _fault is not None:
                addr = (self._fault_addr
                        or f"<{type(self._target).__name__}>")
                return _fault.around_direct(
                    addr, method,
                    lambda: self._invoke_direct(method, args, body))
            return self._invoke_direct(method, args, body)
        if not self._follow:
            # point-to-point mode: the message is for THIS address, a
            # 421 is a response, not a routing instruction
            return call(self._addr, method, args, body, timeout)
        # leader redirects (421 with "leader=<addr>") are followed
        # transparently and the learned leader is preferred afterwards,
        # so a clustermgr failover never strands access/blobnode clients.
        # Redirect hops spend no backoff; election-in-progress waits ride
        # ELECTION_POLICY's capped backoff until its deadline expires.
        with self._lock:
            addr = self._leader or self._addr
        r = ELECTION_POLICY.start(op=method)
        while True:
            try:
                return call(addr, method, args, body, timeout)
            except RpcError as e:
                if e.code == self.REDIRECT:
                    leader = e.message.removeprefix("leader=").strip()
                    if leader and leader != addr:
                        with self._lock:
                            self._leader = leader
                        addr = leader
                        if r.tick(reason="redirect", sleep=False):
                            continue
                    elif r.tick(reason="election"):
                        continue
                    raise RpcError(
                        503, f"{self._addr}/{method}: leader unresolved"
                    ) from e
                if e.code == GEO_REDIRECT:
                    # follower-region fence: mutations bounce to the
                    # primary region. NOT cached in _leader — reads must
                    # keep hitting the local (follower) address.
                    primary = e.message.removeprefix("primary=").strip()
                    if primary and primary != addr:
                        addr = primary
                        if r.tick(reason="geo-redirect", sleep=False):
                            continue
                    raise RpcError(
                        503, f"{self._addr}/{method}: geo primary "
                             f"unresolved") from e
                if isinstance(e, ServiceUnavailable) and addr != self._addr:
                    # learned leader died: fall back to the configured addr
                    with self._lock:
                        self._leader = None
                    addr = self._addr
                    if r.tick(reason="leader-failover", sleep=False):
                        continue
                raise


def call_replicas(pool: NodePool, addrs: list[str], method: str,
                  args: dict | None = None, body: bytes = b"",
                  timeout: float = 30.0,
                  deadline: float = 10.0,
                  call_fn=None) -> tuple[dict, bytes]:
    """Call one member of a replica set, following 421 leader redirects
    (with election backoff) and failing over across replicas on
    transport errors / 5xx / 404. The ONE redirect-following loop shared
    by the meta SDK (both transports — `call_fn` swaps the per-address
    call, e.g. the binary packet plane) and the metanode tx scanner —
    raises the last error if no replica answers.

    Election waits and backoff ride FAILOVER_POLICY (utils/retry.py)
    bounded by `deadline`; the pool's per-address CircuitBreaker is
    consulted so a replica that keeps timing out is skipped without
    paying its timeout again (if EVERY replica is skipped, one forced
    probe round runs so an all-open set still recovers)."""
    if call_fn is None:
        def call_fn(addr):
            return pool.get(addr).call(method, args, body, timeout)

    breaker = getattr(pool, "breaker", None)
    r = FAILOVER_POLICY.start(op=method, deadline=deadline)
    last: Exception | None = None
    tried: set[str] = set()
    queue = list(addrs)
    skipped: list[str] = []
    force_probe = False
    while (queue or skipped) and r.within_deadline():
        if not queue:
            # every candidate was breaker-skipped: probe them anyway
            queue, skipped, force_probe = skipped, [], True
        addr = queue.pop(0)
        if addr in tried:
            continue
        if (breaker is not None and not force_probe
                and not breaker.allow(addr)):
            skipped.append(addr)
            if last is None:
                last = ServiceUnavailable(
                    503, f"{addr}/{method}: circuit open")
            continue
        try:
            out = call_fn(addr)
            if breaker is not None:
                breaker.record_success(addr)
            return out
        except RpcError as e:
            if e.code == Client.REDIRECT:
                leader = e.message.removeprefix("leader=").strip()
                if leader and leader not in tried:
                    queue.insert(0, leader)
                    r.tick(reason="redirect", sleep=False)
                elif not leader:  # election in progress: back off briefly
                    queue.append(addr)
                    r.tick(reason="election")
                last = e
                continue
            if e.code == GEO_REDIRECT:
                # mutation hit a geo follower: retry against the primary
                # region's replica (the follower stays good for reads)
                primary = e.message.removeprefix("primary=").strip()
                if primary and primary not in tried:
                    queue.insert(0, primary)
                    r.tick(reason="geo-redirect", sleep=False)
                    last = e
                    continue
                raise
            if e.code == 503 and "leader unresolved" in e.message:
                # a fresh/failed-over raft group mid-election: the node
                # is ALIVE, just leaderless — wait it out within the
                # deadline instead of declaring the replica dead (a new
                # 2-replica partition would otherwise 503 its first
                # client ops for the whole election)
                queue.append(addr)
                r.tick(reason="election")
                last = e
                continue
            if isinstance(e, ServiceUnavailable) or e.code >= 500 or e.code == 404:
                # 404 = method/partition not on that node (dead or stale
                # view): fail over like a down node
                tried.add(addr)
                if breaker is not None and isinstance(e, ServiceUnavailable):
                    breaker.record_failure(addr)
                last = e
                continue
            raise
        except OSError as e:
            tried.add(addr)
            if breaker is not None:
                breaker.record_failure(addr)
            last = e
            continue
    raise last if last else RpcError(
        503, f"{method}: no replica reachable of {addrs}")
