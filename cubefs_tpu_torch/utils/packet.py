"""Binary packet protocol: the FS-plane data transport.

Role parity: proto/packet.go:379 + depends/xtaci/smux — the reference's
hot data path speaks a fixed 64-byte binary header over persistent TCP
connections (magic, opcode, CRC, sizes, partition/extent/offset routing
fields, request id) and multiplexes many logical streams over one
connection. This is that wire shape, TPU-framework-native:

  offset  field
  0       magic (0xCF)
  1       opcode
  2       flags   (bit 0: FLAG_MORE — payload continues next frame)
  3       result  (0 ok; else an errno-ish code)
  4:8     crc32 of THIS FRAME's payload chunk (IEEE, little-endian)
  8:12    payload size (this frame's chunk)
  12:16   arg size (JSON args; first frame of a request/response only)
  16:24   partition id
  24:32   extent id
  32:40   offset
  40:48   request id
  48:64   reserved

A logical packet is one or more frames sharing a req_id: every frame
but the last sets FLAG_MORE, args ride the first frame, and each frame
carries the CRC of ITS OWN chunk — so a 4 MiB payload travels as
CUBEFS_PKT_CHUNK-sized segments that interleave with other streams'
frames instead of head-of-line-blocking them, and corruption is pinned
to one chunk of one stream. Frames are sent with `sendmsg` scatter-
gather (header / args / payload stay separate buffers end to end) and
received with `recv_into` (no bytearray->bytes copies).

Transport modes (CUBEFS_PKT_MUX, default on; 0 = legacy for A/B):

* mux (smux analog): `PacketClient` keeps ONE shared connection per
  address; a per-connection reader thread demuxes responses by req_id
  back to per-request futures, `call_async` exposes the pipelining, and
  the server dispatches each completed request to a worker pool so
  responses stream back in completion order. N in-flight ops cost one
  socket, not N.
* legacy serial: the PR-7 pooled path — each call checks a socket out
  of a bounded pool and runs one serial request/response on it.

Both modes reconnect-and-resend at most once on a broken connection,
and ONLY for idempotent requests: opcodes in `IDEMPOTENT_OPS`, or call
sites that pass `idempotent=True` because their args carry an op_id the
server-side FSM dedups (the `rpc.call` idempotency contract, enforced
here rather than promised in prose).

The port's copy of ``cubefs_tpu/utils/packet.py``: the same frames on the
wire, so either package's clients and servers talk to the other's.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import threading
import time
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor

from . import faultinject, metrics, trace as tracelib

MAGIC = 0xCF
HEADER = struct.Struct("<BBBBIIIQQQQ16x")
assert HEADER.size == 64

# flags byte, bit 0: this frame's payload continues in the next frame
# with the same req_id (continuation / streaming framing)
FLAG_MORE = 0x01

# opcodes (datanode data plane)
OP_WRITE = 0x01
OP_READ = 0x02
OP_WRITE_REPLICA = 0x03
OP_FINGERPRINT = 0x04
OP_ALLOC_EXTENT = 0x05
OP_PING = 0x7F

# opcodes (metanode meta plane — manager_op.go analog: meta ops ride the
# same 64-byte binary protocol as data ops, not HTTP)
OP_META_LOOKUP = 0x20
OP_META_INODE_GET = 0x21
OP_META_READDIR = 0x22
OP_META_SUBMIT = 0x23
OP_META_DENTRY_COUNT = 0x24
OP_META_ALLOC_INO = 0x25
OP_META_WALK = 0x26
OP_META_SUBMIT_BATCH = 0x27

# opcodes (geo-replication plane — fs/georepl.py): the cross-cluster
# snapshot payload rides FLAG_MORE chunk trains like any large frame,
# so a multi-MB bootstrap never monopolizes the shared mux connection
# and a corrupt chunk poisons one transfer, not the conn
OP_GEO_SNAPSHOT = 0x30
OP_GEO_SHIP = 0x31
OP_GEO_BACKFILL = 0x32

# opcode (elastic metadata plane — fs/split.py): the scoped inode-range
# snapshot a split target pulls from the donor leader rides the same
# FLAG_MORE chunk trains as the geo bootstrap; the reply meta carries a
# whole-payload CRC the puller verifies before proposing range_load
OP_META_RANGE_EXPORT = 0x33

RESULT_OK = 0
RESULT_RPC = 0xE1  # structured rpc error: code+message ride the args

# span/audit naming for the binary plane (the header has no method
# string, only an opcode)
OP_NAMES = {
    OP_WRITE: "write", OP_READ: "read",
    OP_WRITE_REPLICA: "write_replica", OP_FINGERPRINT: "fingerprint",
    OP_ALLOC_EXTENT: "alloc_extent", OP_PING: "ping",
    OP_META_LOOKUP: "meta_lookup", OP_META_INODE_GET: "meta_inode_get",
    OP_META_READDIR: "meta_readdir", OP_META_SUBMIT: "meta_submit",
    OP_META_DENTRY_COUNT: "meta_dentry_count",
    OP_META_ALLOC_INO: "meta_alloc_ino", OP_META_WALK: "meta_walk",
    OP_META_SUBMIT_BATCH: "meta_submit_batch",
    OP_GEO_SNAPSHOT: "geo_snapshot", OP_GEO_SHIP: "geo_ship",
    OP_GEO_BACKFILL: "geo_backfill",
    OP_META_RANGE_EXPORT: "meta_range_export",
}

# opcodes whose transport-level retry is harmless with NO dedup token:
# pure reads and ping. Mutating opcodes are retried only when the call
# site passes idempotent=True, asserting its args carry an op_id the
# server FSM dedups (submit/submit_batch/alloc) or the write is
# absolute bytes at a fixed (extent, offset).
IDEMPOTENT_OPS = frozenset({
    OP_READ, OP_FINGERPRINT, OP_PING,
    OP_META_LOOKUP, OP_META_INODE_GET, OP_META_READDIR,
    OP_META_DENTRY_COUNT, OP_META_WALK,
    # geo snapshot/backfill are pure reads of primary state; geo_ship
    # is retried safely because the applier skips seq <= applied
    OP_GEO_SNAPSHOT, OP_GEO_BACKFILL, OP_GEO_SHIP,
    # range export is a pure read of donor state (the tap it registers
    # is reset, not duplicated, by a re-read of the same split_id)
    OP_META_RANGE_EXPORT,
})


def op_name(opcode: int) -> str:
    return OP_NAMES.get(opcode, f"op{opcode:#x}")

# reserved args key carrying the trace header across the binary wire
# (the 64-byte header has no spare string field; args is the envelope).
# Mux frames carry it exactly like serial ones — the first frame's args
# — so span stitching and the lock witness hold on both paths.
TRACE_ARG = "_trace"


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def mux_enabled() -> bool:
    """CUBEFS_PKT_MUX door: 1 (default) = multiplexed shared connection,
    0 = legacy pooled serial path (the A/B baseline)."""
    return os.environ.get("CUBEFS_PKT_MUX", "1") != "0"


def chunk_size() -> int:
    """CUBEFS_PKT_CHUNK: streaming-frame segment size (bytes)."""
    return max(4096, _env_int("CUBEFS_PKT_CHUNK", 256 << 10))


def window_size() -> int:
    """CUBEFS_PKT_WINDOW: how many requests callers keep in flight per
    partition on one mux connection (SubmitFanout, extent writes, sdk)."""
    return max(1, _env_int("CUBEFS_PKT_WINDOW", 8))


class PacketError(Exception):
    """`code` carries a full rpc status (421 redirect, 499 errno=...)
    across the wire — the 1-byte header result field can't; handlers
    raise with code set and the server forwards it in the reply args."""

    def __init__(self, result: int, msg: str = "", code: int | None = None):
        super().__init__(f"packet result {result}: {msg}")
        self.result = result
        self.code = code
        self.message = msg


class CrcError(PacketError):
    """A frame whose chunk fails its CRC but whose header parsed clean:
    the advertised args+payload bytes were consumed, so FRAMING is
    intact — only the stream owning req_id is poisoned. Mux readers
    fail that one stream and keep demuxing; a bad MAGIC (plain
    PacketError 0xFF) still kills the whole connection, because there
    framing itself is lost."""

    def __init__(self, req_id: int):
        super().__init__(0xFE, f"payload crc mismatch (req {req_id})")
        self.req_id = req_id


def pack(opcode: int, *, partition: int = 0, extent: int = 0,
         offset: int = 0, req_id: int = 0, args: dict | None = None,
         payload: bytes = b"", result: int = RESULT_OK,
         flags: int = 0) -> bytes:
    """Encode ONE unchunked frame as contiguous bytes — the convenience
    codec for tests and raw-socket tools. The transport never calls
    this: hot paths ship [header, args, chunk] buffer lists through
    sendmsg without coalescing (see _frames/_sendmsg_all)."""
    arg_bytes = json.dumps(args).encode() if args else b""
    hdr = HEADER.pack(MAGIC, opcode, flags, result,
                      zlib.crc32(payload), len(payload), len(arg_bytes),
                      partition, extent, offset, req_id)
    return b"".join((hdr, arg_bytes, payload))


def _frames(opcode: int, *, partition: int = 0, extent: int = 0,
            offset: int = 0, req_id: int = 0, args: dict | None = None,
            payload=b"", result: int = RESULT_OK, flags: int = 0,
            chunk: int | None = None):
    """Yield per-frame scatter-gather buffer lists [hdr, args?, chunk?].

    Payloads larger than the chunk limit become a FLAG_MORE continuation
    train; args ride the first frame only; each frame's CRC covers its
    own chunk. The payload is never copied — chunks are memoryview
    slices handed straight to sendmsg."""
    arg_bytes = json.dumps(args).encode() if args else b""
    limit = chunk if chunk is not None else chunk_size()
    mv = memoryview(payload)
    n = len(mv)
    if n <= limit:
        hdr = HEADER.pack(MAGIC, opcode, flags, result, zlib.crc32(mv),
                          n, len(arg_bytes), partition, extent, offset,
                          req_id)
        yield [hdr, arg_bytes, mv]
        return
    pos = 0
    first = True
    while pos < n:
        part = mv[pos:pos + limit]
        pos += len(part)
        f = flags | (FLAG_MORE if pos < n else 0)
        hdr = HEADER.pack(MAGIC, opcode, f, result, zlib.crc32(part),
                          len(part), len(arg_bytes) if first else 0,
                          partition, extent, offset, req_id)
        yield [hdr, arg_bytes, part] if first else [hdr, b"", part]
        first = False


def _sendmsg_all(sock: socket.socket, bufs) -> int:
    """Send a scatter-gather buffer list fully: one sendmsg syscall in
    the common case, a partial-send loop that advances memoryviews (no
    coalescing copy) otherwise. Returns bytes sent."""
    views = [memoryview(b) for b in bufs if len(b)]
    total = sum(len(v) for v in views)
    while views:
        sent = sock.sendmsg(views)
        while sent:
            if sent >= len(views[0]):
                sent -= len(views[0])
                views.pop(0)
            else:
                views[0] = views[0][sent:]
                sent = 0
    return total


def _recv_into(sock: socket.socket, n: int) -> bytearray:
    """Receive exactly n bytes into one preallocated buffer."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:])
        if not r:
            raise ConnectionError("peer closed mid-frame")
        got += r
    return buf


def recv_frame(sock: socket.socket):
    """Read ONE frame; returns (header fields, args, payload memoryview).

    The payload stays a memoryview over the single receive buffer —
    callers hand it to file writes / CRC / sendmsg without a copy.
    Raises CrcError (stream-poisoning, framing intact) on a chunk CRC
    mismatch, PacketError 0xFF (connection-poisoning) on bad magic."""
    raw = _recv_into(sock, HEADER.size)
    (magic, opcode, flags, result, crc, psize, asize,
     partition, extent, offset, req_id) = HEADER.unpack(raw)
    if magic != MAGIC:
        raise PacketError(0xFF, f"bad magic {magic:#x}")
    arg_raw = _recv_into(sock, asize) if asize else b""
    payload = memoryview(_recv_into(sock, psize)) if psize else memoryview(b"")
    if zlib.crc32(payload) != crc:
        raise CrcError(req_id)
    args = json.loads(arg_raw) if asize else {}
    return ({"opcode": opcode, "flags": flags, "result": result,
             "partition": partition, "extent": extent, "offset": offset,
             "req_id": req_id}, args, payload)


def recv_packet(sock: socket.socket) -> tuple[dict, dict, bytes]:
    """Read one LOGICAL packet (reassembling a continuation train) —
    the serial-mode receive path; the mux reader demuxes interleaved
    trains itself. Returns (header fields, args, payload)."""
    hdr, args, payload = recv_frame(sock)
    if not (hdr["flags"] & FLAG_MORE):
        return hdr, args, payload
    parts = [payload]
    while True:
        h2, _, part = recv_frame(sock)
        if h2["req_id"] != hdr["req_id"]:
            # a serial stream carries exactly one train at a time; an
            # interleaved req_id here means the peer is mux and we are
            # not — unrecoverable protocol mismatch
            raise PacketError(0xFC, "interleaved continuation frame")
        parts.append(part)
        if not (h2["flags"] & FLAG_MORE):
            break
    hdr["flags"] &= ~FLAG_MORE
    return hdr, args, b"".join(parts)


def _apply_wire_fault(addr: str, op: str, bufs):
    """Per-frame chaos hook: consult the installed FaultPlan (one
    `is not None` check when chaos is off). Returns possibly-replaced
    buffers; raises ConnectionError for injected drops; 'drop_after'
    returns ("after", bufs) so the sender drops AFTER the frame leaves
    (reply-lost shape)."""
    plan = faultinject.current()
    if plan is None:
        return bufs, False
    kind = plan.wire_frame(addr, op)
    if kind is None:
        return bufs, False
    if kind == "drop_before":
        raise ConnectionError(f"{addr}/{op}: injected frame drop")
    if kind == "corrupt":
        # flip one payload byte AFTER the header CRC was computed; the
        # receiver's per-chunk CRC door fails exactly this stream
        bufs = list(bufs)
        if len(bufs) > 2 and len(bufs[2]):
            chunk = bytearray(bufs[2])
            chunk[0] ^= 0xFF
            bufs[2] = bytes(chunk)
        else:  # header-only frame: flip a CRC byte instead
            hdr = bytearray(bufs[0])
            hdr[4] ^= 0xFF
            bufs[0] = bytes(hdr)
        return bufs, False
    return bufs, kind == "drop_after"


class PacketServer:
    """Persistent-connection TCP server dispatching opcodes to handlers.

    handler(hdr, args, payload) -> (args_out, payload_out); raising
    PacketError returns its result code to the client, any other
    exception returns 0xEF.

    Each connection's reader thread reassembles (possibly interleaved)
    continuation trains by req_id and hands every COMPLETED request to
    a shared worker pool, so one slow handler never head-of-line-blocks
    the other streams on that connection; replies are framed/chunked
    under a per-connection write lock, one frame per lock hold, so big
    responses interleave too. Serial (non-mux) clients see identical
    semantics: they only ever have one request in flight."""

    def __init__(self, handlers: dict, host: str = "127.0.0.1",
                 port: int = 0, service: str = "packet", audit=None,
                 workers: int | None = None,
                 ordered_ops: frozenset | set | None = None):
        self.handlers = handlers
        self.service = service
        self.audit = audit  # AuditLogger or None
        # opcodes whose requests from ONE connection must execute in
        # arrival order per (partition, extent): a pipelined write's
        # piece train reorders freely in the shared pool otherwise,
        # and arrival-order-sensitive handlers (append-vs-overwrite
        # classification) misread the reordering as overlap. Distinct
        # extents still run in parallel — ordering is per lane, not
        # per connection.
        self.ordered_ops = frozenset(ordered_ops or ())
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(64)
        self.addr = f"{host}:{self._srv.getsockname()[1]}"
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True)
        self._pool = ThreadPoolExecutor(
            max_workers=workers or _env_int("CUBEFS_PKT_SRV_WORKERS", 16),
            thread_name_prefix=f"pkt-{service}")

    def start(self) -> "PacketServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        # shutdown() first: close() alone does not wake a thread parked
        # in accept(2) — the blocked syscall pins the open file and the
        # port stays in LISTEN, breaking later rebinds
        try:
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._srv.close()
        except OSError:
            pass
        self._pool.shutdown(wait=False)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _dispatch(self, fn, hdr: dict, args: dict, payload):
        """One handler call: joins the caller's trace (the header rides a
        reserved args key), times it, and audits it — the binary plane
        gets the same observability discipline as the HTTP plane.
        Returns (result, args_out, payload_out) for the reply framer."""
        name = op_name(hdr["opcode"])
        span = tracelib.from_header(f"{self.service}.{name}",
                                    args.pop(TRACE_ARG, None))
        t0 = time.perf_counter()
        code = 200
        try:
            with span:
                args_out, payload_out = fn(hdr, args, payload)
            return RESULT_OK, args_out, payload_out
        except PacketError as e:
            code = e.code if e.code is not None else e.result
            err_args = {"error": e.message or str(e)}
            if e.code is not None:
                err_args["code"] = e.code
            return e.result, err_args, b""
        except Exception as e:  # handler bug: surface, don't die
            code = 500
            return 0xEF, {"error": f"{type(e).__name__}: {e}"}, b""
        finally:
            dt = time.perf_counter() - t0
            metrics.rpc_requests.inc(method=f"pkt_{name}", code=code)
            metrics.rpc_latency.observe(dt, method=f"pkt_{name}")
            if self.audit is not None:
                detail = ""
                slow_ms = tracelib.slow_threshold_ms()
                if slow_ms > 0 and dt * 1000.0 >= slow_ms:
                    detail = tracelib.stage_summary(span.trace_id)
                self.audit.record(self.service, f"pkt_{name}", code, dt,
                                  trace_id=span.trace_id, detail=detail)

    def _handle_one(self, conn: socket.socket, wlock: threading.Lock,
                    hdr: dict, args: dict, payload) -> None:
        fn = self.handlers.get(hdr["opcode"])
        if fn is None:
            result, args_out, payload_out = (
                0xFD, {"error": f"no opcode {hdr['opcode']:#x}"}, b"")
        else:
            result, args_out, payload_out = self._dispatch(
                fn, hdr, args, payload)
        try:
            sent = 0
            nframes = 0
            for bufs in _frames(hdr["opcode"], req_id=hdr["req_id"],
                                result=result, args=args_out,
                                payload=payload_out):
                # reply-direction chaos: 'corrupt' flips a chunk byte
                # under its CRC (client pins it to ONE stream and keeps
                # the conn); drop_before/after sever the conn — the
                # reply-lost shape
                bufs, drop_after = _apply_wire_fault(
                    self.service, f"reply_{op_name(hdr['opcode'])}", bufs)
                # one frame per lock hold: other streams' reply chunks
                # interleave between ours
                with wlock:
                    sent += _sendmsg_all(conn, bufs)
                nframes += 1
                if drop_after:
                    raise ConnectionError("injected reply drop-after")
            metrics.pkt_frames.inc(nframes, dir="tx", side="server")
            metrics.pkt_chunk_bytes.inc(sent, dir="tx", side="server")
        except (ConnectionError, OSError):
            # peer gone mid-reply: shutdown wakes the conn reader (a
            # plain close would leave it parked in recv on the pinned
            # file), then it closes the conn itself
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def _serve_conn(self, conn: socket.socket) -> None:
        wlock = threading.Lock()
        # req_id -> [first hdr, first args, [chunks]] for continuation
        # trains still in flight on this connection (interleaved by id)
        parts: dict[int, list] = {}
        # (partition, extent) -> deque of queued ordered tasks; a key's
        # presence means a pool worker is currently draining that lane
        lanes: dict[tuple, deque] = {}
        lanes_lock = threading.Lock()
        try:
            while not self._stop.is_set():
                try:
                    hdr, args, payload = recv_frame(conn)
                except PacketError:
                    # corrupt REQUEST frame (bad magic or chunk CRC):
                    # the header fields steering reassembly are outside
                    # the CRC, so nothing about the request can be
                    # trusted — drop the connection, cleanly, matching
                    # the reference's server-side discipline. (Response
                    # direction is different: the mux CLIENT can pin a
                    # chunk CRC to one stream and keep the connection.)
                    return
                except (ConnectionError, OSError):
                    return
                metrics.pkt_frames.inc(dir="rx", side="server")
                if len(payload):
                    metrics.pkt_chunk_bytes.inc(len(payload), dir="rx",
                                                side="server")
                rid = hdr["req_id"]
                if hdr["flags"] & FLAG_MORE:
                    ent = parts.get(rid)
                    if ent is None:
                        parts[rid] = [hdr, args, [payload]]
                    else:
                        ent[2].append(payload)
                    continue
                ent = parts.pop(rid, None)
                if ent is not None:
                    ent[2].append(payload)
                    hdr, args = ent[0], ent[1]
                    hdr = dict(hdr, flags=hdr["flags"] & ~FLAG_MORE)
                    payload = memoryview(b"".join(ent[2]))
                if hdr["opcode"] in self.ordered_ops:
                    key = (hdr["partition"], hdr["extent"])
                    task = (hdr, args, payload)
                    with lanes_lock:
                        lane = lanes.get(key)
                        if lane is not None:
                            # a worker is draining this lane: hand the
                            # task over in arrival order, don't race it
                            lane.append(task)
                            continue
                        lanes[key] = deque()
                    try:
                        self._pool.submit(self._run_lane, conn, wlock,
                                          lanes, lanes_lock, key, task)
                    except RuntimeError:  # pool shut down mid-stop
                        return
                    continue
                try:
                    self._pool.submit(self._handle_one, conn, wlock,
                                      hdr, args, payload)
                except RuntimeError:  # pool shut down mid-stop
                    return
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _run_lane(self, conn: socket.socket, wlock: threading.Lock,
                  lanes: dict, lanes_lock: threading.Lock, key: tuple,
                  task: tuple) -> None:
        """Drain one ordered lane: execute the seed task, then keep
        pulling whatever the conn reader queued behind it until the
        lane is empty. One pool worker owns a lane at a time, so same-
        lane requests execute in exactly arrival order."""
        while True:
            self._handle_one(conn, wlock, *task)
            with lanes_lock:
                lane = lanes[key]
                if not lane:
                    del lanes[key]
                    return
                task = lane.popleft()


class PacketFuture:
    """Handle for one in-flight mux request. result() raises the
    request's failure — PacketError for protocol/handler errors,
    ConnectionError if the shared connection died mid-flight, and
    socket.timeout (never a silent resend) if the reply outran the
    deadline."""

    __slots__ = ("_ev", "_res", "_exc")

    def __init__(self):
        self._ev = threading.Event()
        self._res = None
        self._exc: BaseException | None = None

    def _set(self, res) -> None:
        self._res = res
        self._ev.set()

    def _fail(self, exc: BaseException) -> None:
        self._exc = exc
        self._ev.set()

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: float | None = None):
        if not self._ev.wait(timeout):
            raise socket.timeout("packet response timed out")
        if self._exc is not None:
            raise self._exc
        return self._res


class _MuxConn:
    """One shared connection, many streams (smux session analog).

    Senders take the per-frame send lock once per CHUNK, so a large
    write's continuation train interleaves with every other caller's
    frames; a daemon reader thread reassembles response trains by
    req_id and resolves the registered PacketFuture. Death semantics:

    * chunk CRC mismatch  -> fail ONLY that stream, keep demuxing
    * bad magic           -> fail all in-flight with the PacketError
                             (protocol poison — not retried)
    * EOF / reset / OSError -> fail all in-flight with ConnectionError
                             (the idempotent-retry class)

    Requests that have not been registered yet are untouched — exactly
    the in-flight set observes a mid-stream peer death."""

    def __init__(self, client: "PacketClient"):
        self._client = client
        self.addr = f"{client.host}:{client.port}"
        self.sock = client._connect()
        # the reader blocks on frame boundaries indefinitely; per-call
        # deadlines are enforced by PacketFuture.result(timeout), so an
        # idle-but-healthy connection must not time itself out
        self.sock.settimeout(None)
        self.send_lock = threading.Lock()
        self._lock = threading.Lock()
        self._pending: dict[int, PacketFuture] = {}
        self._parts: dict[int, list] = {}
        self.dead: BaseException | None = None
        metrics.pkt_mux_conns.inc()
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True,
            name=f"pktmux-{self.addr}")
        self._reader.start()

    def register(self, req_id: int) -> PacketFuture:
        fut = PacketFuture()
        with self._lock:
            if self.dead is not None:
                raise ConnectionError(f"mux connection down: {self.dead}")
            self._pending[req_id] = fut
        metrics.pkt_mux_streams.inc()
        return fut

    def forget(self, req_id: int) -> None:
        """Abandon a stream (caller timed out): the late reply is
        discarded by the reader instead of resolving a dead future."""
        with self._lock:
            if self._pending.pop(req_id, None) is not None:
                metrics.pkt_mux_streams.inc(-1)

    def send(self, frames, op: str) -> None:
        nframes = 0
        nbytes = 0
        try:
            for bufs in frames:
                bufs, drop_after = _apply_wire_fault(self.addr, op, bufs)
                t0 = time.perf_counter()
                with self.send_lock:
                    metrics.pkt_mux_queue_wait.observe(
                        time.perf_counter() - t0)
                    nbytes += _sendmsg_all(self.sock, bufs)
                nframes += 1
                if drop_after:
                    raise ConnectionError(
                        f"{self.addr}/{op}: injected drop-after-send")
        finally:
            if nframes:
                metrics.pkt_frames.inc(nframes, dir="tx", side="client")
                metrics.pkt_chunk_bytes.inc(nbytes, dir="tx", side="client")

    def _read_loop(self) -> None:
        try:
            while True:
                try:
                    hdr, args, payload = recv_frame(self.sock)
                except CrcError as e:
                    # framing intact: poison exactly one stream
                    self._fail_stream(e.req_id, e)
                    continue
                metrics.pkt_frames.inc(dir="rx", side="client")
                if len(payload):
                    metrics.pkt_chunk_bytes.inc(len(payload), dir="rx",
                                                side="client")
                rid = hdr["req_id"]
                if hdr["flags"] & FLAG_MORE:
                    ent = self._parts.get(rid)
                    if ent is None:
                        self._parts[rid] = [hdr, args, [payload]]
                    else:
                        ent[2].append(payload)
                    continue
                ent = self._parts.pop(rid, None)
                if ent is not None:
                    ent[2].append(payload)
                    hdr, args = ent[0], ent[1]
                    payload = memoryview(b"".join(ent[2]))
                with self._lock:
                    fut = self._pending.pop(rid, None)
                if fut is None:
                    continue  # abandoned stream (timeout); drop late reply
                metrics.pkt_mux_streams.inc(-1)
                if hdr["result"] != RESULT_OK:
                    fut._fail(PacketError(hdr["result"],
                                          args.get("error", ""),
                                          code=args.get("code")))
                else:
                    fut._set((args, payload))
        except BaseException as e:  # bad magic, EOF, reset, close()
            self._die(e)

    def _fail_stream(self, rid: int, exc: PacketError) -> None:
        self._parts.pop(rid, None)
        with self._lock:
            fut = self._pending.pop(rid, None)
        metrics.pkt_stream_drops.inc(side="client")
        if fut is not None:
            metrics.pkt_mux_streams.inc(-1)
            fut._fail(exc)

    def _die(self, exc: BaseException) -> None:
        with self._lock:
            if self.dead is not None:
                return
            self.dead = exc
            pending, self._pending = self._pending, {}
        metrics.pkt_mux_conns.inc(-1)
        if pending:
            metrics.pkt_mux_streams.inc(-len(pending))
        self._parts.clear()
        # shutdown() wakes the reader thread if it is parked in recv —
        # close() alone leaves it pinning the connection forever
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        self._client._drop_mux(self)
        if isinstance(exc, PacketError):
            # protocol poison (bad magic): surface as-is, never retried
            fail: BaseException = exc
        else:
            fail = ConnectionError(f"mux connection lost: {exc}")
        for fut in pending.values():
            fut._fail(fail)


class PacketClient:
    """Client for the binary plane; two transports behind one API.

    Mux mode (CUBEFS_PKT_MUX=1, default): ONE shared persistent
    connection per address; `call_async` registers a future keyed by
    req_id and appends frames — many requests in flight on one socket,
    demuxed by the reader thread (smux/conn_pool.go roles merged).
    Legacy mode (=0): the PR-7 bounded pool, one serial
    request/response per checked-out socket — kept verbatim as the A/B
    baseline.

    Both modes reconnect-and-resend at most once on a broken
    connection, and only for idempotent requests (IDEMPOTENT_OPS, or
    idempotent=True asserted by the call site — see module docstring);
    a recv timeout NEVER resends: the request may still be executing
    on a saturated peer."""

    def __init__(self, addr: str, timeout: float = 30.0,
                 connect_timeout: float | None = None,
                 max_conns: int = 8):
        """timeout bounds a full request/response round-trip (writes may
        legitimately block on chain forwarding / raft / QoS shaping);
        connect_timeout bounds only the TCP connect, so a blackholed
        port fails fast without shrinking the IO budget."""
        self.host, port = addr.rsplit(":", 1)
        self.port = int(port)
        self.timeout = timeout
        self.connect_timeout = (connect_timeout if connect_timeout
                                is not None else timeout)
        self.max_conns = max_conns
        self.mux = mux_enabled()  # door latched at construction
        self._cv = threading.Condition()
        self._free: list[socket.socket] = []
        self._count = 0  # sockets alive (free + checked out)
        self._closed = False
        self._req_lock = threading.Lock()
        self._req_id = 0
        self._mux_lock = threading.Lock()
        self._mux: _MuxConn | None = None

    def _connect(self) -> socket.socket:
        s = socket.create_connection((self.host, self.port),
                                     timeout=self.connect_timeout)
        s.settimeout(self.timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s

    # ---------------- mux transport ----------------
    def _get_mux(self) -> _MuxConn:
        with self._mux_lock:
            if self._closed:
                raise PacketError(0xFB, "client closed")
            m = self._mux
            if m is None or m.dead is not None:
                m = self._mux = _MuxConn(self)
            return m

    def _drop_mux(self, conn: _MuxConn) -> None:
        with self._mux_lock:
            if self._mux is conn:
                self._mux = None

    def _next_req_id(self) -> int:
        with self._req_lock:
            self._req_id += 1
            return self._req_id

    def _trace_args(self, args: dict | None) -> dict | None:
        cur = tracelib.current()
        if cur is not None:
            # propagate the active span across the binary wire so the
            # server-side handler joins this trace (X-Trace analog)
            args = dict(args or {})
            args[TRACE_ARG] = cur.header()
        return args

    def _mux_submit(self, opcode, partition, extent, offset, args,
                    payload):
        """Register + send one request on the shared connection; returns
        (future, req_id, conn). A send failure kills the connection
        (frame boundaries can't be trusted mid-write) and re-raises."""
        req_id = self._next_req_id()
        conn = self._get_mux()
        fut = conn.register(req_id)
        try:
            conn.send(_frames(opcode, partition=partition, extent=extent,
                              offset=offset, req_id=req_id, args=args,
                              payload=payload), op_name(opcode))
        except BaseException as e:
            conn.forget(req_id)
            conn._die(e)
            raise
        return fut, req_id, conn

    def call_async(self, opcode: int, *, partition: int = 0,
                   extent: int = 0, offset: int = 0,
                   args: dict | None = None, payload=b"",
                   idempotent: bool | None = None) -> PacketFuture:
        """Pipelined call: returns a PacketFuture immediately; many may
        be in flight on the one shared connection (collect with
        .result()). Send-side connection failures retry once on a fresh
        connection for idempotent requests only; an in-FLIGHT loss
        surfaces through the future (the caller owns that retry). In
        legacy serial mode this degrades to an eager synchronous call
        returning an already-resolved future."""
        if idempotent is None:
            idempotent = opcode in IDEMPOTENT_OPS
        if not self.mux:
            fut = PacketFuture()
            try:
                fut._set(self.call(opcode, partition=partition,
                                   extent=extent, offset=offset,
                                   args=args, payload=payload,
                                   idempotent=idempotent))
            except BaseException as e:
                fut._fail(e)
            return fut
        args = self._trace_args(args)
        for attempt in (0, 1):
            try:
                fut, _, _ = self._mux_submit(opcode, partition, extent,
                                             offset, args, payload)
                return fut
            except (ConnectionError, OSError):
                if attempt or not idempotent:
                    raise
        raise PacketError(0xFB, "unreachable")  # pragma: no cover

    def _call_mux(self, opcode, partition, extent, offset, args, payload,
                  idempotent: bool) -> tuple[dict, bytes]:
        args = self._trace_args(args)
        for attempt in (0, 1):
            try:
                fut, req_id, conn = self._mux_submit(
                    opcode, partition, extent, offset, args, payload)
            except (ConnectionError, OSError):
                if attempt or not idempotent:
                    raise
                continue
            try:
                rargs, rpayload = fut.result(self.timeout)
            except socket.timeout:
                # the request may be EXECUTING server-side: never
                # resend; abandon the stream so the late reply is
                # dropped (the connection itself stays healthy — mux
                # demuxes by req_id, unlike the serial path)
                conn.forget(req_id)
                raise
            except ConnectionError:
                # peer died with this request in flight
                if attempt or not idempotent:
                    raise
                continue
            return rargs, rpayload
        raise PacketError(0xFB, "unreachable")  # pragma: no cover

    # ---------------- legacy pooled serial transport ----------------
    def _checkout(self) -> socket.socket:
        with self._cv:
            while True:
                if self._closed:
                    raise PacketError(0xFB, "client closed")
                if self._free:
                    return self._free.pop()
                if self._count < self.max_conns:
                    self._count += 1
                    break
                if not self._cv.wait(timeout=self.timeout):
                    raise PacketError(0xFB, "connection pool exhausted")
        try:
            return self._connect()  # outside the lock: connect can block
        except BaseException:
            with self._cv:
                self._count -= 1
                self._cv.notify()
            raise

    def _checkin(self, s: socket.socket) -> None:
        with self._cv:
            if self._closed:
                self._count -= 1
                self._cv.notify()
            else:
                self._free.append(s)
                self._cv.notify()
                return
        try:
            s.close()
        except OSError:
            pass

    def _discard(self, s: socket.socket) -> None:
        try:
            s.close()
        except OSError:
            pass
        with self._cv:
            self._count -= 1
            self._cv.notify()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            free, self._free = self._free, []
            self._count -= len(free)
            self._cv.notify_all()
        for s in free:
            try:
                s.close()
            except OSError:
                pass
        with self._mux_lock:
            m, self._mux = self._mux, None
        if m is not None:
            m._die(PacketError(0xFB, "client closed"))

    def call(self, opcode: int, *, partition: int = 0, extent: int = 0,
             offset: int = 0, args: dict | None = None, payload=b"",
             idempotent: bool | None = None) -> tuple[dict, bytes]:
        if idempotent is None:
            idempotent = opcode in IDEMPOTENT_OPS
        if self.mux:
            rargs, rpayload = self._call_mux(opcode, partition, extent,
                                             offset, args, payload,
                                             idempotent)
            return rargs, rpayload
        req_id = self._next_req_id()
        args = self._trace_args(args)
        frames = list(_frames(opcode, partition=partition, extent=extent,
                              offset=offset, req_id=req_id, args=args,
                              payload=payload))
        for attempt in (0, 1):
            s = self._checkout()
            try:
                for bufs in frames:
                    _sendmsg_all(s, bufs)
                try:
                    hdr, rargs, rpayload = recv_packet(s)
                except PacketError:
                    # corrupt frame (bad magic/CRC): the stream is
                    # desynced — an unknown number of frame bytes
                    # remain unread, so every later call would parse
                    # misaligned garbage. Drop the connection, same
                    # discipline as the server side.
                    self._discard(s)
                    raise
            except socket.timeout:
                # the request may be EXECUTING server-side (e.g. a
                # QoS-shaped write): resending would duplicate it and
                # double the load exactly when the peer is saturated
                self._discard(s)
                raise
            except (ConnectionError, OSError):
                self._discard(s)
                # the IDEMPOTENCY CONTRACT, enforced: a broken pipe is
                # ambiguous (the peer may have executed the request
                # before dying), so only requests whose replay is
                # harmless — pure reads, or mutations the call site
                # vouched carry a server-deduped op_id — get resent
                if attempt or not idempotent:
                    raise
                continue
            if hdr["req_id"] != req_id:
                # a fresh-per-call checkout can only see its own request's
                # response; a mismatch means the stream is unusable
                self._discard(s)
                raise PacketError(0xFC, "response req_id mismatch")
            self._checkin(s)
            if hdr["result"] != RESULT_OK:
                raise PacketError(hdr["result"], rargs.get("error", ""),
                                  code=rargs.get("code"))
            return rargs, rpayload
        raise PacketError(0xFB, "unreachable")  # pragma: no cover
