"""Client SDK: meta routing + streaming extent IO + a filesystem facade.

Role parity: sdk/meta (MetaWrapper partition-range routing, meta/api.go),
sdk/data (ExtentClient/Streamer extent pipeline, stream/extent_client.go
:712 Write), and the FUSE client's VFS semantics (client/fs) as a
Python file API (open/read/write/mkdir/readdir/unlink/rename/stat) —
the gateway layers (FUSE wire protocol, S3) sit on top of this facade.

The port's copy of ``cubefs_tpu/fs/client.py``.
"""

from __future__ import annotations

import os
import threading
import time

import uuid

from ..utils import lockwitness
from ..utils import metrics as _metrics
from ..utils import packet as pkt
from ..utils import retry as retrylib
from ..utils import rpc
from ..utils import trace as tracelib
from . import metanode as mn


class FsError(Exception):
    def __init__(self, errno_: int, msg: str):
        super().__init__(msg)
        self.errno = errno_


# backoff while chasing a 453 RANGE_MOVED whose commit hasn't published
# a new owner yet: the freeze window is tens of milliseconds, so the
# chase stays well under the cap
_MOVED_BACKOFF = retrylib.RetryPolicy(base=0.03, cap=0.25, jitter=0.5,
                                      deadline=None)


# meta ops served on the binary packet plane (manager_op.go analog);
# everything else stays on HTTP
_META_PACKET_OPS = {"lookup": pkt.OP_META_LOOKUP,
                    "inode_get": pkt.OP_META_INODE_GET,
                    "readdir": pkt.OP_META_READDIR,
                    "submit": pkt.OP_META_SUBMIT,
                    "submit_batch": pkt.OP_META_SUBMIT_BATCH,
                    "dentry_count": pkt.OP_META_DENTRY_COUNT,
                    "alloc_ino": pkt.OP_META_ALLOC_INO,
                    "walk": pkt.OP_META_WALK}

# read ops additionally served by the metanode's native C++ read plane
# (runtime/src/metaserve.cc) when the view advertises meta_read_addrs
_META_READ_OPS = {"lookup", "inode_get", "readdir", "dentry_count", "walk"}


def _op_ids_stamped(method: str, payload: dict) -> bool:
    """Does every mutation in this meta packet call carry the op_id the
    metanode FSM dedups? Gates idempotent=True on the binary transport:
    a reconnect-resend is exactly-once ONLY through that window."""
    if method == "submit":
        return "op_id" in payload.get("record", {})
    if method == "submit_batch":
        return all("op_id" in r for r in payload.get("records") or ())
    if method == "alloc_ino":
        return "op_id" in payload
    return False


def _routing_ino(method: str, payload: dict) -> int | None:
    """The inode a meta call routes by — what a 453/EMOVED range
    redirect re-resolves against the refreshed partition table. None
    for calls with no single routing inode (alloc_ino rotates instead;
    submit_batch falls back to per-record submits in the fanout)."""
    if method == "submit":
        r = payload.get("record") or {}
        for k in ("parent", "src_parent", "ino"):
            v = r.get(k)
            if isinstance(v, int):
                return v
        return None
    if method in ("lookup", "readdir", "dentry_count"):
        v = payload.get("parent")
        return v if isinstance(v, int) else None
    if method in ("inode_get", "walk"):
        v = payload.get("ino")
        return v if isinstance(v, int) else None
    return None


def _moved_exc(e: Exception) -> bool:
    """Is this a live-range-migration routing bounce? Either the
    proposer-side fence (453 RANGE_MOVED) or the deterministic
    apply-side errno (EMOVED rides the 499 errno encoding)."""
    if isinstance(e, rpc.RpcError):
        if e.code == rpc.RANGE_MOVED:
            return True
        return (e.code == 499
                and e.message.startswith(f"errno={mn.EMOVED}:"))
    return isinstance(e, FsError) and e.errno == mn.EMOVED




class _FanoutWaiter:
    """One submit parked in the client's cross-partition coalescer.
    Doubles as the async handle submit_async returns."""

    __slots__ = ("record", "result", "exc", "done", "event", "ref",
                 "enq_t")

    def __init__(self, record: dict):
        self.record = record
        self.result = None
        self.exc: BaseException | None = None
        self.done = False
        self.event = threading.Event()
        # span handoff across the first-caller-drains boundary: the
        # drain span links back to every submitter through this ref
        self.ref = tracelib.capture()
        self.enq_t = time.perf_counter()

    def finish(self, result, exc: BaseException | None) -> None:
        self.result = result
        self.exc = exc
        self.done = True
        self.event.set()

    def wait(self, timeout: float = 30.0):
        if not self.event.wait(timeout) and not self.done:
            raise TimeoutError("fan-out submit not resolved in time")
        if self.exc is not None:
            raise self.exc
        return self.result


class SubmitFanout:
    """Client-side cross-partition submit coalescer (CUBEFS_META_FANOUT
    = K, 0 disables): mutations queue per metapartition, the first
    caller to find a partition idle drains its whole queue as ONE
    submit_batch RPC, and a K-wide gate keeps up to K partitions'
    batches in flight concurrently — the same first-caller-drains shape
    as codec/batcher.py, lifted to the wire. Under a multi-threaded
    workload the per-partition RPC tax amortizes across every queued
    record AND the partitions progress in parallel instead of one
    submit round-trip at a time. submit_async() + the lazy drain pool
    give a single-threaded caller the same K-partition concurrency."""

    def __init__(self, wrapper: "MetaWrapper", k: int):
        self.wrapper = wrapper
        self.k = k
        self._mu = lockwitness.make_lock("SubmitFanout._mu")
        self._queues: dict[int, list[_FanoutWaiter]] = {}
        self._busy: dict[int, int] = {}  # pid -> batches on the wire
        self._scheduled: dict[int, int] = {}  # pid -> drain tasks queued
        # per-partition window: with the mux transport (one shared
        # connection, req_id-demuxed) up to CUBEFS_PKT_WINDOW batches
        # per partition pipeline on that connection; the legacy serial
        # transport keeps the one-batch-per-partition discipline (each
        # extra batch would cost another pooled socket, not a stream)
        self.window = pkt.window_size() if pkt.mux_enabled() else 1
        self._gate = threading.Semaphore(max(k, k * self.window))
        self._pool = None  # lazy; only submit_async needs threads

    def submit(self, mp: dict, record: dict, timeout: float = 30.0):
        w = self._enqueue(mp, record)
        self._drain_if_idle(mp)
        return w.wait(timeout)

    def submit_async(self, mp: dict, record: dict) -> _FanoutWaiter:
        """Queue a mutation and return its handle; a drain-pool worker
        ships the partition's batch so ONE caller thread can keep K
        partitions in flight (call .wait() to collect). One drain task
        per partition burst: the drain re-spins while records keep
        arriving, so scheduling a task per record would only tax the
        pool."""
        pid = mp["pid"]
        with self._mu:
            self._queues.setdefault(pid, []).append(w := _FanoutWaiter(record))
            # one drain task per in-flight slot: up to `window` tasks
            # per partition keep that many batches pipelined on the mux
            # connection (legacy window=1 restores one-task-per-burst)
            cnt = self._scheduled.get(pid, 0)
            schedule = cnt < self.window
            if schedule:
                self._scheduled[pid] = cnt + 1
        if schedule:
            self._ensure_pool().submit(self._drain_scheduled, mp)
        return w

    def _drain_scheduled(self, mp: dict) -> None:
        pid = mp["pid"]
        with self._mu:
            n = self._scheduled.get(pid, 1) - 1
            if n:
                self._scheduled[pid] = n
            else:
                self._scheduled.pop(pid, None)
        self._drain_if_idle(mp)

    def close(self) -> None:
        """Stop the async drain pool (sync submits keep working)."""
        with self._mu:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    def _enqueue(self, mp: dict, record: dict) -> _FanoutWaiter:
        w = _FanoutWaiter(record)
        with self._mu:
            self._queues.setdefault(mp["pid"], []).append(w)
        return w

    def _ensure_pool(self):
        with self._mu:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(
                    max_workers=max(self.k, min(32, self.k * self.window)),
                    thread_name_prefix="meta-fanout")
            return self._pool

    def _drain_if_idle(self, mp: dict) -> None:
        pid = mp["pid"]
        while True:
            with self._mu:
                batch = self._queues.get(pid)
                if not batch or self._busy.get(pid, 0) >= self.window:
                    return
                self._busy[pid] = self._busy.get(pid, 0) + 1
                self._queues[pid] = []
                inflight = sum(self._busy.values())
            try:
                _metrics.meta_fanout_inflight.observe(inflight)
                self._land(mp, batch)
            finally:
                with self._mu:
                    n = self._busy.get(pid, 1) - 1
                    if n:
                        self._busy[pid] = n
                    else:
                        self._busy.pop(pid, None)
            # records queued while we were on the wire ride the next
            # spin (unless another caller already claimed the drain)

    def _land(self, mp: dict, batch: list[_FanoutWaiter]) -> None:
        pid = mp["pid"]
        self._gate.acquire()  # at most K partitions' batches in flight
        t0 = time.perf_counter()
        tracelib.observe_stage("fanout_queue_wait", "meta.write",
                               [t0 - w.enq_t for w in batch])
        links = [w.ref for w in batch if w.ref is not None]
        cur = tracelib.current()
        if cur is None and links:
            # async drains run on pool threads with no context: adopt
            # the first submitter as parent so the drain still stitches
            first = links[0]
            span = tracelib.Span(
                "stage:fanout_drain", first.trace_id, first.span_id,
                sampled=first.sampled, path=first.path)
            for ref in links[1:]:
                span.link(ref)
        else:
            span = tracelib.start_span("stage:fanout_drain", links=links)
        span.set_tag("stage", "fanout_drain").set_tag("pid", pid)
        span.set_tag("ops", len(batch))
        with span:
            self._land_wire(mp, batch)
        tracelib.observe_stage("fanout_drain", span.path or "meta.write",
                               time.perf_counter() - t0)

    def _land_wire(self, mp: dict, batch: list[_FanoutWaiter]) -> None:
        pid = mp["pid"]
        try:
            if len(batch) == 1:
                # uncontended fast path: plain submit, no batch envelope
                meta, _ = self.wrapper._call_wire(
                    mp, "submit", {"record": batch[0].record})
                batch[0].finish(meta["result"], None)
                return
            try:
                meta, _ = self.wrapper._call_wire(
                    mp, "submit_batch",
                    {"records": [w.record for w in batch]})
            except (rpc.RpcError, FsError) as e:
                if not _moved_exc(e):
                    raise
                # batch-level range fence: the partition no longer owns
                # every record's inode, so the envelope can't land as
                # one unit — fall back to per-record submits, each
                # re-routed through the 453-chasing single-op path
                self._resubmit_moved(batch)
                return
            _metrics.meta_fanout_batches.inc(pid=pid)
            _metrics.meta_fanout_ops.inc(len(batch), pid=pid)
            for w, (result, err) in zip(batch, meta["results"]):
                if err is not None and err[0] == mn.EMOVED:
                    # apply-side fence caught a record already in the
                    # raft queue when the freeze landed: it bounced
                    # (never applied) — land it on the new owner
                    self._resubmit_moved([w])
                elif err is not None:
                    w.finish(None, FsError(err[0], err[1]))
                else:
                    w.finish(result, None)
        except BaseException as e:
            # batch-level failure (redirect exhausted, transport): every
            # still-unresolved waiter observes the same outcome
            for w in batch:
                if not w.done:
                    w.finish(None, e)
        finally:
            self._gate.release()

    def _resubmit_moved(self, waiters: list[_FanoutWaiter]) -> None:
        """Land records bounced by a live range migration one at a time,
        each routed by its own inode against a fresh partition table.
        The bounced attempt never applied (the fence is checked before
        — or deterministically instead of — the handler), so a fresh
        op_id on the new owner keeps exactly-once intact."""
        for w in waiters:
            try:
                ino = _routing_ino("submit", {"record": w.record})
                if ino is None:
                    raise FsError(
                        mn.EMOVED, "record has no routing inode")
                nmp = self.wrapper._mp_for(ino)
                meta, _ = self.wrapper._call_wire(
                    nmp, "submit", {"record": w.record})
                w.finish(meta["result"], None)
            except BaseException as e:  # noqa: BLE001 - per-record fate
                w.finish(None, e)


class MetaWrapper:
    """Routes inode/dentry ops to the owning meta partition by range."""

    def __init__(self, vol_view: dict, node_pool):
        self.mps = vol_view["mps"]
        self.nodes = node_pool
        self._rr = 0
        self._lock = lockwitness.make_lock("MetaWrapper._lock")
        # range-table watermark: every committed split/merge bumps it
        # exactly once on the master, so staleness is one compare
        self.mp_version = vol_view.get("mp_version", 0)
        # FileSystem wires this to the master's client_view when it
        # knows a master address; a range miss or 453 redirect re-pulls
        # the table through it before giving up
        self._refresh_cb = None
        self._refresh_ts = 0.0
        # binary meta plane (manager_op.go): metanodes that advertise a
        # packet address serve the hot ops over persistent TCP; HTTP
        # stays as the per-address fallback (same negative-cache
        # discipline as the data path)
        self.packet_addrs: dict[str, str] = dict(
            vol_view.get("meta_packet_addrs") or {})
        # native C++ read plane (fastest): read ops try it first, then
        # the Python packet plane, then HTTP — per-plane negative cache
        self.read_addrs: dict[str, str] = dict(
            vol_view.get("meta_read_addrs") or {})
        self._packet_clients: dict[str, object] = {}
        self._packet_down: dict[str, float] = {}  # plane addr -> retry ts
        # cross-partition fan-out coalescer: submits queue per partition
        # and ship as submit_batch RPCs, up to K partitions' batches in
        # flight (CUBEFS_META_FANOUT=0 restores per-op submits — A/B)
        try:
            k = int(os.environ.get("CUBEFS_META_FANOUT", "8") or "0")
        except ValueError:
            k = 8
        self.fanout: SubmitFanout | None = (
            SubmitFanout(self, k) if k > 0 else None)

    def _mp_for(self, ino: int) -> dict:
        for mp in self.mps:
            if mp["start"] <= ino < mp["end"]:
                return mp
        # a miss usually means the table is stale (a split/merge landed
        # since the last view pull): re-fetch ONCE before giving up —
        # a freshly migrated inode must not surface as ENOENT
        if self.refresh_view(force=True):
            for mp in self.mps:
                if mp["start"] <= ino < mp["end"]:
                    return mp
        raise FsError(mn.ENOENT, f"no meta partition owns inode {ino}")

    def refresh_view(self, force: bool = False) -> bool:
        """Re-pull the volume view from the master (when FileSystem
        wired a callback). Throttled so a burst of misses costs one
        master round-trip; returns True when a pull happened."""
        cb = self._refresh_cb
        if cb is None:
            return False
        now = time.monotonic()
        if not force and now - self._refresh_ts < 1.0:
            return False
        self._refresh_ts = now
        try:
            view = cb()
        except Exception:  # noqa: BLE001 - stale table, retried later
            return False
        if (view.get("mp_version", 0) != self.mp_version
                or len(view.get("mps") or []) != len(self.mps)):
            self.update_mps(view["mps"], view.get("mp_version", 0))
        # migrations can land partitions on nodes this client has never
        # talked to: adopt their advertised planes too
        for a, p in (view.get("meta_packet_addrs") or {}).items():
            self.packet_addrs.setdefault(a, p)
        for a, p in (view.get("meta_read_addrs") or {}).items():
            self.read_addrs.setdefault(a, p)
        return True

    REDIRECT = 421  # metanode "not leader" status

    def _call(self, mp: dict, method: str, args: dict):
        """Partition call router: submits detour through the cross-
        partition fan-out coalescer when it's enabled (CUBEFS_META_FANOUT
        > 0) so concurrent mutations against one partition share a
        submit_batch RPC; everything else goes straight to the wire."""
        if method in ("submit", "submit_batch"):
            # client hop of the meta write path: the root span a
            # stitched client -> metanode -> raft trace hangs from
            with tracelib.path_span("meta.write", f"client.{method}") as sp:
                sp.set_tag("svc", "client").set_tag("pid", mp["pid"])
                if method == "submit" and self.fanout is not None:
                    return ({"result": self.fanout.submit(
                        mp, args["record"])}, b"")
                return self._call_wire(mp, method, args)
        return self._call_wire(mp, method, args)

    def _call_wire(self, mp: dict, method: str, args: dict):
        """Call the partition via the shared replica/redirect loop.
        Mutations ("submit"/"submit_batch") carry unique op_ids so a
        retry after a lost response is exactly-once; metanode 4xx codes
        map back to errnos. Hot ops ride the binary packet plane when
        advertised."""
        addrs = list(mp.get("addrs") or [mp["addr"]])
        payload = {"pid": mp["pid"], **args}
        if method == "submit":
            payload["record"] = dict(payload["record"])
            payload["record"].setdefault("op_id", uuid.uuid4().hex)
        elif method == "submit_batch":
            # stamp ids BEFORE the replica loop: a transport retry must
            # re-present the same ids for the dedup window to catch
            payload["records"] = [dict(r) for r in payload["records"]]
            for r in payload["records"]:
                r.setdefault("op_id", uuid.uuid4().hex)
        for attempt in range(self.MOVED_RETRIES + 1):
            try:
                if ((self.packet_addrs or self.read_addrs)
                        and method in _META_PACKET_OPS):
                    # same replica/redirect loop, per-address call
                    # swapped for the packet transport (with per-address
                    # HTTP fallback inside _packet_one)
                    return rpc.call_replicas(
                        self.nodes, addrs, method, payload, deadline=10.0,
                        call_fn=lambda a: (
                            self._packet_one(a, method, payload), b""))
                return rpc.call_replicas(self.nodes, addrs, method,
                                         payload, deadline=10.0)
            except rpc.RpcError as e:
                if _moved_exc(e) and attempt < self.MOVED_RETRIES:
                    nmp = self._moved_reroute(method, payload, attempt)
                    if nmp is not None:
                        mp = nmp
                        addrs = list(mp.get("addrs") or [mp["addr"]])
                        payload["pid"] = mp["pid"]
                        continue
                if _moved_exc(e) and method == "alloc_ino":
                    # no routing inode to chase: surface the standard
                    # range-exhausted errno so inode_create rotates to
                    # the next partition (and picks up the new one on
                    # its next view refresh)
                    raise FsError(
                        28, f"mp {payload['pid']} inode range "
                            f"migrating: {e.message}") from None
                if e.code == 499 and e.message.startswith("errno="):
                    errno_ = int(
                        e.message[len("errno="):].split(":", 1)[0])
                    raise FsError(errno_, e.message) from None
                if (400 <= e.code < 500
                        and e.code not in (404, self.REDIRECT,
                                           rpc.GEO_REDIRECT,
                                           rpc.RANGE_MOVED)):
                    # 452/453 are ROUTING codes like 421, not errnos:
                    # if one still surfaces here the retries above are
                    # exhausted — bubble the transport error instead of
                    # minting a bogus errno-52/53
                    raise FsError(e.code - 400, e.message) from None
                raise

    # bounded chase of a migrating range: the freeze window is the
    # donor's delta drain + target replay + master commit — short, but
    # real; each retry re-pulls the table and backs off a little
    MOVED_RETRIES = 8

    def _moved_reroute(self, method: str, payload: dict,
                       attempt: int) -> dict | None:
        """Resolve a 453/EMOVED bounce against a fresh partition table.
        Returns the partition to retry against, or None when this call
        has no single routing inode (the caller falls back: alloc_ino
        rotates, submit_batch re-lands per record)."""
        ino = _routing_ino(method, payload)
        if ino is None:
            return None
        self.refresh_view(force=True)
        try:
            nmp = self._mp_for(ino)
        except FsError:
            return None
        if nmp["pid"] == payload["pid"]:
            # the commit hasn't published yet: wait out a slice of the
            # freeze window before re-presenting the same op_id
            r = _MOVED_BACKOFF.start(op="meta.moved_chase")
            r.attempt = attempt
            r.tick(reason="range-moved")
        return nmp

    def _packet_one(self, addr: str, method: str, payload: dict) -> dict:
        """One meta call to one node, trying the fastest advertised
        plane first: native C++ read plane (read ops only) -> Python
        packet plane -> HTTP. Packet rpc-status errors are re-raised as
        RpcError so every transport shares one redirect / errno
        semantics; protocol-level failures negative-cache that plane
        only and fall through to the next."""
        planes = []
        if method in _META_READ_OPS and addr in self.read_addrs:
            planes.append(self.read_addrs[addr])
        paddr = self.packet_addrs.get(addr)
        if paddr:
            planes.append(paddr)
        for plane in planes:
            if time.monotonic() < self._packet_down.get(plane, 0.0):
                continue
            cli = self._packet_clients.get(plane)
            if cli is None:
                cli = self._packet_clients[plane] = pkt.PacketClient(
                    plane, timeout=10.0, connect_timeout=2.0)
            op = _META_PACKET_OPS[method]
            idem = op in pkt.IDEMPOTENT_OPS
            if not idem:
                # mutations are retry-safe on this transport only
                # because _call_wire / inode_create stamped op_ids
                # BEFORE the replica loop — assert the contract here,
                # where the idempotent flag is minted
                assert _op_ids_stamped(method, payload), \
                    f"unstamped mutating meta op {method!r}"
                idem = True
            try:
                rargs, _ = cli.call(op, args=payload, idempotent=idem)
                return rargs
            except pkt.PacketError as e:
                if e.code is not None:
                    raise rpc.RpcError(e.code, e.message) from None
                # protocol-level failure (crc, desync): distrust this
                # plane for a while, fall through to the next
                self._packet_down[plane] = time.monotonic() + 30.0
            except (ConnectionError, OSError, TimeoutError):
                self._packet_down[plane] = time.monotonic() + 30.0
        meta, _ = self.nodes.get(addr).call(method, payload)
        return meta

    # ---- inode/dentry API (reference sdk/meta/api.go shapes) ----
    def inode_create(self, typ: str, mode: int = 0o644, target=None,
                     quota_ids: list[int] | None = None) -> dict:
        # rotate across a SNAPSHOT of the partition table from a
        # captured offset, so every partition is tried exactly once even
        # when concurrent creates advance the shared cursor; a
        # range-exhausted mp (ENOSPC from alloc_ino) is skipped — the
        # master's split sweep appends fresh partitions, which a view
        # refresh picks up
        last: FsError | None = None
        for sweep in range(2):
            mps = list(self.mps)
            with self._lock:
                offset = self._rr
                self._rr += 1
            for step in range(len(mps)):
                mp = mps[(offset + step) % len(mps)]
                try:
                    ino = self._call(mp, "alloc_ino",
                                     {"op_id": uuid.uuid4().hex})[0]["ino"]
                except FsError as e:
                    if e.errno == 28:  # inode range exhausted/migrating
                        last = e
                        continue
                    raise
                rec = {"op": "mk_inode", "ino": ino, "type": typ,
                       "mode": mode, "ts": time.time()}
                if target is not None:
                    rec["target"] = target
                if quota_ids:
                    rec["quota_ids"] = list(quota_ids)
                self._call(mp, "submit", {"record": rec})
                return self.inode_get(ino)
            # every partition we KNOW is exhausted — but a split/merge
            # may have republished the table since our last view pull;
            # re-fetch once and re-rotate before giving up
            if sweep or not self.refresh_view(force=True):
                break
        raise last if last else FsError(28, "no meta partition has free inodes")

    def update_mps(self, mps: list[dict],
                   version: int | None = None) -> None:
        """Adopt a refreshed partition table (e.g. after an mp split)."""
        self.mps = mps
        if version is not None:
            self.mp_version = version

    def walk(self, ino: int, names: list[str],
             stat: bool = False) -> tuple[int, dict | None]:
        """Server-side path walk: ONE round trip consumes as many
        components as the target node leader-serves (vs one lookup RT
        per component). Partial results resume at the partition owning
        the returned ino; a no-progress partial (leadership mid-move)
        degrades to a single classic lookup so the loop always
        terminates."""
        names = list(names)
        out: dict = {}
        while names:
            mp = self._mp_for(ino)
            out = self._call(mp, "walk",
                             {"ino": ino, "names": names,
                              "stat": stat})[0]
            remaining = out["remaining"]
            if not remaining:
                ino = out["ino"]
                break
            if out["ino"] == ino and len(remaining) == len(names):
                # no progress (leadership mid-move): one classic lookup
                # guarantees forward motion
                ino = self.lookup(ino, names[0])
                names = names[1:]
            else:
                ino, names = out["ino"], remaining
            out = {}
        inode = out.get("inode")
        if stat and inode is None:
            inode = self.inode_get(ino)
        return ino, inode

    def mknod(self, parent: int, name: str, typ: str, mode: int = 0o644,
              target=None, quota_ids: list[int] | None = None) -> int:
        """Compound create: inode + dentry in ONE commit against the
        parent's partition (locality-preserving placement). Falls back
        to the classic alloc-elsewhere + two commits when the parent's
        inode range is exhausted."""
        rec = {"op": "mknod", "parent": parent, "name": name, "type": typ,
               "mode": mode, "ts": time.time()}
        if target is not None:
            rec["target"] = target
        if quota_ids:
            rec["quota_ids"] = list(quota_ids)
        try:
            mp = self._mp_for(parent)
            return self._call(mp, "submit",
                              {"record": rec})[0]["result"]["ino"]
        except FsError as e:
            if e.errno != 28:
                raise
        inode = self.inode_create(typ, mode, target=target,
                                  quota_ids=quota_ids)
        try:
            self.dentry_create(parent, name, inode["ino"])
        except FsError:
            self.inode_delete(inode["ino"])
            raise
        return inode["ino"]

    def unlink2(self, parent: int, name: str) -> int:
        """Compound unlink (dentry + inode, one commit). Raises
        FsError(18) when the child inode is in another partition — the
        caller runs the classic two-op path."""
        mp = self._mp_for(parent)
        rec = {"op": "unlink2", "parent": parent, "name": name,
               "ts": time.time()}
        return self._call(mp, "submit", {"record": rec})[0]["result"]["ino"]

    def inode_get(self, ino: int) -> dict:
        mp = self._mp_for(ino)
        return self._call(mp, "inode_get", {"ino": ino})[0]["inode"]

    def inode_delete(self, ino: int) -> list:
        mp = self._mp_for(ino)
        res = self._call(mp, "submit", {"record": {
            "op": "rm_inode", "ino": ino, "ts": time.time()}})
        return res[0]["result"].get("extents", [])

    # ---- hardlinks (metanode CreateLink role) ----
    def inc_nlink(self, ino: int) -> int:
        mp = self._mp_for(ino)
        res = self._call(mp, "submit", {"record": {
            "op": "inc_nlink", "ino": ino, "ts": time.time()}})
        return res[0]["result"]["nlink"]

    def dec_nlink(self, ino: int) -> bool:
        """Drop one link; True when the inode was removed (last link)."""
        mp = self._mp_for(ino)
        res = self._call(mp, "submit", {"record": {
            "op": "dec_nlink", "ino": ino, "ts": time.time()}})
        return res[0]["result"]["removed"]

    def dentry_create(self, parent: int, name: str, ino: int) -> None:
        mp = self._mp_for(parent)
        self._call(mp, "submit", {"record": {
            "op": "mk_dentry", "parent": parent, "name": name, "ino": ino}})

    def dentry_delete(self, parent: int, name: str) -> int:
        mp = self._mp_for(parent)
        res = self._call(mp, "submit", {"record": {
            "op": "rm_dentry", "parent": parent, "name": name}})
        return res[0]["result"]["ino"]

    def lookup(self, parent: int, name: str) -> int:
        mp = self._mp_for(parent)
        return self._call(mp, "lookup", {"parent": parent, "name": name})[0]["ino"]

    def readdir(self, parent: int) -> dict[str, int]:
        mp = self._mp_for(parent)
        return self._call(mp, "readdir", {"parent": parent})[0]["entries"]

    def dentry_count(self, parent: int) -> int:
        mp = self._mp_for(parent)
        return self._call(mp, "dentry_count", {"parent": parent})[0]["count"]

    def freelist_all(self) -> dict[str, dict]:
        """Pending deferred deletions across all partitions (fsck input:
        these extents are freed-but-not-yet-deleted, not orphans)."""
        out: dict[str, dict] = {}
        for mp in self.mps:
            try:
                fl = self._call(mp, "freelist", {})[0]["freelist"]
            except (FsError, rpc.RpcError):
                continue
            for k, v in fl.items():
                out[f"{mp['pid']}:{k}"] = v
        return out

    def list_inos(self) -> set[int]:
        """Every inode id the partitions hold (fsck's orphan-inode pass)."""
        inos: set[int] = set()
        for mp in self.mps:
            try:
                inos.update(self._call(mp, "list_inos", {})[0]["inos"])
            except (FsError, rpc.RpcError):
                pass
        return inos

    def append_extents(self, ino: int, extents: list[dict], size: int) -> None:
        mp = self._mp_for(ino)
        self._call(mp, "submit", {"record": {
            "op": "append_extents", "ino": ino, "extents": extents,
            "size": size, "ts": time.time()}})

    def set_attr(self, ino: int, **attrs) -> None:
        mp = self._mp_for(ino)
        self._call(mp, "submit", {"record": {
            "op": "set_attr", "ino": ino, **attrs, "ts": time.time()}})

    def set_xattr(self, ino: int, key: str, value) -> None:
        mp = self._mp_for(ino)
        self._call(mp, "submit", {"record": {
            "op": "set_xattr", "ino": ino, "key": key, "value": value}})

    def truncate(self, ino: int, size: int = 0) -> list:
        mp = self._mp_for(ino)
        res = self._call(mp, "submit", {"record": {
            "op": "truncate", "ino": ino, "size": size, "ts": time.time()}})
        return res[0]["result"].get("extents", [])

    # ---- cold-tier migration FSM (fs/tiering.py is the sole driver;
    # each step is one idempotent op_id-stamped submit, so WAL replay
    # and transport retries land exactly once) ----
    def tiering_prepare(self, ino: int) -> dict:
        res = self._call(self._mp_for(ino), "submit", {"record": {
            "op": "tiering_prepare", "ino": ino, "ts": time.time()}})
        return res[0]["result"]

    def tiering_blob_written(self, ino: int, gen: int, location: dict) -> dict:
        res = self._call(self._mp_for(ino), "submit", {"record": {
            "op": "tiering_blob_written", "ino": ino, "gen": gen,
            "location": location, "ts": time.time()}})
        return res[0]["result"]

    def tiering_commit(self, ino: int, gen: int) -> dict:
        res = self._call(self._mp_for(ino), "submit", {"record": {
            "op": "tiering_commit", "ino": ino, "gen": gen,
            "ts": time.time()}})
        return res[0]["result"]

    def tiering_finish(self, ino: int) -> dict:
        res = self._call(self._mp_for(ino), "submit", {"record": {
            "op": "tiering_finish", "ino": ino, "ts": time.time()}})
        return res[0]["result"]

    def tiering_abort(self, ino: int) -> dict:
        res = self._call(self._mp_for(ino), "submit", {"record": {
            "op": "tiering_abort", "ino": ino, "ts": time.time()}})
        return res[0]["result"]

    def untier_commit(self, ino: int, gen: int, extents: list[dict]) -> dict:
        res = self._call(self._mp_for(ino), "submit", {"record": {
            "op": "untier_commit", "ino": ino, "gen": gen,
            "extents": extents, "ts": time.time()}})
        return res[0]["result"]

    def blob_freelist_all(self) -> dict[str, dict]:
        """Pending deferred blob deletions across all partitions, keyed
        `pid:key` (reaper input; fsck counts these as referenced)."""
        out: dict[str, dict] = {}
        for mp in self.mps:
            try:
                fl = self._call(
                    mp, "blob_freelist", {})[0]["blob_freelist"]
            except (FsError, rpc.RpcError):
                continue
            for k, v in fl.items():
                out[f"{mp['pid']}:{k}"] = v
        return out

    def blob_free_done(self, pid: int, key: str) -> None:
        for mp in self.mps:
            if mp["pid"] == pid:
                self._call(mp, "submit", {"record": {
                    "op": "blob_free_done", "key": key}})
                return
        raise FsError(mn.ENOENT, f"no meta partition {pid}")

    def blob_reconcile_enqueue(self, location: dict) -> None:
        """Inventory-reconciliation sink: a blob-plane location that no
        inode references rides the blob_freelist so the existing reaper
        deletes it (satellite: closes the put->blob_written leak
        window)."""
        self._call(self.mps[0], "submit", {"record": {
            "op": "blob_reconcile_enqueue", "location": location,
            "ts": time.time()}})

    # ---- rename (atomic; metanode/transaction.go analog) ----
    def rename_local(self, src_parent: int, src_name: str,
                     dst_parent: int, dst_name: str, ino: int,
                     victim: int | None = None,
                     noreplace: bool = False) -> int | None:
        """Same-partition atomic rename; `victim` is the dst inode the
        caller validated (re-asserted inside the apply); `noreplace`
        makes an existing target EEXIST atomically. Returns the
        replaced victim inode (or None)."""
        mp = self._mp_for(src_parent)
        res = self._call(mp, "submit", {"record": {
            "op": "rename_local", "src_parent": src_parent,
            "src_name": src_name, "dst_parent": dst_parent,
            "dst_name": dst_name, "ino": ino, "victim": victim,
            "noreplace": noreplace}})
        return res[0]["result"].get("victim")

    def _mp_ref(self, mp: dict) -> dict:
        return {"pid": mp["pid"],
                "addrs": list(mp.get("addrs") or [mp["addr"]])}

    def rename_tx(self, src_parent: int, src_name: str,
                  dst_parent: int, dst_name: str, ino: int,
                  victim: int | None = None,
                  victim_is_dir: bool = False,
                  noreplace: bool = False) -> int | None:
        """Cross-partition rename as a two-phase transaction. The DST
        partition is the coordinator: it is prepared and committed FIRST,
        so its durable commit decision is what an expired participant
        consults (roll forward) — no crash point leaves the file linked
        twice or lost. The coordinator's prepare lists the participants,
        so its scanner pushes the decision and only drops the commit
        record once everyone has resolved. A dir victim gets a
        guard_empty_dir participant on its own partition, locking out
        new children while the tx is in flight. Returns the replaced
        victim inode (or None)."""
        src_mp = self._mp_for(src_parent)
        dst_mp = self._mp_for(dst_parent)
        tx_id = uuid.uuid4().hex
        coord = self._mp_ref(dst_mp)
        ts = time.time()
        # group sub-ops by owning partition (src/dst/guard may coincide)
        by_pid: dict[int, tuple[dict, list[dict]]] = {}

        def add_op(mp_, op_):
            by_pid.setdefault(mp_["pid"], (mp_, []))[1].append(op_)

        add_op(dst_mp, {"kind": "link", "parent": dst_parent,
                        "name": dst_name, "ino": ino, "victim": victim,
                        "noreplace": noreplace})
        add_op(src_mp, {"kind": "rm", "parent": src_parent,
                        "name": src_name, "ino": ino})
        if victim is not None and victim_is_dir:
            # lock the victim dir on ITS partition so no child can appear
            # between the client's emptiness check and the commit
            add_op(self._mp_for(victim),
                   {"kind": "guard_empty_dir", "parent": victim, "name": ""})
        dst_ops = by_pid.pop(dst_mp["pid"])[1]
        part_preps = list(by_pid.values())
        parts = [self._mp_ref(mp_) for mp_, _ in part_preps]
        self._call(dst_mp, "submit", {"record": {
            "op": "tx_prepare", "tx_id": tx_id, "coord": coord,
            "parts": parts, "ts": ts, "ops": dst_ops}})
        prepared: list[dict] = []
        try:
            for mp_, ops_ in part_preps:
                self._call(mp_, "submit", {"record": {
                    "op": "tx_prepare", "tx_id": tx_id, "coord": coord,
                    "ts": ts, "ops": ops_}})
                prepared.append(mp_)
        except FsError:
            for mp_ in [dst_mp] + prepared:
                try:
                    self._call(mp_, "submit", {"record": {
                        "op": "tx_abort", "tx_id": tx_id}})
                except FsError:
                    pass
            raise
        res = self._call(dst_mp, "submit", {"record": {
            "op": "tx_commit", "tx_id": tx_id, "ts": ts}})
        for mp_, _ in part_preps:
            try:
                self._call(mp_, "submit", {"record": {
                    "op": "tx_commit", "tx_id": tx_id, "ts": ts}})
            except (FsError, rpc.RpcError):
                # the coordinator's commit IS the outcome: a transiently
                # unreachable participant gets the decision pushed by the
                # coordinator's scanner; reporting failure here would be
                # wrong (and would skip the victim cleanup)
                pass
        victims = res[0]["result"].get("victims") or []
        return victims[0] if victims else None

    # ---- the cluster-wide dir-rename mutex (s_vfs_rename_mutex analog):
    # cross-directory DIR renames serialize on one named lock on the
    # root-owning partition, so two concurrent dir moves cannot weave a
    # detached cycle past each other's ancestry checks. Held as a
    # prepared tx: a crashed holder is auto-released by TX_TTL expiry.
    def lock_dir_rename(self, timeout: float = 10.0) -> tuple[str, float]:
        """Returns (tx_id, ts): ts is the stamp the TTL counts from —
        holders must derive their work deadline from it, not from the
        (later) moment the grant RPC returned."""
        mp = self._mp_for(1)
        tx_id = uuid.uuid4().hex
        r = rpc.FAILOVER_POLICY.start(op="dir_rename_lock", deadline=timeout)
        while True:
            ts = time.time()
            try:
                self._call(mp, "submit", {"record": {
                    "op": "tx_prepare", "tx_id": tx_id, "ts": ts,
                    "coord": self._mp_ref(mp),
                    "ops": [{"kind": "mutex", "parent": 0,
                             "name": "__dir_rename__"}]}})
                return tx_id, ts
            except FsError as e:
                # EBUSY: another rename holds the mutex; back off within
                # the timeout instead of spinning at a fixed 50 ms
                if e.errno != 16 or not r.tick(reason="mutex-busy"):
                    raise

    def unlock_dir_rename(self, tx_id: str) -> None:
        self._call(self._mp_for(1), "submit", {"record": {
            "op": "tx_abort", "tx_id": tx_id}})


class ExtentClient:
    """Streaming extent IO against data partitions.

    Write: route to a dp leader, allocate/reuse an extent, chain-write,
    then commit the extent key to the metanode (write-then-commit order,
    like the Streamer's flush)."""

    PACKET = 128 << 10  # write packet granularity
    EXTENT_CAP = 128 << 20  # roll to a fresh extent past this (max extent)
    TINY_THRESHOLD = 4 << 10  # small writes pack into shared tiny extents
    TINY_EXTENT_CAP = 8 << 20

    def __init__(self, vol_view: dict, node_pool):
        self.dps = vol_view["dps"]
        self.nodes = node_pool
        # binary packet plane per datanode (proto/packet.go transport):
        # replicas that advertise one serve reads over persistent TCP
        self.packet_addrs: dict[str, str] = dict(
            vol_view.get("packet_addrs") or {})
        # native C++ read plane (dataserve.cc): reads try it first
        self.read_addrs: dict[str, str] = dict(
            vol_view.get("data_read_addrs") or {})
        self._packet_clients: dict[str, object] = {}
        self._packet_down: dict[str, float] = {}  # plane addr -> retry ts
        self._rr = 0
        self._lock = lockwitness.make_lock("ExtentClient._lock")
        # per-inode open extent: ino -> (dp, extent_id, next_offset)
        self._streams: dict[int, tuple[dict, int, int]] = {}
        # shared tiny-extent stream (datanode storage_tinyfile role):
        # many small files append into ONE extent, so a million 1KB files
        # don't cost a million extents. _tiny_lock guards offset
        # RESERVATION only (the stream is shared across inodes); the
        # writes themselves run concurrently on disjoint ranges.
        self._tiny: tuple[dict, int, int] | None = None
        self._tiny_lock = lockwitness.make_lock("ExtentClient._tiny_lock")
        self._latency: dict[str, float] = {}  # addr -> EWMA seconds

    def _pick_dp(self) -> dict:
        with self._lock:
            dp = self.dps[self._rr % len(self.dps)]
            self._rr += 1
            return dp

    def write(self, meta: MetaWrapper, ino: int, file_offset: int,
              data: bytes) -> None:
        """Write through the inode's open extent, rolling to fresh
        extents at the cap — a single huge write spans several extent
        keys, like the streamer's packet pipeline."""
        if not data:
            # empty write: no extent to allocate, but the mtime/gen stamp
            # must still land (an empty overwrite fences a tiering commit
            # like any other data mutation)
            meta.append_extents(ino, [], size=file_offset)
            return
        if len(data) <= self.TINY_THRESHOLD and file_offset == 0:
            self._write_tiny(meta, ino, data)
            return
        extent_keys = self.write_extents(ino, file_offset, data)
        meta.append_extents(ino, extent_keys, size=file_offset + len(data))

    def write_extents(self, ino: int, file_offset: int,
                      data: bytes) -> list[dict]:
        """Write payload bytes to datanode extents WITHOUT registering
        them on the metanode — the caller owns the commit. write() pairs
        this with append_extents; the tiering engine's un-tier path
        instead lands the keys through one fenced untier_commit apply,
        so a racing write can atomically reject the whole re-heat."""
        extent_keys: list[dict] = []
        done = 0
        while done < len(data):
            with self._lock:
                stream = self._streams.get(ino)
            if stream is not None and stream[2] >= self.EXTENT_CAP:
                stream = None  # extent full: roll to a new one
            if stream is None:
                dp = self._pick_dp()
                leader = self.nodes.get(dp["leader"])
                eid = leader.call("alloc_extent",
                                  {"dp_id": dp["dp_id"],
                                   "op_id": uuid.uuid4().hex})[0]["extent_id"]
                ext_off = 0
            else:
                dp, eid, ext_off = stream
                leader = self.nodes.get(dp["leader"])
            seg = min(len(data) - done, self.EXTENT_CAP - ext_off)
            self._write_pieces(dp, eid, ext_off, memoryview(data), done, seg)
            extent_keys.append({
                "dp_id": dp["dp_id"], "extent_id": eid, "ext_offset": ext_off,
                "file_offset": file_offset + done, "size": seg,
            })
            with self._lock:
                self._streams[ino] = (dp, eid, ext_off + seg)
            done += seg
        return extent_keys

    def _write_tiny(self, meta: MetaWrapper, ino: int, data: bytes) -> None:
        """Append a whole small file into the shared tiny extent; the
        extent key is flagged tiny so per-file GC skips it (space comes
        back via scrub-compaction, the punch-hole analog).

        Scope: the tiny stream is per-ExtentClient, so packing pays off
        for long-lived clients (gateway/FUSE/SDK daemons); one-shot CLI
        invocations still get one extent per file. Datanode-side shared
        tiny extents and tiny-extent space compaction (punch-hole) are
        future work — fsck reports wholly-dead tiny extents meanwhile."""
        # reserve the (dp, extent, offset) range under the lock; the
        # networked write + meta commit — AND the alloc_extent RPC when
        # the shared extent rolls — run OUTSIDE it, so one slow datanode
        # round-trip never stalls every concurrent small-file write
        while True:
            with self._tiny_lock:
                tiny = self._tiny
                if (tiny is not None
                        and tiny[2] + len(data) <= self.TINY_EXTENT_CAP):
                    dp, eid, off = tiny
                    self._tiny = (dp, eid, off + len(data))
                    break
            # shared extent absent/full: allocate a replacement without
            # holding the lock, then race to install it. A loser's spare
            # extent stays empty (fsck reports it wholly dead); the
            # loser re-checks and packs into the winner's extent.
            dp = self._pick_dp()
            eid = self.nodes.get(dp["leader"]).call(
                "alloc_extent", {"dp_id": dp["dp_id"],
                                 "op_id": uuid.uuid4().hex})[0]["extent_id"]
            with self._tiny_lock:
                cur = self._tiny
                if cur is None or cur[2] + len(data) > self.TINY_EXTENT_CAP:
                    off = 0
                    self._tiny = (dp, eid, len(data))
                    break
        self._leader_write(dp, eid, off, data)
        meta.append_extents(
            ino,
            [{"dp_id": dp["dp_id"], "extent_id": eid, "ext_offset": off,
              "file_offset": 0, "size": len(data), "tiny": True}],
            size=len(data),
        )

    def close_stream(self, ino: int) -> None:
        with self._lock:
            self._streams.pop(ino, None)

    def _dp_by_id(self, dp_id: int) -> dict:
        for dp in self.dps:
            if dp["dp_id"] == dp_id:
                return dp
        raise FsError(5, f"unknown dp {dp_id}")

    def read(self, inode: dict, offset: int, length: int) -> bytes:
        """Assemble file bytes from the extent list (later keys win)."""
        size = inode["size"]
        if offset >= size:
            return b""
        length = min(length, size - offset)
        out = bytearray(length)
        for ek in inode["extents"]:
            lo = max(offset, ek["file_offset"])
            hi = min(offset + length, ek["file_offset"] + ek["size"])
            if lo >= hi:
                continue
            dp = self._dp_by_id(ek["dp_id"])
            data = self._read_replicated(
                dp, ek["extent_id"], ek["ext_offset"] + (lo - ek["file_offset"]),
                hi - lo,
            )
            out[lo - offset : hi - offset] = data
        return bytes(out)

    def _read_replicated(self, dp: dict, eid: int, off: int, ln: int) -> bytes:
        """Read from the historically-fastest replica first (k-faster
        selector role: an EWMA of per-address latency orders candidates;
        failures and SHORT reads fall through to the next replica).

        Unmeasured replicas get the median of the measured ones as a
        neutral prior (never 0 — a fresh, possibly mid-repair replica
        must not outrank a known-fast one), with the leader as the
        tiebreak."""
        known = sorted(self._latency.get(a) for a in dp["replicas"]
                       if a in self._latency)
        # unmeasured replicas: just under the median — they never outrank
        # a known-fast replica by much, but do outrank a known-slow one
        prior = known[len(known) // 2] * 0.99 if known else 0.0
        order = sorted(
            dp["replicas"],
            key=lambda a: (self._latency.get(a, prior),
                           0 if a == dp["leader"] else 1),
        )
        last_err = None
        crc_failed: list[str] = []  # replicas that served a CRC 409
        for addr in order:
            t0 = time.monotonic()
            try:
                data = self._read_one(addr, dp["dp_id"], eid, off, ln)
                if len(data) != ln:
                    # lagging / mid-repair replica: treat like a failure,
                    # a short read silently corrupts the assembled file
                    raise rpc.RpcError(
                        409, f"short read {len(data)} != {ln} from {addr}"
                    )
            except rpc.RpcError as e:
                last_err = e
                # a 409 that is NOT a short read is a CRC/integrity
                # refusal: remember the replica for read-repair once a
                # healthy copy answers (short reads are laggards, not
                # rot — repairing them would be a false repair)
                if e.code == 409 and "short read" not in str(e):
                    crc_failed.append(addr)
                # heavy penalty so failed replicas sort last for a while
                self._latency[addr] = self._latency.get(addr, 0.0) * 0.7 + 0.3 * 5.0
                continue
            dt = time.monotonic() - t0
            self._latency[addr] = self._latency.get(addr, dt) * 0.7 + 0.3 * dt
            if crc_failed:
                self._read_repair(dp, eid, addr, crc_failed)
            return data
        raise FsError(5, f"all replicas failed for dp {dp['dp_id']}: {last_err}")

    def _read_repair(self, dp: dict, eid: int, healthy_addr: str,
                     bad_addrs: list[str]) -> None:
        """Transparent fs-plane read-repair: the replica that refused a
        read with a CRC 409 gets rewritten in place from the replica
        that just served the bytes, through the ONE sanctioned healer
        (DataNode.sync_extent_from — same path scrub and fsck --heal
        use). Synchronous and best-effort: the client already has good
        bytes, so a repair failure only counts a metric. Door:
        CUBEFS_VERIFY_READS=0 turns repair off (detection still 409s;
        the door is FSM-digest-identical because repairs never write
        FSM records)."""
        if os.environ.get("CUBEFS_VERIFY_READS", "1") == "0":
            return
        for bad in bad_addrs:
            with tracelib.path_span("fs.read", "integrity.read_repair") as sp:
                sp.set_tag("dp_id", dp["dp_id"])
                sp.set_tag("extent_id", eid)
                sp.set_tag("bad", bad)
                try:
                    self.nodes.get(bad).call(
                        "sync_extent_from",
                        {"dp_id": dp["dp_id"], "extent_id": eid,
                         "src_addr": healthy_addr, "source": "read"},
                        timeout=30.0)
                except (rpc.RpcError, OSError):
                    _metrics.integrity_repair_failures.inc(plane="fs")

    def _write_pieces(self, dp: dict, eid: int, ext_off: int,
                      data: memoryview, done: int, seg: int) -> None:
        """Ship one extent segment as PACKET-granularity pieces. On the
        mux transport up to CUBEFS_PKT_WINDOW pieces pipeline in flight
        on the shared connection (the streamer's packet-pipeline shape);
        the legacy/RPC paths keep the serial piece loop. Pieces land at
        disjoint absolute offsets, so in-window reordering is harmless —
        the datanode's per-extent lock orders overlapping writes."""
        cli, paddr = self._write_plane(dp)
        if cli is None or not cli.mux:
            written = 0
            while written < seg:
                piece = data[done + written
                             : done + min(written + self.PACKET, seg)]
                self._leader_write(dp, eid, ext_off + written, piece)
                written += len(piece)
            return
        from ..utils import packet as pkt

        window = pkt.window_size()
        futs: list[tuple] = []  # (future, piece offset)
        written = 0
        try:
            while written < seg:
                piece = data[done + written
                             : done + min(written + self.PACKET, seg)]
                off = ext_off + written
                # absolute bytes at a fixed (extent, offset): a
                # reconnect-resend rewrites the identical range (the
                # rpc_allowlist 'write_replica' justification family)
                fut = cli.call_async(
                    pkt.OP_WRITE, partition=dp["dp_id"], extent=eid,
                    offset=off, payload=piece, idempotent=True)
                futs.append((fut, off))
                written += len(piece)
                if len(futs) >= window:
                    self._collect_write(futs.pop(0), dp, paddr)
            while futs:
                self._collect_write(futs.pop(0), dp, paddr)
        finally:
            # a failed window must not leave unreaped in-flight pieces
            for fut, _ in futs:
                try:
                    fut.result(cli.timeout)
                except Exception:
                    pass

    def _collect_write(self, ent: tuple, dp: dict, paddr: str) -> None:
        """Resolve one pipelined write piece, mapping failures exactly
        like the serial `_leader_write` packet leg."""
        from ..utils import packet as pkt

        fut, off = ent
        addr = dp["leader"]
        try:
            fut.result()
        except pkt.PacketError as e:
            raise rpc.RpcError(500, f"packet write: {e}") from None
        except TimeoutError:
            self._packet_down[paddr] = time.monotonic() + 30.0
            raise rpc.RpcError(
                504, f"packet write to {addr} timed out; "
                     f"possibly still executing") from None
        except (ConnectionError, OSError) as e:
            # unlike the serial leg there is no same-call RPC fallback
            # mid-window (earlier pieces already rode the packet plane);
            # negative-cache the plane and surface — the caller owns
            # the retry, and its next attempt takes the RPC path
            self._packet_down[paddr] = time.monotonic() + 30.0
            raise rpc.RpcError(503, f"packet write: {e}") from None

    def _write_plane(self, dp: dict):
        """The leader's usable packet-plane client, or (None, None) when
        none is advertised / the plane is in negative-cache cooldown."""
        paddr = self.packet_addrs.get(dp["leader"])
        if not paddr or time.monotonic() < self._packet_down.get(paddr, 0.0):
            return None, None
        from ..utils import packet as pkt

        cli = self._packet_clients.get(paddr)
        if cli is None:
            cli = self._packet_clients[paddr] = pkt.PacketClient(
                paddr, timeout=30.0, connect_timeout=2.0)
        return cli, paddr

    def _leader_write(self, dp: dict, eid: int, off: int,
                      data: bytes) -> None:
        """One write leg to the designated leader: the binary packet
        plane when advertised (same negative-cache discipline as reads),
        RPC otherwise. Server-side semantics are identical — both
        transports enter DataNode.write()."""
        addr = dp["leader"]
        paddr = self.packet_addrs.get(addr)
        # keyed by PLANE addr, shared with _read_one: a packet plane a
        # read discovered dead suppresses writes too (and one client
        # pool serves both directions)
        if paddr and time.monotonic() >= self._packet_down.get(paddr, 0.0):
            from ..utils import packet as pkt

            cli = self._packet_clients.get(paddr)
            if cli is None:
                cli = self._packet_clients[paddr] = pkt.PacketClient(
                    paddr, timeout=30.0, connect_timeout=2.0)
            try:
                # absolute bytes at a fixed (extent, offset): replay-safe
                cli.call(pkt.OP_WRITE, partition=dp["dp_id"], extent=eid,
                         offset=off, payload=data, idempotent=True)
                return
            except pkt.PacketError as e:
                raise rpc.RpcError(500, f"packet write: {e}") from None
            except TimeoutError:
                # the write may STILL be executing on a saturated peer:
                # an automatic RPC resend would double its load (and
                # could land behind a newer same-offset write). Surface
                # the timeout; the caller owns the retry decision.
                self._packet_down[paddr] = time.monotonic() + 30.0
                raise rpc.RpcError(
                    504, f"packet write to {addr} timed out; "
                         f"possibly still executing") from None
            except (ConnectionError, OSError):
                self._packet_down[paddr] = time.monotonic() + 30.0
        self.nodes.get(addr).call(
            "write", {"dp_id": dp["dp_id"], "extent_id": eid,
                      "offset": off}, data)

    def _read_one(self, addr: str, dp_id: int, eid: int, off: int,
                  ln: int) -> bytes:
        """One replica read, trying the fastest advertised plane first:
        the native C++ read plane (dataserve.cc), then the Python
        packet plane, then RPC. Transport failures negative-cache that
        plane only; protocol errors surface (the caller fails over to
        another replica)."""
        from ..utils import packet as pkt

        planes = []
        if addr in self.read_addrs:
            planes.append(self.read_addrs[addr])
        if addr in self.packet_addrs:
            planes.append(self.packet_addrs[addr])
        for plane in planes:
            if time.monotonic() < self._packet_down.get(plane, 0.0):
                continue
            cli = self._packet_clients.get(plane)
            if cli is None:
                # short connect timeout: a blackholed packet port must
                # not stall reads before the RPC fallback kicks in
                cli = self._packet_clients[plane] = pkt.PacketClient(
                    plane, timeout=30.0, connect_timeout=2.0)
            try:
                _, data = cli.call(pkt.OP_READ, partition=dp_id, extent=eid,
                                   offset=off, args={"length": ln})
                return data
            except pkt.PacketError as e:
                raise rpc.RpcError(409, f"packet read: {e}") from None
            except TimeoutError:
                # don't stack a second 30s wait on the same node: count
                # it as a replica failure so the read fails over to the
                # NEXT replica immediately
                self._packet_down[plane] = time.monotonic() + 30.0
                raise rpc.RpcError(
                    504, f"packet read from {addr} timed out") from None
            except (ConnectionError, OSError):
                # plane down: remember it and stop paying the connect
                # cost on every read until the cooldown passes
                self._packet_down[plane] = time.monotonic() + 30.0
        _, data = self.nodes.get(addr).call(
            "read", {"dp_id": dp_id, "extent_id": eid,
                     "offset": off, "length": ln},
        )
        return data


class FileSystem:
    """Path-level facade over meta + data clients (the VFS layer)."""

    QUOTA_TTL = 30.0  # seconds between quota-table refreshes

    def __init__(self, vol_view: dict, node_pool, master_addr: str | None = None,
                 *, flash_fgm=None, client_az: str | None = None,
                 blob_client=None):
        self.meta = MetaWrapper(vol_view, node_pool)
        self.data = ExtentClient(vol_view, node_pool)
        self.vol_name = vol_view.get("name")
        self.nodes = node_pool
        self.master_addr = master_addr
        self.client_az = client_az
        if master_addr is not None:
            # lets the meta router chase live range migrations (and
            # satisfy range misses) by re-pulling the view on demand
            self.meta._refresh_cb = self._fetch_view
        # A/B door for the AZ-local hot-read tier: CUBEFS_READ_CACHE=1
        # (plus a flash ring handle) routes reads through CachedReader;
        # off (default) is byte-for-byte the plain ExtentClient path.
        try:
            rc = int(os.environ.get("CUBEFS_READ_CACHE", "0") or "0")
        except ValueError:
            rc = 0
        self.read_cache = None
        if rc > 0 and flash_fgm is not None:
            try:
                hot = int(os.environ.get("CUBEFS_READ_HOT", "2") or "2")
            except ValueError:
                hot = 2
            from .remotecache import CachedReader
            self.read_cache = CachedReader(
                self.data, flash_fgm, node_pool, client_az=client_az,
                hotness_threshold=hot)
        # A/B door for transparent cold-tier read-through:
        # CUBEFS_TIERING=1 (plus a blob client) routes extent-less
        # cold.location inodes to the blob plane; off (default) is
        # byte-for-byte the pre-tiering path.
        self.tiering = None
        try:
            td = int(os.environ.get("CUBEFS_TIERING", "0") or "0")
        except ValueError:
            td = 0
        if td > 0 and blob_client is not None:
            from .tiering import TieringEngine
            self.tiering = TieringEngine(self, blob_client)
        # dir_ino -> [qid]: files created under a quota dir inherit its
        # ids (master_quota_manager.go analog); long-lived clients with a
        # master configured re-pull the table every QUOTA_TTL, so quotas
        # set after mount still take effect (sdk/meta quota-cache analog)
        self.quotas: dict[int, list[int]] = {}
        self._quota_ts = time.time()
        self.update_quotas(vol_view.get("quotas") or {})

    def update_quotas(self, quotas: dict) -> None:
        table: dict[int, list[int]] = {}
        for qid, q in quotas.items():
            table.setdefault(int(q["dir_ino"]), []).append(int(qid))
        self.quotas = table

    def _fetch_view(self) -> dict:
        return self.nodes.get(self.master_addr).call(
            "client_view", {"name": self.vol_name})[0]["volume"]

    def _maybe_refresh_quotas(self) -> None:
        if (self.master_addr is None
                or time.time() - self._quota_ts < self.QUOTA_TTL):
            return
        self._quota_ts = time.time()  # even on failure: don't hammer
        try:
            view = self._fetch_view()
            self.update_quotas(view.get("quotas") or {})
            # mp_version is the single range-table watermark: a merge
            # SHRINKS the table, so a length compare alone would miss it
            if (view.get("mp_version", 0) != self.meta.mp_version
                    or len(view.get("mps") or []) != len(self.meta.mps)):
                self.meta.update_mps(view["mps"],
                                     view.get("mp_version", 0))
        except Exception:
            pass  # stale table; retried after the next TTL

    # ---- path helpers ----
    def resolve(self, path: str) -> int:
        parts = [p for p in path.split("/") if p]
        if not parts:
            return mn.ROOT_INO
        ino, _ = self.meta.walk(mn.ROOT_INO, parts)
        return ino

    def _parent_of(self, path: str) -> tuple[int, str]:
        parent, _, name = self._walk_parent(path)
        return parent, name

    def _walk_parent(self, path: str) -> tuple[int, list[int], str]:
        """Resolve the parent dir, returning (parent_ino, ancestor_inos
        incl. parent, leaf_name) — the ancestor chain feeds quota
        inheritance, so the per-component walk only runs when quotas
        are actually configured; otherwise one server-side walk."""
        parts = [p for p in path.split("/") if p]
        if not parts:
            raise FsError(22, "root has no parent")
        if not self.quotas:
            parent, _ = self.meta.walk(mn.ROOT_INO, parts[:-1])
            return parent, [parent], parts[-1]
        parent = mn.ROOT_INO
        chain = [parent]
        for part in parts[:-1]:
            parent = self.meta.lookup(parent, part)
            chain.append(parent)
        return parent, chain, parts[-1]

    def _inherited_quota_ids(self, ancestors: list[int]) -> list[int]:
        out: list[int] = []
        for ino in ancestors:
            for qid in self.quotas.get(ino, []):
                if qid not in out:
                    out.append(qid)
        return out

    # ---- files & dirs ----
    def mkdir(self, path: str, mode: int = 0o755) -> int:
        parent, name = self._parent_of(path)
        return self.meta.mknod(parent, name, mn.DIR, mode)

    def create(self, path: str, mode: int = 0o644) -> int:
        self._maybe_refresh_quotas()
        parent, ancestors, name = self._walk_parent(path)
        qids = self._inherited_quota_ids(ancestors)
        return self.meta.mknod(parent, name, mn.FILE, mode,
                               quota_ids=qids)

    def write_file(self, path: str, data: bytes, append: bool = False) -> int:
        try:
            ino = self.resolve(path)
        except FsError:
            ino = self.create(path)
        inode = self.meta.inode_get(ino)
        off = inode["size"] if append else 0
        if not append and inode["size"]:
            if self.read_cache is not None:
                # overwrite: evict every flash copy of the old extents
                # BEFORE they leave the inode (write-path invalidation)
                self.read_cache.invalidate(inode.get("extents") or [])
            self.meta.truncate(ino, 0)
            self.data.close_stream(ino)
            # freed extents ride the metanode freelist: the server's
            # free scan deletes them (deferred deletion, crash-safe)
        self.data.write(self.meta, ino, off, data)
        return ino

    def pwrite_file(self, path: str, offset: int, data: bytes) -> int:
        """pwrite(2)-style offset write, creating the file on demand
        (the native C ABI's write leg)."""
        try:
            ino = self.resolve(path)
        except FsError:
            ino = self.create(path)
        if self.read_cache is not None:
            inode = self.meta.inode_get(ino)
            lo, hi = offset, offset + len(data)
            self.read_cache.invalidate(
                [ek for ek in inode.get("extents") or []
                 if ek["file_offset"] < hi
                 and ek["file_offset"] + ek["size"] > lo])
        self.data.write(self.meta, ino, offset, data)
        return ino

    def truncate_file(self, path: str, size: int) -> None:
        ino = self.resolve(path)
        if self.read_cache is not None:
            inode = self.meta.inode_get(ino)
            self.read_cache.invalidate(
                [ek for ek in inode.get("extents") or []
                 if ek["file_offset"] + ek["size"] > size])
        self.meta.truncate(ino, size)
        self.data.close_stream(ino)
        # freed extents are reclaimed server-side via the freelist

    def read_file(self, path: str, offset: int = 0, length: int | None = None) -> bytes:
        inode = self.meta.inode_get(self.resolve(path))
        if inode["type"] == mn.DIR:
            # read(2) of a directory is EISDIR — which also exercises the
            # 499 errno= wire form (421 is a reserved transport code)
            raise FsError(mn.EISDIR, f"{path} is a directory")
        if length is None:
            length = max(0, inode["size"] - offset)
        else:
            # pread(2) semantics: reads at/past EOF return short/empty
            length = max(0, min(length, inode["size"] - offset))
        if (self.tiering is not None and not inode["extents"]
                and inode["xattr"].get("cold.location")):
            # cold tier: extents released, payload lives in the blob
            # plane — read through it (AZ-local degraded reads inside)
            return self.tiering.read_cold(inode, offset, length)
        if self.read_cache is not None:
            return self.read_cache.read(inode, offset, length)
        return self.data.read(inode, offset, length)

    def readdir(self, path: str) -> dict[str, int]:
        return self.meta.readdir(self.resolve(path))

    def stat(self, path: str) -> dict:
        parts = [p for p in path.split("/") if p]
        if not parts:
            return self.meta.inode_get(mn.ROOT_INO)
        _, inode = self.meta.walk(mn.ROOT_INO, parts, stat=True)
        return inode

    def unlink(self, path: str) -> None:
        parent, name = self._parent_of(path)
        if self.read_cache is not None:
            try:
                inode = self.meta.inode_get(self.meta.lookup(parent, name))
                self.read_cache.invalidate(inode.get("extents") or [])
            except FsError:
                pass  # racing unlink: nothing left to invalidate
        try:
            # compound: dentry + inode in one commit (mknod placement
            # puts them in the same partition); errno 18 = foreign inode
            ino = self.meta.unlink2(parent, name)
            self.data.close_stream(ino)
            return
        except FsError as e:
            if e.errno != 18:
                raise
        ino = self.meta.lookup(parent, name)
        inode = self.meta.inode_get(ino)
        if inode["type"] == mn.DIR and self.meta.dentry_count(ino) > 0:
            raise FsError(mn.ENOTEMPTY, f"{path} not empty")
        self.meta.dentry_delete(parent, name)
        # dec_nlink removes the inode only on the LAST link, moving its
        # extents onto the partition's replicated freelist; the
        # metanode's background scan deletes them from the datanodes —
        # a client crash ANYWHERE in this sequence leaks at most an
        # orphan inode, which fsck reclaims (never raw extents)
        if self.meta.dec_nlink(ino):
            self.data.close_stream(ino)

    def link(self, existing: str, new: str) -> int:
        """Hardlink (link(2)): a second dentry to the same inode.
        Directories are EPERM, per POSIX."""
        ino = self.resolve(existing)
        parent, name = self._parent_of(new)
        return self.link_at(ino, parent, name)["ino"]

    def link_at(self, ino: int, new_parent: int, name: str) -> dict:
        """Inode-based link for the FUSE opcode handler; returns the
        post-link inode dict. Bumps nlink FIRST, then installs the
        dentry — a crash in between leaks an overcounted nlink (fsck's
        reachability pass reclaims it), never a dentry pointing at a
        removable inode."""
        inode = self.meta.inode_get(ino)
        if inode["type"] == mn.DIR:
            raise FsError(mn.EPERM,
                          "hardlinks to directories are not allowed")
        inode["nlink"] = self.meta.inc_nlink(ino)
        try:
            self.meta.dentry_create(new_parent, name, ino)
        except FsError:
            # DEFINITE semantic rejection (e.g. EEXIST): safe to
            # compensate. A transport-level RpcError is AMBIGUOUS — the
            # dentry may have committed — so the overcount is left for
            # fsck; compensating there could free a still-linked inode.
            try:
                self.meta.dec_nlink(ino)
            except (FsError, rpc.RpcError):
                pass  # overcount leak at worst; fsck reclaims
            raise
        return inode

    def rename(self, old: str, new: str) -> None:
        old_parent, old_name = self._parent_of(old)
        new_parent, new_name = self._parent_of(new)
        self.rename_at(old_parent, old_name, new_parent, new_name)

    def rename_at(self, old_parent: int, old_name: str,
                  new_parent: int, new_name: str,
                  noreplace: bool = False) -> None:
        """POSIX rename: atomic, replacing an existing target (file over
        file, dir over empty dir). Same-partition renames are ONE fsm
        apply; cross-partition renames run the two-phase transaction —
        either way no crash point leaves the file linked twice or lost.
        Inode-based so the FUSE opcode handler can call it directly."""
        ino = self.meta.lookup(old_parent, old_name)
        try:
            victim_ino = self.meta.lookup(new_parent, new_name)
        except FsError:
            victim_ino = None
        if noreplace and victim_ino is not None:
            raise FsError(mn.EEXIST, f"{new_name!r} exists (NOREPLACE)")
        if victim_ino == ino:
            return  # same file: POSIX says do nothing
        src = self.meta.inode_get(ino)
        victim_is_dir = False
        if victim_ino is not None:
            vic = self.meta.inode_get(victim_ino)
            victim_is_dir = vic["type"] == mn.DIR
            if victim_is_dir:
                if src["type"] != mn.DIR:
                    raise FsError(mn.EISDIR, f"{new_name!r} is a directory")
                if self.meta.dentry_count(victim_ino) > 0:
                    raise FsError(mn.ENOTEMPTY, f"{new_name!r} not empty")
            elif src["type"] == mn.DIR:
                raise FsError(mn.ENOTDIR, f"{new_name!r} is not a directory")
        # cross-directory DIR moves serialize on the cluster-wide rename
        # mutex, then re-run the ancestry check under it: two concurrent
        # dir moves can no longer weave a detached cycle past each
        # other's checks (the kernel does the same with
        # s_vfs_rename_mutex)
        dir_move = src["type"] == mn.DIR and old_parent != new_parent
        mutex_tx, walk_deadline = None, None
        if dir_move:
            mutex_tx, lock_ts = self.meta.lock_dir_rename()
            # the mutex is a prepared tx auto-released at TX_TTL counted
            # from lock_ts (the stamp inside the tx, NOT the moment the
            # grant returned): if the ancestry walk below outlived it, a
            # concurrent dir move could acquire the "held" mutex and both
            # would proceed. The deadline is checked BEFORE each walk RPC,
            # so reserve one full RPC deadline (10s) plus slack for an
            # in-flight call straddling the check.
            walk_deadline = lock_ts + mn.MetaPartition.TX_TTL - 10.0 - 2.0
        try:
            if src["type"] == mn.DIR and self._in_subtree(
                ino, new_parent, deadline=walk_deadline
            ):
                # POSIX: renaming a dir into its own subtree is EINVAL —
                # it would detach the subtree into an unreachable cycle
                raise FsError(22, "cannot move a directory into itself")
            src_mp = self.meta._mp_for(old_parent)
            dst_mp = self.meta._mp_for(new_parent)
            # the single-apply fast path needs every touched structure on
            # ONE partition: both parent dentry maps, and (for a dir
            # victim) the victim's own children map — its emptiness is
            # re-asserted inside the apply, which only sees local state
            local_ok = src_mp["pid"] == dst_mp["pid"] and not (
                victim_is_dir
                and self.meta._mp_for(victim_ino)["pid"] != src_mp["pid"]
            )
            if local_ok:
                victim = self.meta.rename_local(
                    old_parent, old_name, new_parent, new_name, ino,
                    victim=victim_ino, noreplace=noreplace)
            else:
                victim = self.meta.rename_tx(
                    old_parent, old_name, new_parent, new_name, ino,
                    victim=victim_ino, victim_is_dir=victim_is_dir,
                    noreplace=noreplace)
        finally:
            if mutex_tx is not None:
                try:
                    self.meta.unlock_dir_rename(mutex_tx)
                except (FsError, rpc.RpcError):
                    pass  # TX_TTL expiry releases a stranded lock
        if victim is not None:
            # replaced target: drop ONE link (post-commit cleanup; a
            # crash here leaves an unreferenced inode for fsck, never a
            # dangling dentry). Other hardlinks keep the inode alive;
            # the last link's extents ride the server-side freelist.
            if self.meta.dec_nlink(victim):
                self.data.close_stream(victim)

    def _in_subtree(
        self, root_ino: int, target_ino: int, deadline: float | None = None
    ) -> bool:
        """True if target_ino is root_ino or lives anywhere under it
        (walks DOWN from root — inodes carry no parent pointers).

        `deadline`: abort with EBUSY past it — callers holding the
        TTL-bounded dir-rename mutex must not let the walk outlive the
        lock (the cycle-weave protection would silently vanish)."""
        if root_ino == target_ino:
            return True
        def check():
            # called before EVERY walk RPC (readdir and per-child
            # inode_get), so the worst overshoot past the deadline is the
            # single in-flight call the caller's margin reserves for
            if deadline is not None and time.time() > deadline:
                raise FsError(
                    mn.EBUSY,
                    "directory tree too large to safely check under the "
                    "rename mutex; retry",
                )

        queue = [root_ino]
        seen = {root_ino}
        while queue:
            cur = queue.pop()
            check()
            try:
                entries = self.meta.readdir(cur)
            except FsError:
                continue
            for child in entries.values():
                if child == target_ino:
                    return True
                if child not in seen:
                    seen.add(child)
                    check()
                    try:
                        if self.meta.inode_get(child)["type"] == mn.DIR:
                            queue.append(child)
                    except FsError:
                        pass
        return False

    def setxattr(self, path: str, key: str, value: str) -> None:
        self.meta.set_xattr(self.resolve(path), key, value)

    def getxattr(self, path: str, key: str):
        return self.meta.inode_get(self.resolve(path))["xattr"].get(key)
