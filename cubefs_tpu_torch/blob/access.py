"""Access: the stateless put/get/delete gateway of the EC plane.

Role parity: blobstore/access/stream (Put: codemode select → volume
alloc → split → EC encode → quorum write, stream_put.go:44-169; Get:
n-of-N+M read with degraded-path reconstruction, stream_get.go:115,461).

Device-first redesign of the hot path: a PUT's blobs are encoded as ONE
batched stripe stack (B, total, S) on the device — the reference
pipelines blob-by-blob through an AVX2 encoder (bounded concurrency 4,
stream_put.go:106); here batching IS the throughput story, and the
device sees large contiguous arrays.

The port's copy of ``cubefs_tpu/blob/access.py``. ``AccessConfig``
takes a ``device`` beside the engine name: None is the current CUDA
device (the handler raises without one), ``"cpu"`` the plain versions.
An engine name of None is the reference's default,
``CUBEFS_TPU_EC_ENGINE`` or the card (``cuda``).
Encoders come from ``codecio``: under ``cuda`` a PUT's (B, total, S)
stack and each degraded stripe cross to the card in one copy each way.
"""

from __future__ import annotations

import contextvars
import os
import time
import uuid
import zlib
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import dataclass, field

import numpy as np

from .. import device as devlib
from ..codec import codemode as cm
from ..utils import lockwitness, metrics, qos, rpc
from ..utils import trace as tracelib
from . import codecio
from .types import Location, Slice, VolumeInfo


class PutQuorumError(Exception):
    pass


class GetError(Exception):
    pass


DEFAULT_POLICIES = [
    cm.Policy("EC3P3", min_size=0, max_size=256 << 10),
    cm.Policy("EC6P6", min_size=(256 << 10) + 1, max_size=4 << 20),
    cm.Policy("EC12P4", min_size=(4 << 20) + 1, max_size=1 << 62),
]


@dataclass
class AccessConfig:
    blob_size: int = 8 << 20  # max payload bytes per blob
    # 'auto' = measured size-class crossover (codec/engine.py): small
    # user PUTs ride the native CPU engine, large ones the device
    engine: str | None = "auto"
    # the card of the codec (None: the current CUDA device; "cpu": the
    # plain versions)
    device: str | None = None
    policies: list = field(default_factory=lambda: list(DEFAULT_POLICIES))
    max_workers: int = 16
    put_quorum_override: int | None = None  # tests
    # failure-domain locality: with an AZ label, degraded LRC reads try
    # this AZ's local stripe first (blob/topology.py contract)
    client_az: str | None = None
    # admission gate for the put/get/delete front doors; None = the
    # process-wide qos.DEFAULT (drills inject a FakeClock gate)
    qos_gate: object | None = None


class AccessHandler:
    """One handler per process; thread-safe."""

    def __init__(self, cm_client: rpc.Client, node_clients: "NodePool",
                 cfg: AccessConfig | None = None, repair_queue=None,
                 delete_queue=None, proxy_client: rpc.Client | None = None):
        self.cm = cm_client
        self.nodes = node_clients
        self.cfg = cfg or AccessConfig()
        self.device = devlib.resolve(self.cfg.device)
        self.qos = self.cfg.qos_gate or qos.DEFAULT
        self.proxy = proxy_client  # allocation cache (blob/proxy.py)
        self.repair_queue = repair_queue
        self.delete_queue = delete_queue
        self._pool = ThreadPoolExecutor(max_workers=self.cfg.max_workers)
        self._encoders: dict[int, object] = {}
        self._lock = lockwitness.make_lock("AccessHandler._lock")
        # phase timestamps of the most recent put() on this handler
        # (encode_admitted / alloc_done / encode_done / quorum_done),
        # observable by tests asserting the encode overlaps allocation
        self.last_put_timeline: dict = {}

    def _submit(self, fn, *args):
        # carry the request's trace context into pool workers, else the
        # shard RPCs lose their X-Trace linkage
        ctx = contextvars.copy_context()
        return self._pool.submit(ctx.run, fn, *args)

    def _map(self, fn, items):
        return [f.result() for f in [self._submit(fn, i) for i in items]]

    def _encoder(self, mode: int):
        with self._lock:
            if mode not in self._encoders:
                self._encoders[mode] = codecio.encoder(
                    mode, self.device, self.cfg.engine)
            return self._encoders[mode]

    # ------------------------------ PUT ------------------------------
    def put(self, data: bytes, codemode: int | None = None, *,
            tenant: str | None = None,
            priority: int | None = None) -> Location:
        with self.qos.admit("blob.put", tenant=tenant, cost=len(data),
                            priority=priority, svc="access"):
            with tracelib.path_span("blob.put", "access.put") as sp:
                sp.set_tag("svc", "access").set_tag("bytes", len(data))
                return self._put(data, codemode)

    def _put(self, data: bytes, codemode: int | None = None) -> Location:
        if not data:
            raise ValueError("empty payload")
        mode = int(codemode if codemode is not None
                   else cm.select_codemode(self.cfg.policies, len(data)))
        enc = self._encoder(mode)
        t = enc.t

        blob_size = self.cfg.blob_size
        blobs = [data[i : i + blob_size] for i in range(0, len(data), blob_size)]

        # ---- async encode admission, then allocation ----
        # Admit the parity encode FIRST: the batched device step (which
        # also coalesces with concurrent PUTs/repairs of the same
        # geometry, codec/batcher.py) runs while this request does its
        # allocation round-trips, instead of starting after them.
        shard_size = enc.shard_size(len(blobs[0]))
        stripes = np.zeros((len(blobs), t.total, shard_size), dtype=np.uint8)
        for i, blob in enumerate(blobs):
            buf = np.frombuffer(blob, dtype=np.uint8)
            stripes[i].reshape(-1)[: buf.size] = buf
        timeline = {"encode_admitted": time.monotonic()}
        pending = enc.encode_async(stripes)

        with tracelib.stage("bid_alloc"):
            if self.proxy is not None:  # alloc cache: no per-put cm trip
                meta, _ = self.proxy.call("alloc", {"codemode": mode,
                                                    "count": len(blobs)})
                vol = VolumeInfo.from_dict(meta["volume"])
                min_bid = meta["min_bid"]
            else:
                meta, _ = self.cm.call(
                    "alloc_volume", {"codemode": mode,
                                     "op_id": uuid.uuid4().hex})
                vol = VolumeInfo.from_dict(meta["volume"])
                meta, _ = self.cm.call(
                    "alloc_bids", {"count": len(blobs),
                                   "op_id": uuid.uuid4().hex})
                min_bid = meta["start"]
        timeline["alloc_done"] = time.monotonic()
        timeline["encode_resolved_before_wait"] = pending.resolved
        # the stage is the RESIDUAL admission wait left on the critical
        # path after overlapping allocation; admitted->done wall time
        # rides as a tag on the stage span
        with tracelib.stage("encode_admission") as st:
            pending.wait()
            timeline["encode_done"] = time.monotonic()
            if getattr(st, "span", None) is not None:
                st.span.set_tag(
                    "encode_total_ms",
                    round((timeline["encode_done"]
                           - timeline["encode_admitted"]) * 1000, 3))

        # ---- quorum writes ----
        quorum = self.cfg.put_quorum_override or t.put_quorum
        with tracelib.stage("quorum_write"):
            futures = []
            for i in range(len(blobs)):
                bid = min_bid + i
                for u in vol.units:
                    futures.append(
                        self._submit(self._write_shard, vol, u, bid,
                                     stripes[i, u.index])
                    )
            fails: list[tuple[int, int]] = []  # (bid, unit index)
            ok_per_bid = {min_bid + i: 0 for i in range(len(blobs))}
            for f in futures:
                bid, idx, err = f.result()
                if err is None:
                    ok_per_bid[bid] += 1
                else:
                    fails.append((bid, idx))
        timeline["quorum_done"] = time.monotonic()
        self.last_put_timeline = timeline
        for bid, n_ok in ok_per_bid.items():
            if n_ok < quorum:
                if self.proxy is not None:
                    # don't re-lease a volume that just failed quorum
                    try:
                        self.proxy.call("invalidate", {"codemode": mode})
                    except rpc.RpcError:
                        pass
                raise PutQuorumError(
                    f"bid {bid}: {n_ok}/{len(vol.units)} shards < quorum {quorum}"
                )
        for bid, idx in fails:
            if self.repair_queue is not None:
                self.repair_queue.put(
                    {"type": "shard_repair", "vid": vol.vid, "bid": bid, "bad_index": idx}
                )

        return Location(
            cluster_id=1,
            codemode=mode,
            size=len(data),
            slices=[Slice(min_bid=min_bid, vid=vol.vid, count=len(blobs),
                          blob_size=blob_size)],
            crc=zlib.crc32(data),
        )

    def _write_shard(self, vol: VolumeInfo, unit, bid: int, shard: np.ndarray):
        addr = unit.node_addr
        # the pool's per-address breaker: a node that keeps timing out is
        # reported down immediately instead of stalling the quorum wait
        if not self.nodes.breaker.allow(addr):
            return bid, unit.index, rpc.ServiceUnavailable(
                503, f"{addr}: circuit open")
        try:
            self.nodes.get(addr).call(
                "put_shard",
                {"disk_id": unit.disk_id, "chunk_id": unit.chunk_id, "bid": bid},
                shard.tobytes(),
                timeout=10.0,
            )
            self.nodes.breaker.record_success(addr)
            return bid, unit.index, None
        except Exception as e:
            if isinstance(e, rpc.ServiceUnavailable):
                self.nodes.breaker.record_failure(addr)
            return bid, unit.index, e

    # ------------------------------ GET ------------------------------
    def get(self, loc: Location, *, tenant: str | None = None,
            priority: int | None = None) -> bytes:
        with self.qos.admit("blob.get", tenant=tenant, cost=loc.size,
                            priority=priority, svc="access"):
            with tracelib.path_span("blob.get", "access.get") as sp:
                sp.set_tag("svc", "access").set_tag("bytes", loc.size)
                return self._get(loc)

    def _get(self, loc: Location) -> bytes:
        enc = self._encoder(loc.codemode)
        t = enc.t
        out = bytearray()
        remaining = loc.size
        for sl in loc.slices:
            vol = VolumeInfo.from_dict(
                self.cm.call("get_volume", {"vid": sl.vid})[0]["volume"]
            )
            for k in range(sl.count):
                payload_len = min(sl.blob_size, remaining)
                out += self._get_blob(enc, vol, sl.min_bid + k, payload_len)
                remaining -= payload_len
        data = bytes(out)
        if loc.crc and zlib.crc32(data) != loc.crc:
            raise GetError("payload crc mismatch after reassembly")
        return data

    def _read_shard(self, vol: VolumeInfo, idx: int, bid: int):
        u = vol.units[idx]
        if not self.nodes.breaker.allow(u.node_addr):
            return idx, None, rpc.ServiceUnavailable(
                503, f"{u.node_addr}: circuit open")
        try:
            _, payload = self.nodes.get(u.node_addr).call(
                "get_shard",
                {"disk_id": u.disk_id, "chunk_id": u.chunk_id, "bid": bid},
                timeout=10.0,
            )
            self.nodes.breaker.record_success(u.node_addr)
            return idx, payload, None
        except Exception as e:
            if isinstance(e, rpc.ServiceUnavailable):
                self.nodes.breaker.record_failure(u.node_addr)
            return idx, None, e

    HEDGE_DELAY = 0.05  # backup-request trigger (stream_get.go hedging)

    def _get_blob(self, enc, vol: VolumeInfo, bid: int, payload_len: int) -> bytes:
        t = enc.t
        shard_size = enc.shard_size(
            payload_len if payload_len > 0 else 1
        )
        # fast path: read the N data shards; if any straggle past the
        # hedge delay, fire backup requests at parity shards and take the
        # first n results (the reference's n-of-N+x hedged GET)
        with tracelib.stage("read"):
            pending_map = {self._submit(self._read_shard, vol, i, bid): i
                           for i in range(t.n)}
            _, pending = wait(pending_map, timeout=self.HEDGE_DELAY)
            # hedge only for reads that STARTED and stalled; queued-not-
            # started futures mean the pool is saturated — extra reads
            # would amplify load exactly when overloaded
            stalled = sum(1 for f in pending if f.running())
            for i in range(t.n, t.n + min(t.m, stalled)):
                pending_map[self._submit(self._read_shard, vol, i, bid)] = i
            # first n distinct shards win (any mix of data/parity
            # decodes); on the happy path the straggler is abandoned
            # in-flight
            got: dict[int, bytes] = {}
            errs: dict[int, object] = {}
            remaining = set(pending_map)
            while remaining and len(got) < t.n:
                done, remaining = wait(remaining, return_when=FIRST_COMPLETED)
                for f in done:
                    i, p, err = f.result()
                    if err is None:
                        got[i] = p
                    else:
                        errs[i] = err
        if all(i in got for i in range(t.n)):  # got may also hold hedged parity
            data = b"".join(got[i] for i in range(t.n))
            return data[:payload_len]

        # degraded read. If the hedge already yielded n shards (mixed
        # data+parity), decode straight away — draining the straggler
        # would forfeit the hedge's latency win. Only when short of n do
        # we drain in-flight reads (no duplicate RPCs) and fetch extras.
        if len(got) < t.n:
            for f in remaining:
                i, p, err = f.result()
                if err is None:
                    got[i] = p
                else:
                    errs[i] = err
            # LRC: before widening to the global stripe, try repairing
            # each missing data shard inside its local stripe — reads
            # stay within one AZ (the client's first, when labeled)
            if t.l and any(i not in got for i in range(t.n)):
                with tracelib.stage("local_reconstruct"):
                    self._local_reconstruct(enc, vol, bid, got, errs)
                if all(i in got for i in range(t.n)):
                    self._file_repairs(vol, bid, got, errs, t.n)
                    self._read_repair(
                        vol, bid, {i: got[i] for i in errs if i in got},
                        errs)
                    metrics.reconstruct_reads.inc(path="local")
                    data = b"".join(got[i] for i in range(t.n))
                    return data[:payload_len]
            extra_idx = [i for i in range(t.n, t.n + t.m)
                         if i not in got and i not in errs]
            for i, p, err in self._map(
                lambda i: self._read_shard(vol, i, bid), extra_idx
            ):
                if err is None:
                    got[i] = p
        with tracelib.stage("global_reconstruct"):
            missing = [i for i in range(t.n) if i not in got]
            present = sorted(i for i in got if i < t.n + t.m)
            if len(present) < t.n:
                raise GetError(
                    f"bid {bid}: only {len(present)} of {t.n} shards readable"
                )
            self._file_repairs(vol, bid, got, errs, t.n)
            metrics.reconstruct_reads.inc(path="global")
            shard_size = len(next(iter(got.values())))
            stripe = np.zeros((t.n + t.m, shard_size), dtype=np.uint8)
            for i in present:
                if i < t.n + t.m:
                    stripe[i] = np.frombuffer(got[i], dtype=np.uint8)
            # EVERY unread row is bad — including parity we never
            # fetched; marking only the missing data rows would let
            # zero-filled parity rows join the solving set and silently
            # corrupt the decode
            all_bad = [i for i in range(t.n + t.m) if i not in got]
            enc.reconstruct_data(stripe, all_bad)
        self._read_repair(
            vol, bid,
            {i: stripe[i].tobytes() for i in all_bad if i in errs and i < t.n},
            errs)
        data = np.ascontiguousarray(stripe[: t.n]).reshape(-1)[:payload_len]
        return data.tobytes()

    def _read_repair(self, vol: VolumeInfo, bid: int,
                     repaired: dict[int, bytes], errs: dict) -> None:
        """Transparent blob-plane read-repair: a shard whose read came
        back 409 (at-rest CRC mismatch) and that EC-reconstruction just
        recovered is rewritten in place, synchronously and best-effort
        — the caller already has good bytes, so a failed rewrite only
        counts a metric and the queued shard_repair still covers it.
        Only CRC refusals qualify: an absent or unreachable shard is a
        repair-queue problem, rewriting it here would race the repairer.
        Door: CUBEFS_VERIFY_READS=0 skips the rewrite (detection still
        409s; FSM-digest-identical because no FSM records are
        written)."""
        if os.environ.get("CUBEFS_VERIFY_READS", "1") == "0":
            return
        for i, data in sorted(repaired.items()):
            if getattr(errs.get(i), "code", None) != 409:
                continue
            u = vol.units[i]
            with tracelib.path_span("blob.get",
                                    "integrity.read_repair") as sp:
                sp.set_tag("vid", vol.vid).set_tag("bid", bid)
                sp.set_tag("index", i)
                try:
                    self.nodes.get(u.node_addr).call(
                        "put_shard",
                        {"disk_id": u.disk_id, "chunk_id": u.chunk_id,
                         "bid": bid, "heal_source": "read"},
                        data, timeout=10.0)
                except (rpc.RpcError, OSError):
                    metrics.integrity_repair_failures.inc(plane="blob")

    def _file_repairs(self, vol: VolumeInfo, bid: int, got: dict,
                      errs: dict, n: int) -> None:
        """Queue repair for data shards whose reads actually FAILED — a
        merely slow healthy shard must not trigger data movement."""
        if self.repair_queue is None:
            return
        for i in range(n):
            if i not in got and i in errs:
                self.repair_queue.put(
                    {"type": "shard_repair", "vid": vol.vid, "bid": bid,
                     "bad_index": i}
                )

    def _local_reconstruct(self, enc, vol: VolumeInfo, bid: int,
                           got: dict, errs: dict) -> None:
        """AZ-local degraded read: repair missing data shards inside
        their LRC local stripes (tentpole consumer 3). Each stripe is
        one AZ's shards + local parity, so the extra reads never leave
        that AZ; stripes in the client's AZ (cfg.client_az vs the
        units' placement labels) go first. Mutates got in place; any
        stripe it cannot solve is left for the global fallback."""
        t = enc.t
        groups: dict[tuple, tuple[int, int]] = {}  # indices -> (ln, lm)
        for i in range(t.n):
            if i in got:
                continue
            indices, ln, lm = t.local_stripe(i)
            if not indices:
                return
            groups[tuple(indices)] = (ln, lm)

        def az_rank(indices: tuple) -> int:
            if not self.cfg.client_az:
                return 0
            azs = {vol.units[j].az for j in indices if j < len(vol.units)}
            return 0 if self.cfg.client_az in azs else 1

        for indices in sorted(groups, key=lambda ix: (az_rank(ix), ix)):
            ln, lm = groups[indices]
            fetch = [j for j in indices if j not in got and j not in errs]
            for j, p, err in self._map(
                lambda j: self._read_shard(vol, j, bid), fetch
            ):
                if err is None:
                    got[j] = p
                else:
                    errs[j] = err
            sub_bad = [pos for pos, j in enumerate(indices) if j not in got]
            if not sub_bad or len(sub_bad) > lm or not got:
                continue  # unsolvable locally -> global stripe's problem
            size = len(next(iter(got.values())))
            local = np.zeros((ln + lm, size), dtype=np.uint8)
            for pos, j in enumerate(indices):
                if j in got:
                    local[pos] = np.frombuffer(got[j], dtype=np.uint8)
            try:
                # bare local stripe: LrcEncoder solves (ln+lm) intra-AZ
                enc.reconstruct(local, sub_bad)
            except Exception:
                continue
            for pos, j in enumerate(indices):
                if j not in got:  # solved rows (incl. parity) all count
                    got[j] = local[pos].tobytes()

    # ----------------------------- DELETE -----------------------------
    def delete(self, loc: Location, *, tenant: str | None = None,
               priority: int | None = None) -> None:
        """Mark-delete: enqueue async deletion (proxy/mq analog); the
        consumer (scheduler blob_deleter) performs the actual unlink."""
        with self.qos.admit("blob.delete", tenant=tenant,
                            priority=priority, svc="access"):
            if self.delete_queue is None:
                self._delete_now(loc)
                return
            for sl in loc.slices:
                self.delete_queue.put(
                    {"type": "blob_delete", "vid": sl.vid,
                     "min_bid": sl.min_bid, "count": sl.count}
                )

    def _delete_now(self, loc: Location) -> None:
        for sl in loc.slices:
            vol = VolumeInfo.from_dict(
                self.cm.call("get_volume", {"vid": sl.vid})[0]["volume"]
            )
            for k in range(sl.count):
                bid = sl.min_bid + k
                for u in vol.units:
                    try:
                        self.nodes.get(u.node_addr).call(
                            "delete_shard",
                            {"disk_id": u.disk_id, "chunk_id": u.chunk_id, "bid": bid},
                        )
                    except rpc.RpcError:
                        pass  # already gone / node down -> scrubber's job

    # ---------------- RPC surface ----------------
    def rpc_put(self, args, body):
        loc = self.put(body, args.get("codemode"),
                       tenant=args.get("tenant"))
        return {"location": loc.to_dict()}

    def rpc_get(self, args, body):
        return {}, self.get(Location.from_dict(args["location"]),
                            tenant=args.get("tenant"))

    def rpc_delete(self, args, body):
        self.delete(Location.from_dict(args["location"]),
                    tenant=args.get("tenant"))
        return {}


NodePool = rpc.NodePool  # canonical home: utils/rpc.py
