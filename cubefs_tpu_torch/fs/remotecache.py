"""RemoteCache: distributed read-acceleration cache.

Role parity: remotecache/ — flashnode (cache engine serving hot extent
blocks, cachengine/engine.go:42) + flashgroupmanager (slot-routed flash
groups, flashgroupmanager/cluster.go) + the client read hook
(sdk/data/stream/stream_remote_cache.go) with consistent-hash slot
routing (proto/distributed_cache.go).

FlashNode: LRU of (dp, extent, block) -> bytes with a capacity budget.
FlashGroupManager: slot ring mapping cache keys to flash groups.
CachedReader: ExtentClient wrapper that consults the ring before the
datanode and populates on miss.

The port's copy of ``cubefs_tpu/fs/remotecache.py``. A flashnode is
reached through ``sdk.clients.FlashClient``, as in the reference.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from collections import OrderedDict

from ..utils import lockwitness, metrics, qos, rpc, trace
from ..utils.fsm import ReplicatedFsm
from ..utils.retry import CircuitBreaker

CACHE_BLOCK = 128 << 10

cache_ops = metrics.DEFAULT.counter(
    "cubefs_flashcache_ops_total", "flash cache results", ("result",)
)


class FlashNode:
    """In-RAM LRU cache engine (tmpfs-class tier of the reference).

    Eviction is burn-rate-informed: entries carry the request family
    (`path`) that populated them, and when the budget is exceeded the
    node samples the EVICT_SAMPLE oldest entries and evicts the one
    whose path is healthiest (lowest brownout level) — a path that is
    burning SLO budget keeps its working set warm at the expense of
    paths with latency headroom. Untagged entries and an all-healthy
    gate degrade to plain LRU (oldest wins every tie), so the default
    behavior is bit-identical to the pre-change cache."""

    EVICT_SAMPLE = 8

    def __init__(self, capacity_bytes: int = 256 << 20, *, gate=None):
        self.capacity = capacity_bytes
        self._gate = gate  # None -> qos.DEFAULT, lazily
        self._lock = lockwitness.make_lock("FlashNode._lock")
        self._lru: OrderedDict[str, bytes] = OrderedDict()
        self._paths: dict[str, str] = {}  # key -> populating path
        self._used = 0

    def get(self, key: str) -> bytes | None:
        with self._lock:
            data = self._lru.get(key)
            if data is not None:
                self._lru.move_to_end(key)
            return data

    def _evict_one(self) -> None:
        cands = []
        for k in self._lru:  # OrderedDict iterates oldest-first
            cands.append(k)
            if len(cands) >= self.EVICT_SAMPLE:
                break
        victim = cands[0]
        if len(cands) > 1 and any(self._paths.get(k) for k in cands):
            if self._gate is None:
                self._gate = qos.DEFAULT
            best_lvl = None
            for k in cands:
                p = self._paths.get(k)
                lvl = self._gate.level(p) if p else 0
                if best_lvl is None or lvl < best_lvl:
                    best_lvl, victim = lvl, k
        evicted = self._lru.pop(victim)
        self._paths.pop(victim, None)
        self._used -= len(evicted)

    def put(self, key: str, data: bytes, path: str | None = None) -> None:
        with self._lock:
            old = self._lru.pop(key, None)
            if old is not None:
                self._used -= len(old)
            self._lru[key] = data
            if path is not None:
                self._paths[key] = path
            else:
                self._paths.pop(key, None)
            self._used += len(data)
            while self._used > self.capacity and self._lru:
                self._evict_one()

    def delete(self, key: str) -> bool:
        with self._lock:
            old = self._lru.pop(key, None)
            self._paths.pop(key, None)
            if old is not None:
                self._used -= len(old)
            return old is not None

    def stats(self) -> dict:
        with self._lock:
            return {"items": len(self._lru), "bytes": self._used,
                    "capacity": self.capacity}

    # ---------------- RPC surface ----------------
    def rpc_cache_get(self, args, body):
        data = self.get(args["key"])
        if data is None:
            raise rpc.RpcError(404, "cache miss")
        return {}, data

    def rpc_cache_put(self, args, body):
        self.put(args["key"], body, path=args.get("path"))
        return {}

    def rpc_cache_delete(self, args, body):
        # idempotent by construction: deleting an absent key is a no-op
        return {"deleted": self.delete(args["key"])}

    def rpc_stats(self, args, body):
        return self.stats()


class FlashGroupManager(ReplicatedFsm):
    """Flash-group control service (remotecache/flashgroupmanager/
    cluster.go analog): a raft/wal-replicated registry of flash groups
    (each group = a set of flashnode addrs owning a share of the hash
    slot ring), with flashnode heartbeats deciding member health. Group
    membership mutations flow through the ONE replicated commit door;
    the ring view carries an epoch so clients can cache and refresh."""

    SLOTS = 1024
    HEARTBEAT_TIMEOUT = 10.0

    def __init__(self, data_dir: str | None = None, me: str | None = None,
                 peers: list[str] | None = None, node_pool=None):
        self._lock = lockwitness.make_rlock("FlashGroupManager._lock")
        self.groups: dict[int, dict] = {}  # gid -> {addrs, status}
        self.epoch = 0
        self._hb: dict[str, float] = {}  # flashnode addr -> last heartbeat
        self._init_fsm("fgm", data_dir, me, peers, node_pool)

    # ---- FSM contract ----
    def _state_dict(self) -> dict:
        return {"groups": {str(g): v for g, v in self.groups.items()},
                "epoch": self.epoch}

    def _load_state_dict(self, st: dict) -> None:
        self.groups = {int(g): v for g, v in st["groups"].items()}
        self.epoch = st.get("epoch", 0)

    def _state_bytes(self) -> bytes:
        with self._lock:
            return json.dumps(self._state_dict()).encode()

    def _restore_bytes(self, data: bytes) -> None:
        with self._lock:
            self._load_state_dict(json.loads(data))

    def _apply(self, rec: dict):
        rec = dict(rec)
        op = rec.pop("op")
        with self._lock:
            self.epoch += 1
            return getattr(self, f"_apply_{op}")(**rec)

    def _apply_put_group(self, group_id: int, addrs: list[str],
                         status: str = "active",
                         az: str | None = None) -> None:
        self.groups[int(group_id)] = {"addrs": list(addrs),
                                      "status": status, "az": az}

    def _apply_remove_group(self, group_id: int) -> None:
        self.groups.pop(int(group_id), None)

    def _apply_set_status(self, group_id: int, status: str) -> None:
        g = self.groups.get(int(group_id))
        if g is not None:  # tolerate replay after a concurrent removal
            g["status"] = status

    # ---- admin / heartbeat ----
    def register_group(self, group_id: int, addrs: list[str],
                       az: str | None = None) -> None:
        self._commit({"op": "put_group", "group_id": group_id,
                      "addrs": list(addrs), "az": az})

    def remove_group(self, group_id: int) -> None:
        self._commit({"op": "remove_group", "group_id": group_id})

    def set_group_status(self, group_id: int, status: str) -> None:
        if status not in ("active", "inactive"):
            raise ValueError(f"bad status {status!r}")
        with self._lock:
            if int(group_id) not in self.groups:
                raise ValueError(f"unknown flash group {group_id}")
        self._commit({"op": "set_status", "group_id": group_id,
                      "status": status})

    def flashnode_heartbeat(self, addr: str) -> None:
        with self._lock:
            self._hb[addr] = time.time()

    def _member_alive(self, addr: str) -> bool:
        hb = self._hb.get(addr)
        # never-heartbeated members count as alive (static deployments
        # without the heartbeat loop keep working)
        return hb is None or time.time() - hb <= self.HEARTBEAT_TIMEOUT

    def ring_info(self) -> dict[int, dict]:
        """Active groups with their LIVE members only, plus AZ labels."""
        with self._lock:
            out = {}
            for g, info in self.groups.items():
                if info.get("status") != "active":
                    continue
                live = [a for a in info["addrs"] if self._member_alive(a)]
                if live:
                    out[g] = {"addrs": live, "az": info.get("az")}
            return out

    def ring(self) -> dict[int, list[str]]:
        """Active groups with their LIVE members only."""
        return {g: list(v["addrs"]) for g, v in self.ring_info().items()}

    @classmethod
    def slot_of(cls, key: str) -> int:
        return int.from_bytes(hashlib.md5(key.encode()).digest()[:4], "big") % cls.SLOTS

    def elect_group(self, key: str,
                    client_az: str | None = None) -> tuple[list[str], str]:
        """AZ-local flash-group election: slot-route over the client
        AZ's active groups first; fall back to the full ring only when
        every local group is dead. Returns (member addrs, scope) where
        scope is ``az_local`` or ``cross_az`` relative to the client
        (unlabeled groups/clients count as local — there is no locality
        information to violate)."""
        ring = self.ring_info()
        if not ring:
            return [], "az_local"
        if client_az is not None:
            local = sorted(g for g, v in ring.items()
                           if v["az"] == client_az)
            if local:
                gid = local[self.slot_of(key) % len(local)]
                return list(ring[gid]["addrs"]), "az_local"
        ids = sorted(ring)
        gid = ids[self.slot_of(key) % len(ids)]
        g_az = ring[gid]["az"]
        scope = ("az_local" if client_az is None or g_az is None
                 or g_az == client_az else "cross_az")
        return list(ring[gid]["addrs"]), scope

    def group_for(self, key: str) -> list[str]:
        return self.elect_group(key)[0]

    # ---------------- RPC surface ----------------
    def rpc_register_group(self, args, body):
        self._leader_gate()
        self.register_group(args["group_id"], args["addrs"],
                            az=args.get("az"))
        return {}

    def rpc_remove_group(self, args, body):
        self._leader_gate()
        self.remove_group(args["group_id"])
        return {}

    def rpc_set_group_status(self, args, body):
        self._leader_gate()
        self.set_group_status(args["group_id"], args["status"])
        return {}

    def rpc_flashnode_heartbeat(self, args, body):
        self.flashnode_heartbeat(args["addr"])
        return {}

    def rpc_ring(self, args, body):
        with self._lock:
            epoch = self.epoch
        info = self.ring_info()
        return {"groups": {str(k): list(v["addrs"]) for k, v in info.items()},
                "azs": {str(k): v["az"] for k, v in info.items()},
                "epoch": epoch}


class _Flight:
    """One in-flight datanode fill: followers park on the event and
    reuse the leader's bytes (singleflight)."""

    __slots__ = ("event", "data", "error")

    def __init__(self):
        self.event = threading.Event()
        self.data: bytes | None = None
        self.error: BaseException | None = None


class CachedReader:
    """Read-through wrapper for ExtentClient: flash ring first, datanode
    on miss, then populate (the client hook in stream_remote_cache.go).

    The hot-read tier layers four policies over the plain read path:

      * AZ-local election — flash groups in the client's AZ own the
        slot ring first; the full ring serves only when every local
        group is dead (``cubefs_readcache_serves_total{scope}``)
      * singleflight — concurrent misses of one block collapse onto a
        single datanode read
      * hotness admission — a block earns a flash slot only after
        ``hotness_threshold`` misses, so one streaming scan cannot
        flush the hot set
      * a per-flashnode circuit breaker — transport failures (NOT clean
        404 misses) open it, and an open breaker routes straight to the
        datanode instead of timing out against a dead cache
    """

    HEAT_TRACK = 4096  # per-block miss counters kept (LRU-bounded)
    FILL_WAIT = 30.0   # follower park bound; the leader always signals

    def __init__(self, extent_client, fgm: FlashGroupManager, node_pool,
                 *, client_az: str | None = None,
                 hotness_threshold: int = 1,
                 breaker: CircuitBreaker | None = None):
        self.inner = extent_client
        self.fgm = fgm
        self.nodes = node_pool
        self.client_az = client_az
        self.hotness_threshold = max(1, int(hotness_threshold))
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self.hits = 0
        self.misses = 0
        self._sf_lock = lockwitness.make_lock("CachedReader._sf_lock")
        self._inflight: dict[str, _Flight] = {}
        self._heat: OrderedDict[str, int] = OrderedDict()

    def _flash_client(self, addr: str):
        # NodePool.get already caches one Client per addr and stays
        # current across rebinds; FlashClient is a stateless wrapper
        from ..sdk.clients import FlashClient

        return FlashClient(self.nodes.get(addr))

    @staticmethod
    def _key(dp_id: int, extent_id: int, block: int) -> str:
        return f"{dp_id}/{extent_id}/{block}"

    # ---- lookup / fill / admission ----
    def _cache_lookup(self, key: str, length: int):
        addrs, scope = self.fgm.elect_group(key, self.client_az)
        for addr in addrs:
            if not self.breaker.allow(addr):
                continue
            try:
                data = self._flash_client(addr).cache_get(key)
            except rpc.RpcError as e:
                if e.code == 404:
                    self.breaker.record_success(addr)  # clean miss
                else:
                    self.breaker.record_failure(addr)
                continue
            self.breaker.record_success(addr)
            if len(data) >= length:  # stale short entry -> refetch
                return data, scope
        return None, scope

    def _heat_up(self, key: str) -> int:
        with self._sf_lock:
            n = self._heat.pop(key, 0) + 1
            self._heat[key] = n
            while len(self._heat) > self.HEAT_TRACK:
                self._heat.popitem(last=False)
            return n

    def _populate(self, key: str, data: bytes) -> None:
        addrs, _ = self.fgm.elect_group(key, self.client_az)
        for addr in addrs:
            if not self.breaker.allow(addr):
                continue
            try:
                self._flash_client(addr).cache_put(key, data,
                                                   path="fs.read")
            except rpc.RpcError:
                self.breaker.record_failure(addr)
                continue
            self.breaker.record_success(addr)
            metrics.readcache_fills.inc(outcome="populated")
            return
        metrics.readcache_fills.inc(outcome="failed")

    def _fill(self, key: str, dp: dict, extent_id: int, block: int,
              length: int, fetch_len: int) -> bytes:
        with self._sf_lock:
            fl = self._inflight.get(key)
            leader = fl is None
            if leader:
                fl = self._inflight[key] = _Flight()
        if not leader:
            metrics.readcache_singleflight.inc()
            fl.event.wait(self.FILL_WAIT)
            if fl.error is None and fl.data is not None \
                    and len(fl.data) >= length:
                return fl.data
            # leader failed (or fetched a shorter span): read on our own
            with trace.stage("datanode_read", path="fs.read"):
                return self.inner._read_replicated(
                    dp, extent_id, block * CACHE_BLOCK, fetch_len)
        try:
            with trace.stage("datanode_read", path="fs.read"):
                data = self.inner._read_replicated(
                    dp, extent_id, block * CACHE_BLOCK, fetch_len)
            fl.data = data
        except BaseException as e:
            fl.error = e
            raise
        finally:
            with self._sf_lock:
                self._inflight.pop(key, None)
            fl.event.set()
        # the fetch may span several cache blocks (read() coalesces a
        # run of missing blocks into ONE datanode round trip — a miss
        # must never cost more cross-AZ hops than the plain path);
        # admission is still judged per block
        off = 0
        b = block
        while off < len(data):
            piece = data[off:off + CACHE_BLOCK]
            k = key if b == block else self._key(
                dp["dp_id"], extent_id, b)
            if qos.fill_suppressed():
                # brownout: cache population is deferrable work — stop
                # copying datanode blocks into the flash tier while any
                # path burns SLO budget (reads still hit existing cache)
                metrics.readcache_fills.inc(outcome="suppressed")
            elif self._heat_up(k) >= self.hotness_threshold:
                with trace.stage("cache_fill", path="fs.read"):
                    self._populate(k, piece)
            else:
                metrics.readcache_fills.inc(outcome="skipped_cold")
            off += CACHE_BLOCK
            b += 1
        return data

    def read_block(self, dp: dict, extent_id: int, block: int,
                   length: int, fetch_len: int) -> bytes:
        """length = bytes the caller needs from block start; fetch_len =
        the block's valid span in the extent (tail blocks are short, and
        replicas reject short-read requests beyond the span)."""
        key = self._key(dp["dp_id"], extent_id, block)
        with trace.stage("cache_lookup", path="fs.read"):
            data, scope = self._cache_lookup(key, length)
        if data is not None:
            self.hits += 1
            cache_ops.inc(result="hit")
            metrics.readcache_serves.inc(scope=scope)
            return data[:length]
        self.misses += 1
        cache_ops.inc(result="miss")
        data = self._fill(key, dp, extent_id, block, length, fetch_len)
        return data[:length]

    # ---- write-path invalidation ----
    @staticmethod
    def keys_for_extents(extents: list[dict]) -> list[str]:
        keys: list[str] = []
        for ek in extents:
            if not ek["size"]:
                continue
            first = ek["ext_offset"] // CACHE_BLOCK
            last = (ek["ext_offset"] + ek["size"] - 1) // CACHE_BLOCK
            for b in range(first, last + 1):
                keys.append(f"{ek['dp_id']}/{ek['extent_id']}/{b}")
        return keys

    def invalidate(self, extents: list[dict]) -> int:
        """Evict every flash copy of the blocks covered by `extents`.
        AZ-local election means one key may be cached once PER AZ, so
        deletes broadcast to every active group (cheap: writes are rare
        on this tier and delete-of-absent is a no-op). Returns the
        number of blocks invalidated."""
        keys = self.keys_for_extents(extents)
        if not keys:
            return 0
        groups = self.fgm.ring_info()
        for key in keys:
            for g in groups.values():
                for addr in g["addrs"]:
                    if not self.breaker.allow(addr):
                        continue
                    try:
                        self._flash_client(addr).cache_delete(key)
                    except rpc.RpcError:
                        self.breaker.record_failure(addr)
        metrics.readcache_invalidations.inc(len(keys))
        return len(keys)

    def read(self, inode: dict, offset: int, length: int) -> bytes:
        """Cache-block-aligned read of one inode's bytes.

        Two phases per extent: look every covered block up in flash,
        then fetch each contiguous RUN of missing blocks from the
        datanode in ONE round trip (populating each block from the
        span). Block-granular caching must not amplify a cold read
        into per-block cross-AZ hops the plain path wouldn't pay."""
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
            dp = self.inner._dp_by_id(ek["dp_id"])
            ext_end = ek["ext_offset"] + ek["size"]  # extent's valid span
            first = ek["ext_offset"] + (lo - ek["file_offset"])
            last = ek["ext_offset"] + (hi - 1 - ek["file_offset"])
            b0, b1 = first // CACHE_BLOCK, last // CACHE_BLOCK
            blocks: dict[int, bytes] = {}
            missing: list[int] = []
            for b in range(b0, b1 + 1):
                # bytes of this block the read actually uses, measured
                # from block start (a short cached entry is a miss)
                need = min(last + 1, ext_end) - b * CACHE_BLOCK \
                    if b == b1 else min(CACHE_BLOCK,
                                        ext_end - b * CACHE_BLOCK)
                key = self._key(dp["dp_id"], ek["extent_id"], b)
                with trace.stage("cache_lookup", path="fs.read"):
                    data, scope = self._cache_lookup(key, need)
                if data is not None:
                    self.hits += 1
                    cache_ops.inc(result="hit")
                    metrics.readcache_serves.inc(scope=scope)
                    blocks[b] = data
                else:
                    self.misses += 1
                    cache_ops.inc(result="miss")
                    missing.append(b)
            i = 0
            while i < len(missing):
                j = i
                while j + 1 < len(missing) and \
                        missing[j + 1] == missing[j] + 1:
                    j += 1
                rb0, rb1 = missing[i], missing[j]
                fetch = min((rb1 + 1) * CACHE_BLOCK, ext_end) \
                    - rb0 * CACHE_BLOCK
                key = self._key(dp["dp_id"], ek["extent_id"], rb0)
                span = self._fill(key, dp, ek["extent_id"], rb0,
                                  fetch, fetch)
                for b in range(rb0, rb1 + 1):
                    o = (b - rb0) * CACHE_BLOCK
                    blocks[b] = span[o:o + CACHE_BLOCK]
                i = j + 1
            pos = lo
            while pos < hi:
                ext_pos = ek["ext_offset"] + (pos - ek["file_offset"])
                b = ext_pos // CACHE_BLOCK
                in_block = ext_pos % CACHE_BLOCK
                take = min(hi - pos, CACHE_BLOCK - in_block)
                blk = blocks[b]
                out[pos - offset:pos - offset + take] = \
                    blk[in_block:in_block + take]
                pos += take
        return bytes(out)
