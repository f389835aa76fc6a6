"""ShardNode: range-sharded KV/blob serving layer with per-shard raft.

Role parity: blobstore/shardnode — catalog spaces carved into range
shards (shardnode/catalog/catalog.go), each shard a raft group over its
replicas (storage/shard.go, shard_sm.go FSM, raft_impl.go), serving
item put/get/delete/list. Built on this framework's raft
(parallel/raft.py) with the same multi-raft transport-sharing pattern
as the metanode.

Durability (storage/shard.go + kvstorev2 parity): every shard with a
data_dir is backed by the native ordered-KV engine
(runtime/src/kvstore.cc — CRC-framed WAL + snapshot compaction), and
the node keeps an atomic shards.json manifest so a restarted process
reopens every shard, its key range, and its raft group. The raft WAL
re-applies only the committed suffix on top of the KV state; put and
delete re-application is idempotent, so the double-apply window after
a crash is harmless (the same argument the reference's applied-index
watermark makes).

Shard split (storage/shard.go range split + catalog update): the
leader proposes a `split` record carrying the deterministic split key
(the range median) and the new child id; every replica's apply moves
the upper half of the range into a new child shard and starts the
child's raft group over the same replica set. The caller then
registers the new range layout with the clustermgr catalog. The child's
items come in through the parent's log, not its own, so its group is
``seeded``: it starts with its log compacted through index 1, and a
member that joins with an empty log (a spare that replaces a replica)
gets a snapshot of the child. The parent's log may be compacted past
the split by then, and the reference, whose child log starts empty,
sends such a member no items of the child.

The port's copy of ``cubefs_tpu/blob/shardnode.py``, host-only like the
reference's: the ``shards.json`` manifest, each shard's KV directory
(``runtime/kvstore.py`` over the port's copy of ``kvstore.cc``), the
shard raft groups' directories and the ``rpc_*`` wire are the
reference's, so a node directory written by either package opens in the
other and a shard group may mix members of both.
"""

from __future__ import annotations

import json
import os

from ..parallel import raft as raftlib
from ..runtime.kvstore import KvStore
from ..utils import lockwitness, rpc


class Shard:
    """One key range [start, end) with a replicated ordered KV store.
    Backed by the native kvstore when `data_dir` is set; an in-RAM dict
    otherwise (tests / ephemeral caches)."""

    def __init__(self, shard_id: int, start: str, end: str,
                 data_dir: str | None = None):
        self.shard_id = shard_id
        self.start = start
        self.end = end
        self._lock = lockwitness.make_rlock("Shard._lock")
        self.on_split = None  # set by the hosting ShardNode
        self.on_range_change = None  # set by the hosting ShardNode
        self.seeded = False  # born of a split: its raft group starts seeded
        if data_dir:
            self._kv = KvStore(data_dir)
            self._mem = None
        else:
            self._kv = None
            self._mem: dict[str, bytes] | None = {}

    def owns(self, key: str) -> bool:
        return self.start <= key and (not self.end or key < self.end)

    # ---- store primitives (dict / native-KV dispatch) ----
    def _put(self, key: str, value: bytes) -> None:
        if self._kv is not None:
            self._kv.put(key.encode(), value)
        else:
            self._mem[key] = value

    def _delete(self, key: str) -> None:
        if self._kv is not None:
            self._kv.delete(key.encode())  # raises KeyError when absent
        else:
            if key not in self._mem:
                raise KeyError(key)
            del self._mem[key]

    def get(self, key: str) -> bytes:
        with self._lock:
            if self._kv is not None:
                return self._kv.get(key.encode())
            if key not in self._mem:
                raise KeyError(key)
            return self._mem[key]

    def list(self, prefix: str, limit: int) -> list[str]:
        with self._lock:
            if self._kv is not None:
                p = prefix.encode()
                # successor of the prefix (skip trailing 0xFF bytes,
                # which have no single-byte successor)
                q = p
                while q and q[-1] == 0xFF:
                    q = q[:-1]
                end = q[:-1] + bytes([q[-1] + 1]) if q else b""
                return [k.decode() for k, _ in
                        self._kv.scan(p, end, max_items=limit)]
            return sorted(k for k in self._mem
                          if k.startswith(prefix))[:limit]

    def items_in(self, start: str, end: str):
        """(key, value) pairs with start <= key < end, key order."""
        with self._lock:
            if self._kv is not None:
                return [(k.decode(), v) for k, v in
                        self._kv.scan(start.encode(), end.encode())]
            keys = sorted(k for k in self._mem
                          if start <= k and (not end or k < end))
            return [(k, self._mem[k]) for k in keys]

    def count(self) -> int:
        with self._lock:
            return (self._kv.count() if self._kv is not None
                    else len(self._mem))

    def median_key(self) -> str | None:
        with self._lock:
            if self._kv is not None:
                m = self._kv.median_key(self.start.encode(),
                                        self.end.encode())
                return m.decode() if m is not None else None
            keys = sorted(self._mem)
            return keys[len(keys) // 2] if len(keys) >= 2 else None

    def close(self) -> None:
        if self._kv is not None:
            self._kv.close()

    # ---- bulk move (split): one WAL sync per side, not per key ----
    def take_range(self, items: list[tuple[str, bytes]]) -> None:
        with self._lock:
            if self._kv is not None:
                self._kv.apply_batch([("put", k, v) for k, v in items])
            else:
                self._mem.update(items)

    def drop_range(self, keys: list[str]) -> None:
        with self._lock:
            if self._kv is not None:
                self._kv.apply_batch([("delete", k, None) for k in keys])
            else:
                for k in keys:
                    self._mem.pop(k, None)

    # ---- FSM apply door ----
    def apply(self, rec: dict):
        op = rec["op"]
        if op == "split":
            # runs WITHOUT this shard's lock: the node-level split takes
            # node lock -> shard lock, the same order every RPC uses —
            # holding the shard lock here would deadlock against
            # list_shards/stat (ABBA)
            return self.on_split(self, rec)
        with self._lock:
            if op == "put":
                self._put(rec["key"], bytes.fromhex(rec["value_hex"]))
                return {}
            if op == "delete":
                self._delete(rec["key"])
                return {}
            raise ValueError(f"unknown shard op {op!r}")

    # ---- raft snapshot plumbing (InstallSnapshot for lagging peers) ----
    def state_bytes(self) -> bytes:
        with self._lock:
            items = self.items_in(self.start, self.end)
            return json.dumps({
                "range": [self.start, self.end],
                "kv": {k: v.hex() for k, v in items},
            }).encode()

    def restore_state(self, data: bytes) -> None:
        with self._lock:
            state = json.loads(data)
            self.start, self.end = state["range"]
            if self._kv is not None:
                self._kv.clear()
            else:
                self._mem.clear()
            items = [(k, bytes.fromhex(v)) for k, v in state["kv"].items()]
            if self._kv is not None:
                self._kv.apply_batch([("put", k, v) for k, v in items])
            else:
                self._mem.update(items)
        # a snapshot can carry a post-split (narrowed) range: persist it
        # in the node manifest, or a restart resurrects the stale range.
        # Called OUTSIDE the shard lock (the hook takes the node lock;
        # nested the other way it would ABBA against split apply).
        if self.on_range_change is not None:
            self.on_range_change()


class ShardNode:
    """Hosts shards; replicated when peers are configured (multi-raft).
    With a data_dir, the shard set survives restart via shards.json and
    each shard's contents via the native KV engine."""

    REDIRECT = 421

    def __init__(self, node_id: int, addr: str | None = None, node_pool=None,
                 data_dir: str | None = None):
        self.node_id = node_id
        self.addr = addr
        self.pool = node_pool
        self.data_dir = data_dir
        self.shards: dict[int, Shard] = {}
        self.rafts: dict[int, raftlib.RaftNode] = {}
        self.extra_routes: dict = {}
        self._peers: dict[int, list[str]] = {}
        self._lock = lockwitness.make_rlock("ShardNode._lock")
        self._peer_change = lockwitness.make_lock("ShardNode._peer_change")
        if data_dir:
            os.makedirs(data_dir, exist_ok=True)
            self._load_manifest()

    # ---- manifest: the node's durable shard inventory ----
    def _manifest_path(self) -> str:
        return os.path.join(self.data_dir, "shards.json")

    def _save_manifest(self) -> None:
        if not self.data_dir:
            return
        with self._lock:  # RLock: also called with the lock already held
            tmp = self._manifest_path() + ".tmp"
            recs = [{"shard_id": sid, "start": sh.start, "end": sh.end,
                     "peers": self._peers.get(sid)}
                    for sid, sh in self.shards.items()]
            with open(tmp, "w") as f:
                json.dump(recs, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._manifest_path())

    def _load_manifest(self) -> None:
        if not os.path.exists(self._manifest_path()):
            return
        for rec in json.load(open(self._manifest_path())):
            self._open_shard(rec["shard_id"], rec["start"], rec["end"],
                             rec.get("peers"))

    # ---- shard lifecycle ----
    def _open_shard(self, shard_id: int, start: str, end: str,
                    peers: list[str] | None, seeded: bool = False) -> Shard:
        kv_dir = (os.path.join(self.data_dir, f"kv_{shard_id}")
                  if self.data_dir else None)
        sh = Shard(shard_id, start, end, data_dir=kv_dir)
        sh.seeded = seeded
        sh.on_split = self._apply_split
        sh.on_range_change = self._save_manifest
        self.shards[shard_id] = sh
        self._peers[shard_id] = list(peers) if peers else None
        # only a MEMBER may run the group's raft: a node migrated away
        # from a shard keeps its (stale) data but must not campaign
        # against the real group after a restart
        if peers and len(peers) > 1 and self.addr in peers:
            node = raftlib.RaftNode(
                f"sn{shard_id}", self.addr, peers, sh.apply, self.pool,
                data_dir=os.path.join(self.data_dir, f"sn_{shard_id}")
                if self.data_dir else None,
                snapshot_fn=sh.state_bytes,
                restore_fn=sh.restore_state,
                seeded=sh.seeded,
            )
            raftlib.register_routes(self.extra_routes, node)
            self.rafts[shard_id] = node.start()
        return sh

    def create_shard(self, shard_id: int, start: str, end: str,
                     peers: list[str] | None = None) -> Shard:
        with self._lock:
            if shard_id not in self.shards:
                self._open_shard(shard_id, start, end, peers)
                self._save_manifest()
            return self.shards[shard_id]

    def _shard(self, shard_id: int, need_leader: bool = False) -> Shard:
        sh = self.shards.get(shard_id)
        if sh is None:
            raise rpc.RpcError(404, f"shard {shard_id} not on node {self.node_id}")
        node = self.rafts.get(shard_id)
        if need_leader and node is not None:
            st = node.status()
            if st["role"] != "leader":
                raise rpc.RpcError(self.REDIRECT, f"leader={st['leader'] or ''}")
        return sh

    def _mutate(self, shard_id: int, rec: dict):
        sh = self._shard(shard_id, need_leader=True)
        node = self.rafts.get(shard_id)
        try:
            if node is None:
                return sh.apply(rec)
            try:
                return node.propose(rec)
            except raftlib.NotLeaderError as e:
                raise rpc.RpcError(self.REDIRECT, f"leader={e.leader or ''}") from None
        except KeyError as e:
            raise rpc.RpcError(404, f"no such key {e}") from None

    # ---- split (deterministic FSM op applied on every replica) ----
    def split_shard(self, shard_id: int, child_id: int) -> dict:
        """Leader-side entry: compute the median split key, propose the
        split through the shard's raft group. Returns {child_id,
        split_key} for the caller to register with the catalog."""
        sh = self._shard(shard_id, need_leader=True)
        split_key = sh.median_key()
        if split_key is None or not sh.owns(split_key) \
                or split_key == sh.start:
            raise rpc.RpcError(400, f"shard {shard_id} too small to split")
        if child_id in self.shards:
            raise rpc.RpcError(409, f"shard {child_id} already exists")
        rec = {"op": "split", "child_id": child_id,
               "split_key": split_key,
               "peers": self._peers.get(shard_id)}
        return self._mutate(shard_id, rec)

    def _apply_split(self, parent: Shard, rec: dict) -> dict:
        """Runs inside apply on EVERY replica: carve [split_key, end)
        out of the parent into a fresh child shard (its own raft group
        over the same peer set), shrink the parent's range. Lock order
        is node -> shard, matching every RPC path."""
        with self._lock:
            child_id, split_key = rec["child_id"], rec["split_key"]
            if child_id in self.shards:
                # WAL replay after restart: the child exists from the
                # manifest, but replayed pre-split puts may have
                # re-inserted upper-half keys into the parent's durable
                # KV — reconcile instead of returning early, or those
                # ghosts survive forever out of range
                child = self.shards[child_id]
            else:
                if not parent.owns(split_key) or split_key == parent.start:
                    # a stale retry after an earlier split already
                    # narrowed the parent: applying it would create
                    # overlapping ranges (deterministic rejection on
                    # every replica)
                    raise ValueError(
                        f"split key {split_key!r} outside parent range "
                        f"[{parent.start!r}, {parent.end!r})")
                child = self._open_shard(child_id, split_key, parent.end,
                                         rec.get("peers"), seeded=True)
            # anything the parent still holds at/above the split key
            # belongs to the child or its descendants (re-put is
            # idempotent on replay). Unbounded upper: the child's end
            # may already be narrowed by a LATER split in the manifest,
            # and that split's own replay cascades the uppers onward.
            moved = parent.items_in(split_key, "")
            if moved:
                child.take_range(moved)
                parent.drop_range([k for k, _ in moved])
            parent.end = split_key
            self._save_manifest()
            return {"child_id": child_id, "split_key": split_key}

    def update_shard_peers(self, shard_id: int, peers: list[str]) -> None:
        """Replica-set change for one shard (shard repair/migrate):
        restart the shard's raft group over the new peer list, keeping
        its durable KV and raft WAL. Single-replica-swap changes keep
        quorum overlap between old and new configurations, the same
        argument as raft single-server membership change.

        The old group stops outside the node lock: its apply may be a
        split, which takes the node lock under the group's raft lock, so
        stopping it (the raft lock) under the node lock is the reverse
        order. ``_peer_change`` keeps changes one at a time instead."""
        with self._peer_change:
            with self._lock:
                sh = self.shards.get(shard_id)
                if sh is None:
                    raise rpc.RpcError(404, f"shard {shard_id} not on node "
                                            f"{self.node_id}")
                old = self.rafts.pop(shard_id, None)
            if old is not None:
                old.stop()
            with self._lock:
                self._peers[shard_id] = list(peers)
                self._save_manifest()
                if peers and len(peers) > 1 and self.addr in peers:
                    node = raftlib.RaftNode(
                        f"sn{shard_id}", self.addr, peers, sh.apply, self.pool,
                        data_dir=os.path.join(self.data_dir, f"sn_{shard_id}")
                        if self.data_dir else None,
                        snapshot_fn=sh.state_bytes,
                        restore_fn=sh.restore_state,
                        seeded=sh.seeded,
                    )
                    raftlib.register_routes(self.extra_routes, node)
                    self.rafts[shard_id] = node.start()

    def send_heartbeat(self, cm_client) -> None:
        """Liveness report to clustermgr (blobnode heartbeat analog for
        the shard domain); deployments call this on a timer."""
        cm_client.call("shardnode_heartbeat", {"addr": self.addr})

    def stop(self) -> None:
        """Stop every raft group, then close every shard. A split applied
        meanwhile opens its child's group under the node lock, so the
        groups are read under it and stopped outside it (a group's stop
        waits on its apply, which may hold the node lock) until none is
        left running."""
        stopped: set[int] = set()
        while True:
            with self._lock:
                rafts = [r for r in self.rafts.values() if id(r) not in stopped]
            if not rafts:
                break
            for r in rafts:
                r.stop()
                stopped.add(id(r))
        with self._lock:
            shards = list(self.shards.values())
        for sh in shards:
            sh.close()

    # ---------------- RPC surface ----------------
    def rpc_create_shard(self, args, body):
        self.create_shard(args["shard_id"], args.get("start", ""),
                          args.get("end", ""), args.get("peers"))
        return {}

    def rpc_kv_put(self, args, body):
        self._mutate(args["shard_id"],
                     {"op": "put", "key": args["key"], "value_hex": body.hex()})
        return {}

    def rpc_kv_get(self, args, body):
        try:
            return {}, self._shard(args["shard_id"], need_leader=True).get(args["key"])
        except KeyError:
            raise rpc.RpcError(404, f"no such key {args['key']!r}") from None

    def rpc_kv_delete(self, args, body):
        self._mutate(args["shard_id"], {"op": "delete", "key": args["key"]})
        return {}

    def rpc_kv_list(self, args, body):
        sh = self._shard(args["shard_id"], need_leader=True)
        return {"keys": sh.list(args.get("prefix", ""), int(args.get("limit", 100)))}

    def rpc_shard_stat(self, args, body):
        sh = self._shard(args["shard_id"])
        node = self.rafts.get(args["shard_id"])
        return {"shard_id": sh.shard_id, "start": sh.start, "end": sh.end,
                "items": sh.count(),
                "raft": node.status() if node else None}

    def rpc_shard_split(self, args, body):
        return self.split_shard(args["shard_id"], args["child_id"])

    def rpc_update_shard_peers(self, args, body):
        self.update_shard_peers(args["shard_id"], args["peers"])
        return {}

    def rpc_list_shards(self, args, body):
        with self._lock:
            return {"shards": [
                {"shard_id": sid, "start": sh.start, "end": sh.end,
                 "items": sh.count()}
                for sid, sh in sorted(self.shards.items())]}


# ---- shared range-map primitives (used by the client-side Catalog AND
# clustermgr's replicated catalog — one implementation to keep in sync)
def route_ranges(shards: list[dict], key: str) -> dict:
    for sh in reversed(shards):
        if sh["start"] <= key and (not sh["end"] or key < sh["end"]):
            return dict(sh)
    raise KeyError(f"no shard owns key {key!r}")


def split_ranges(shards: list[dict], parent_id: int, child_id: int,
                 split_key: str) -> None:
    """In-place range handoff after a shard split: the parent keeps
    [start, split_key), the child serves [split_key, old_end).
    Idempotent under retries; rejects a split key outside the parent's
    CURRENT range (it would create overlapping ranges)."""
    if any(s["shard_id"] == child_id for s in shards):
        return
    parent = next(s for s in shards if s["shard_id"] == parent_id)
    if not (parent["start"] < split_key
            and (not parent["end"] or split_key < parent["end"])):
        raise ValueError(
            f"split key {split_key!r} outside parent range "
            f"[{parent['start']!r}, {parent['end']!r})")
    shards.append({"shard_id": child_id, "start": split_key,
                   "end": parent["end"], "addrs": list(parent["addrs"])})
    parent["end"] = split_key
    shards.sort(key=lambda s: s["start"])


class Catalog:
    """Space -> range-shard map (shardnode/catalog role, normally fed by
    clustermgr's catalog manager). Routes keys to shard replica sets."""

    def __init__(self):
        self._lock = lockwitness.make_lock("Catalog._lock")
        self.spaces: dict[str, list[dict]] = {}  # name -> [{shard_id, start, end, addrs}]

    def create_space(self, name: str, shards: list[dict]) -> None:
        with self._lock:
            self.spaces[name] = sorted(shards, key=lambda s: s["start"])

    def apply_split(self, name: str, parent_id: int, child_id: int,
                    split_key: str) -> None:
        with self._lock:
            split_ranges(self.spaces[name], parent_id, child_id, split_key)

    def route(self, name: str, key: str) -> dict:
        with self._lock:
            try:
                return route_ranges(self.spaces[name], key)
            except KeyError:
                raise KeyError(f"no shard owns key {key!r} in space "
                               f"{name!r}") from None
