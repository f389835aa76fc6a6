"""ClusterMgr: the EC-plane metadata center.

Role parity: blobstore/clustermgr (volume mgr / disk mgr / scope (BID)
mgr / config kv / service registry; svr.go:146,203). State mutations go
through a single apply() door with an append-only JSON WAL + snapshot —
the same FSM discipline the reference gets from raft+RocksDB, kept
pluggable so a consensus layer can replicate the apply stream.

The port's copy of ``cubefs_tpu/blob/clustermgr.py``: disks, volumes,
chunk ids, bid scopes, unit repointing, config and kv, persisted in the
reference's state and wal format, and the shardnode catalog (spaces,
shard ids, splits, replica sets, shardnode liveness) with its routes.
State the reference wrote opens here and the reverse.
"""

from __future__ import annotations

import json
import os
import time

import sys

from ..codec import codemode as cm
from ..utils import lockwitness, metrics, rpc
from ..utils.fsm import ReplicatedFsm
from . import topology
from .topology import NoAvailableDisks  # noqa: F401  (re-export: legacy import site)
from .types import DiskInfo, DiskStatus, VolumeInfo, VolumeStatus, VolumeUnit


class ClusterMgr(ReplicatedFsm):
    HEARTBEAT_TIMEOUT = 12.0  # seconds without heartbeat -> suspect

    def __init__(self, cluster_id: int = 1, data_dir: str | None = None,
                 allow_colocated_units: bool = False,
                 me: str | None = None, peers: list[str] | None = None,
                 node_pool=None):
        self.cluster_id = cluster_id
        self.data_dir = data_dir
        self.allow_colocated_units = allow_colocated_units
        self._lock = lockwitness.make_rlock("ClusterMgr._lock")
        self.disks: dict[int, DiskInfo] = {}
        self.volumes: dict[int, VolumeInfo] = {}
        self.services: dict[str, list[str]] = {}
        self.kv: dict[str, str] = {}  # configmgr: dynamic cluster config
        self.kvs: dict[str, str] = {}  # kvmgr: general KV (task ckpts &c)
        # scopemgr: named monotonic id scopes (scopemgr/scopemgr.go role);
        # "bid" is seeded from the legacy counter on first use
        self.scopes: dict[str, int] = {}
        # shardnode catalog (clustermgr/catalog role): space -> sorted
        # [{shard_id, start, end, addrs}] range map
        self.spaces: dict[str, list[dict]] = {}
        self._sn_heartbeat: dict[str, float] = {}  # volatile, leader-local
        self._placement_warned: set[str] = set()  # once-per-kind stderr note
        self._next_disk = 1
        self._next_vid = 1
        self._next_bid = 1
        self._next_chunk = 1
        self._next_shard = 1
        self._init_fsm("cm", data_dir, me, peers, node_pool)

    def _state_dict(self) -> dict:
        """Single source of truth for the FSM's serialized shape — used
        by BOTH the standalone snapshot and the raft snapshot/restore."""
        return {
            "cluster_id": self.cluster_id,
            "disks": {k: v.to_dict() for k, v in self.disks.items()},
            "volumes": {k: v.to_dict() for k, v in self.volumes.items()},
            "services": self.services,
            "kv": self.kv,
            "kvs": self.kvs,
            "scopes": self.scopes,
            "spaces": self.spaces,
            "next": [self._next_disk, self._next_vid, self._next_bid,
                     self._next_chunk, self._next_shard],
        }

    def _load_state_dict(self, state: dict) -> None:
        self.cluster_id = state["cluster_id"]
        self.disks = {int(k): DiskInfo.from_dict(v)
                      for k, v in state["disks"].items()}
        self.volumes = {int(k): VolumeInfo.from_dict(v)
                        for k, v in state["volumes"].items()}
        self.services = state["services"]
        self.kv = state["kv"]
        self.kvs = state.get("kvs", {})
        self.scopes = state.get("scopes", {})
        self.spaces = state.get("spaces", {})
        nxt = state["next"]
        (self._next_disk, self._next_vid, self._next_bid,
         self._next_chunk) = nxt[:4]
        self._next_shard = nxt[4] if len(nxt) > 4 else 1

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
            return getattr(self, f"_apply_{op}")(**rec)

    # ---------------- disks & nodes ----------------
    def register_disk(self, node_addr: str, path: str,
                      op_id: str | None = None,
                      az: str = "", rack: str = "") -> int:
        # ids allocate INSIDE apply: a new leader whose apply stream lags
        # must never re-issue an id another leader already committed.
        # op_id dedups transport retries — without it a retried register
        # mints a second disk_id for the same physical disk.
        with self._propose_lock:
            # clock read happens HERE (proposer) and rides the record:
            # an apply-side time.time() would stamp replay/replica
            # applies with "now", marking a long-dead disk as freshly
            # heartbeated after every restart (fsm-purity CFM001)
            rec = {"op": "register_disk", "node_addr": node_addr,
                   "path": path, "ts": time.time()}
            if az:
                rec["az"] = az
            if rack:
                rec["rack"] = rack
            if op_id is not None:
                rec["op_id"] = op_id
            return self._commit(rec)

    def _apply_register_disk(self, node_addr: str, path: str,
                             az: str = "", rack: str = "",
                             ts: float = 0.0) -> int:
        disk_id = self._next_disk
        self._next_disk += 1
        self.disks[disk_id] = DiskInfo(disk_id, node_addr, path,
                                       last_heartbeat=ts,
                                       az=az, rack=rack)
        return disk_id

    def heartbeat(self, disk_ids: list[int], chunk_counts: dict | None = None,
                  az: str | None = None, rack: str | None = None,
                  quarantined: list[int] | None = None) -> None:
        now = time.time()
        relabel = []
        flips = []  # (disk_id, new_status) quarantine transitions
        with self._lock:
            qset = set(quarantined or [])
            for d in disk_ids:
                if d in self.disks:
                    self.disks[d].last_heartbeat = now
                    if chunk_counts and str(d) in chunk_counts:
                        self.disks[d].chunk_count = chunk_counts[str(d)]
                    if az is not None and (
                            self.disks[d].az != az
                            or (rack is not None and self.disks[d].rack != rack)):
                        relabel.append(d)
                    # node-reported quarantine: NORMAL<->QUARANTINED only
                    # (never overrides BROKEN/REPAIRING — those are
                    # harder states with their own lifecycle)
                    st = self.disks[d].status
                    if d in qset and st == DiskStatus.NORMAL:
                        flips.append((d, int(DiskStatus.QUARANTINED)))
                    elif d not in qset and st == DiskStatus.QUARANTINED:
                        flips.append((d, int(DiskStatus.NORMAL)))
        # label changes are replicated state — go through the FSM door,
        # never mutated in the volatile heartbeat path above. Best
        # effort: a follower receiving a stray heartbeat drops the
        # relabel (the node retries against the leader on its next beat)
        for d in relabel:
            try:
                self.relabel_disk(d, az, rack)
            except Exception:
                break
        # quarantine flips take the same FSM door + best-effort stance
        for d, st in flips:
            try:
                self.set_disk_status(d, st)
            except Exception:
                break

    def relabel_disk(self, disk_id: int, az: str,
                     rack: str | None = None) -> None:
        with self._propose_lock:
            self._commit({"op": "relabel_disk", "disk_id": disk_id,
                          "az": az, "rack": rack})

    def _apply_relabel_disk(self, disk_id: int, az: str,
                            rack: str | None = None) -> None:
        d = self.disks.get(disk_id)
        if d is None:
            return
        d.az = az
        if rack is not None:
            d.rack = rack

    def set_disk_status(self, disk_id: int, status: int) -> None:
        # validate BEFORE the commit: a nonsense status in the replicated
        # FSM strands the disk (neither allocatable nor repairable)
        status = int(DiskStatus(status))
        with self._propose_lock:
            self._commit({"op": "set_disk_status", "disk_id": disk_id,
                          "status": status})

    def _apply_set_disk_status(self, disk_id: int, status: int) -> None:
        self.disks[disk_id].status = int(status)

    def suspect_dead_disks(self) -> list[int]:
        """Disks past the heartbeat timeout (the failure detector's input;
        reference master/cluster.go:851-902 heartbeat checks analog)."""
        now = time.time()
        with self._lock:
            return [
                d.disk_id
                for d in self.disks.values()
                if d.status == DiskStatus.NORMAL
                and now - d.last_heartbeat > self.HEARTBEAT_TIMEOUT
            ]

    # ---------------- volumes ----------------
    def alloc_volume(self, codemode: int,
                     op_id: str | None = None) -> VolumeInfo:
        """Create a volume: the topology selector maps each unit slot to
        its codemode-assigned AZ (LRC local stripes stay AZ-local) and
        spreads within an AZ across racks/hosts/disks. Colocation and
        AZ shortfalls degrade explicitly: warning under
        allow_colocated_units, NoAvailableDisks otherwise."""
        t = cm.tactic(codemode)
        with self._propose_lock:
            with self._lock:
                disks = list(self.disks.values())
            picks, warnings = topology.place_volume(
                t, disks, self.allow_colocated_units,
                label=cm.CodeMode(codemode).name)
            for w in warnings:
                kind = w.split(":", 1)[0]
                metrics.placement_colocated.inc(kind=kind)
                if kind not in self._placement_warned:
                    self._placement_warned.add(kind)
                    print(f"[clustermgr] placement degraded: {w}",
                          file=sys.stderr)
            # placement decided leader-side; vid/chunk ids allocate in apply
            rec = {
                "op": "create_volume",
                "codemode": int(codemode),
                "picks": [{"disk_id": p.disk_id, "node_addr": p.node_addr,
                           "az": topology.az_of(p)} for p in picks],
            }
            if op_id is not None:
                rec["op_id"] = op_id
            vid = self._commit(rec)
            return self.get_volume(vid)

    def _apply_create_volume(self, codemode: int, picks: list[dict]) -> int:
        vid = self._next_vid
        self._next_vid += 1
        units = []
        for i, p in enumerate(picks):
            az = p.get("az", "")
            if not az:
                # pre-topology WAL records: derive from the disk table
                d = self.disks.get(p["disk_id"])
                az = topology.az_of(d) if d is not None else ""
            units.append(VolumeUnit(i, p["disk_id"], self._next_chunk,
                                    p["node_addr"], az=az))
            self._next_chunk += 1
        vol = VolumeInfo(vid=vid, codemode=codemode, units=units,
                         status=VolumeStatus.ACTIVE)
        self.volumes[vid] = vol
        for u in vol.units:
            if u.disk_id in self.disks:
                self.disks[u.disk_id].chunk_count += 1
        return vid

    def get_volume(self, vid: int) -> VolumeInfo:
        with self._lock:
            # defensive copy: callers (incl. in-process clients) must not
            # alias the FSM's internal state
            return VolumeInfo.from_dict(self.volumes[vid].to_dict())

    def update_volume_unit(self, vid: int, index: int, disk_id: int,
                           chunk_id: int, node_addr: str) -> None:
        """Repair writeback: point a shard slot at its new home."""
        with self._propose_lock:
            self._commit({"op": "update_unit", "vid": vid, "index": index,
                          "disk_id": disk_id, "chunk_id": chunk_id,
                          "node_addr": node_addr})

    def _apply_update_unit(self, vid: int, index: int, disk_id: int,
                           chunk_id: int, node_addr: str) -> None:
        vol = self.volumes[vid]
        # az derives from the disk table, not the proposal: every
        # replica resolves the same label for the same committed disk_id
        d = self.disks.get(disk_id)
        vol.units[index] = VolumeUnit(index, disk_id, chunk_id, node_addr,
                                      az=topology.az_of(d) if d else "")
        vol.epoch += 1

    def volumes_on_disk(self, disk_id: int) -> list[tuple[int, int]]:
        """(vid, unit_index) pairs whose shard lives on the disk — the
        scheduler's repair work-list for a broken disk."""
        with self._lock:
            out = []
            for vol in self.volumes.values():
                for u in vol.units:
                    if u.disk_id == disk_id:
                        out.append((vol.vid, u.index))
            return out

    def pick_destination(self, exclude_disks: set[int],
                         hard_exclude: set[int] | None = None,
                         prefer_az: str | None = None,
                         require_az: bool = False,
                         avoid_hosts=(),
                         require_new_host: bool = False) -> DiskInfo:
        """Topology-routed repair/rebalance destination: prefers a disk
        in prefer_az (the failed slot's AZ), then any NORMAL disk
        outside exclude_disks, then — only with allow_colocated_units —
        disks the volume already uses (colocating beats staying
        degraded). Only hard_exclude (broken/source disks) is absolute;
        require_az/require_new_host harden the soft preferences for
        rebalance moves that must strictly improve spread."""
        with self._lock:
            disks = list(self.disks.values())
        return topology.pick_destination(
            disks, exclude_disks, hard_exclude,
            prefer_az=prefer_az, require_az=require_az,
            avoid_hosts=avoid_hosts, require_new_host=require_new_host,
            allow_colocated=self.allow_colocated_units)

    def alloc_chunk_id(self) -> int:
        with self._propose_lock:
            return self._commit({"op": "alloc_chunk"})

    def _apply_alloc_chunk(self) -> int:
        cid = self._next_chunk
        self._next_chunk += 1
        return cid

    # ---------------- scope allocation (scopemgr role) ----------------
    # Named monotonic id ranges (scopemgr/scopemgr.go): BIDs are the
    # "bid" scope; any subsystem can carve its own id space without a
    # new FSM op. Allocation happens inside apply, so a lagging new
    # leader can never re-issue a committed range. The op_id rides the
    # committed record through ReplicatedFsm._apply_deduped, so a chaos
    # drop-after-execute on a blob put retries alloc_bids without
    # leaking a range (tests/test_chaos.py proves this end to end).
    def alloc_bids(self, count: int, op_id: str | None = None) -> int:
        with self._propose_lock:
            rec = {"op": "alloc_bids", "count": count}
            if op_id is not None:
                rec["op_id"] = op_id
            return self._commit(rec)

    def _apply_alloc_bids(self, count: int) -> int:
        # BIDs ARE the "bid" scope: both APIs draw from one counter, so
        # neither can ever re-issue a range the other handed out
        return self._apply_alloc_scope("bid", count)

    def alloc_scope(self, name: str, count: int = 1,
                    op_id: str | None = None) -> int:
        """First id of a freshly committed [start, start+count) range."""
        if count < 1:
            raise ValueError("count must be >= 1")
        with self._propose_lock:
            rec = {"op": "alloc_scope", "name": name, "count": count}
            if op_id is not None:
                rec["op_id"] = op_id
            return self._commit(rec)

    def _apply_alloc_scope(self, name: str, count: int) -> int:
        if name == "bid" and "bid" not in self.scopes:
            # seed from the legacy counter (pre-scope snapshots)
            self.scopes["bid"] = self._next_bid
        start = self.scopes.get(name, 1)
        self.scopes[name] = start + count
        if name == "bid":
            self._next_bid = self.scopes["bid"]  # keep legacy field honest
        return start

    def scope_watermark(self, name: str) -> int:
        """Next unissued id for a scope (inspection/CLI)."""
        with self._lock:
            if name == "bid" and "bid" not in self.scopes:
                # scope unseeded (no alloc since the pre-scope era): the
                # legacy counter is still the authority, same fallback
                # _apply_alloc_scope seeds from — reporting 1 here would
                # claim already-issued BIDs as unissued
                return self._next_bid
            return self.scopes.get(name, 1)

    # ---------------- service registry & config ----------------
    def register_service(self, name: str, addr: str) -> None:
        with self._propose_lock:
            self._commit({"op": "register_service", "name": name, "addr": addr})

    def _apply_register_service(self, name: str, addr: str) -> None:
        self.services.setdefault(name, [])
        if addr not in self.services[name]:
            self.services[name].append(addr)

    def get_service(self, name: str) -> list[str]:
        with self._lock:
            return list(self.services.get(name, []))

    def set_config(self, key: str, value: str) -> None:
        with self._propose_lock:
            self._commit({"op": "set_config", "key": key, "value": value})

    def _apply_set_config(self, key: str, value: str) -> None:
        self.kv[key] = value

    def get_config(self, key: str, default: str | None = None) -> str | None:
        with self._lock:
            return self.kv.get(key, default)

    def delete_config(self, key: str) -> None:
        with self._propose_lock:
            self._commit({"op": "delete_config", "key": key})

    def _apply_delete_config(self, key: str) -> None:
        self.kv.pop(key, None)

    def list_config(self) -> dict[str, str]:
        with self._lock:
            return dict(self.kv)

    # ---------------- general KV (kvmgr role) ----------------
    # blobstore/clustermgr/kvmgr: replicated general-purpose KV with
    # prefix/marker paging — scheduler checkpoints and task records ride
    # here in the reference.
    def kv_set(self, key: str, value: str) -> None:
        with self._propose_lock:
            self._commit({"op": "kv_set", "key": key, "value": value})

    def _apply_kv_set(self, key: str, value: str) -> None:
        self.kvs[key] = value

    def kv_get(self, key: str) -> str | None:
        with self._lock:
            return self.kvs.get(key)

    def kv_delete(self, key: str) -> None:
        with self._propose_lock:
            self._commit({"op": "kv_delete", "key": key})

    def _apply_kv_delete(self, key: str) -> None:
        self.kvs.pop(key, None)

    def kv_list(self, prefix: str = "", marker: str = "",
                count: int = 100) -> tuple[list[tuple[str, str]], str]:
        """Sorted (key, value) page after `marker`; returns
        (items, next_marker) with next_marker == "" on the last page."""
        count = max(1, int(count))
        with self._lock:
            keys = sorted(k for k in self.kvs
                          if k.startswith(prefix) and k > marker)
            page = keys[:count]
            nxt = page[-1] if len(keys) > count else ""
            return [(k, self.kvs[k]) for k in page], nxt

    # ---------------- shardnode catalog ----------------
    # clustermgr/catalog role: the authoritative space -> range-shard
    # map shardnode clients route by, raft-replicated like every other
    # piece of clustermgr state.
    def create_space(self, name: str, shard_count: int,
                     replica_addrs: list[str]) -> list[dict]:
        """Carve the keyspace into `shard_count` contiguous ranges over
        one replica set. Range bounds use the reference's hex-prefix
        style split of a flat namespace."""
        if not 1 <= shard_count <= 4096:
            # beyond 4096 initial ranges the 16-bit bounds would
            # collide into degenerate [x, x) shards; grow by splitting
            raise ValueError("shard_count must be in 1..4096")
        bounds = [""] + [
            format(i * 65536 // shard_count, "04x")
            for i in range(1, shard_count)
        ] + [""]
        with self._propose_lock:
            return self._commit({
                "op": "create_space", "name": name,
                "bounds": bounds, "addrs": replica_addrs})

    def _apply_create_space(self, name: str, bounds: list[str],
                            addrs: list[str]) -> list[dict]:
        if name in self.spaces:
            raise ValueError(f"space {name!r} exists")
        shards = []
        for i in range(len(bounds) - 1):
            shards.append({"shard_id": self._next_shard,
                           "start": bounds[i], "end": bounds[i + 1],
                           "addrs": list(addrs)})
            self._next_shard += 1
        self.spaces[name] = shards
        return [dict(s) for s in shards]

    def alloc_shard_id(self) -> int:
        with self._propose_lock:
            return self._commit({"op": "alloc_shard"})

    def _apply_alloc_shard(self) -> int:
        sid = self._next_shard
        self._next_shard += 1
        return sid

    def register_split(self, space: str, parent_id: int, child_id: int,
                       split_key: str) -> None:
        with self._propose_lock:
            self._commit({"op": "register_split", "space": space,
                          "parent_id": parent_id, "child_id": child_id,
                          "split_key": split_key})

    def _apply_register_split(self, space: str, parent_id: int,
                              child_id: int, split_key: str) -> None:
        from .shardnode import split_ranges

        split_ranges(self.spaces[space], parent_id, child_id, split_key)

    # shardnode liveness (volatile, leader-local — the same contract as
    # disk heartbeats: a fresh leader starts blind and the scheduler's
    # grace period covers it)
    def shardnode_heartbeat(self, addr: str) -> None:
        with self._lock:
            self._sn_heartbeat[addr] = time.time()

    def shardnode_last_seen(self, addr: str) -> float | None:
        with self._lock:
            return self._sn_heartbeat.get(addr)

    def suspect_dead_shardnodes(self) -> list[str]:
        """Shardnode addrs referenced by any space that have missed the
        heartbeat window (never-seen addrs are NOT suspected — a blind
        fresh leader must not declare the world dead)."""
        now = time.time()
        with self._lock:
            hb = self._sn_heartbeat
            referenced = {a for shards in self.spaces.values()
                          for s in shards for a in s["addrs"]}
            return sorted(
                a for a in referenced
                if a in hb and now - hb[a] > self.HEARTBEAT_TIMEOUT)

    def update_shard_addrs(self, space: str, shard_id: int,
                           addrs: list[str]) -> None:
        with self._propose_lock:
            self._commit({"op": "update_shard_addrs", "space": space,
                          "shard_id": shard_id, "addrs": addrs})

    def _apply_update_shard_addrs(self, space: str, shard_id: int,
                                  addrs: list[str]) -> None:
        for s in self.spaces[space]:
            if s["shard_id"] == shard_id:
                s["addrs"] = list(addrs)
                return
        raise KeyError(f"shard {shard_id} not in space {space!r}")

    def route_key(self, space: str, key: str) -> dict:
        from .shardnode import route_ranges

        with self._lock:
            try:
                return route_ranges(self.spaces[space], key)
            except KeyError:
                raise KeyError(
                    f"no shard owns {key!r} in space {space!r}") from None

    def get_space(self, name: str) -> list[dict]:
        with self._lock:
            return [dict(s) for s in self.spaces[name]]

    def snapshot_spaces(self) -> dict[str, list[dict]]:
        """Copy of the whole catalog under the lock — sweeps must not
        iterate live dicts the raft apply thread mutates."""
        with self._lock:
            return {name: [dict(s) for s in shards]
                    for name, shards in self.spaces.items()}

    def topology_view(self) -> dict:
        """AZ->rack->host->disk tree + misplacement/skew summary for
        `cubefs-cli topology blob` (snapshotted under the lock)."""
        with self._lock:
            disks = [DiskInfo.from_dict(d.to_dict())
                     for d in self.disks.values()]
            vols = [VolumeInfo.from_dict(v.to_dict())
                    for v in self.volumes.values()]
        return topology.cluster_view(disks, vols)

    def stat(self) -> dict:
        with self._lock:
            return {
                "cluster_id": self.cluster_id,
                "disks": len(self.disks),
                "volumes": len(self.volumes),
                "broken_disks": sum(
                    1 for d in self.disks.values() if d.status == DiskStatus.BROKEN
                ),
            }

    # ---------------- RPC surface ----------------
    def rpc_register_disk(self, args, body):
        self._leader_gate()
        return {"disk_id": self.register_disk(args["node_addr"], args["path"],
                                              op_id=args.get("op_id"),
                                              az=args.get("az", ""),
                                              rack=args.get("rack", ""))}

    def rpc_heartbeat(self, args, body):
        self.heartbeat(args["disk_ids"], args.get("chunk_counts"),
                       az=args.get("az"), rack=args.get("rack"),
                       quarantined=args.get("quarantined"))
        return {}

    def rpc_topology_view(self, args, body):
        self._leader_gate()
        return self.topology_view()

    def rpc_alloc_volume(self, args, body):
        self._leader_gate()
        return {"volume": self.alloc_volume(
            args["codemode"], op_id=args.get("op_id")).to_dict()}

    def rpc_get_volume(self, args, body):
        self._leader_gate()
        return {"volume": self.get_volume(args["vid"]).to_dict()}

    def rpc_alloc_bids(self, args, body):
        self._leader_gate()
        return {"start": self.alloc_bids(args["count"],
                                         op_id=args.get("op_id"))}

    def rpc_set_disk_status(self, args, body):
        self.set_disk_status(args["disk_id"], args["status"])
        return {}

    def rpc_list_disks(self, args, body):
        self._leader_gate()  # replicated mode: no stale follower reads
        with self._lock:
            return {"disks": {str(k): v.to_dict()
                              for k, v in self.disks.items()}}

    def rpc_list_volumes(self, args, body):
        self._leader_gate()
        with self._lock:
            vols = self.volumes
            status = args.get("status")
            return {"volumes": {
                str(k): v.to_dict() for k, v in vols.items()
                if status is None or v.status == status}}

    def rpc_update_volume_unit(self, args, body):
        self.update_volume_unit(args["vid"], args["index"], args["disk_id"],
                                args["chunk_id"], args["node_addr"])
        return {}

    def rpc_register_service(self, args, body):
        self.register_service(args["name"], args["addr"])
        return {}

    def rpc_set_config(self, args, body):
        self._leader_gate()
        self.set_config(args["key"], args["value"])
        return {}

    def rpc_get_config(self, args, body):
        return {"value": self.get_config(args["key"])}

    def rpc_delete_config(self, args, body):
        self._leader_gate()
        self.delete_config(args["key"])
        return {}

    def rpc_list_config(self, args, body):
        return {"config": self.list_config()}

    def rpc_kv_set(self, args, body):
        self._leader_gate()
        self.kv_set(args["key"], args["value"])
        return {}

    def rpc_kv_get(self, args, body):
        return {"value": self.kv_get(args["key"])}

    def rpc_kv_delete(self, args, body):
        self._leader_gate()
        self.kv_delete(args["key"])
        return {}

    def rpc_kv_list(self, args, body):
        items, marker = self.kv_list(args.get("prefix", ""),
                                     args.get("marker", ""),
                                     int(args.get("count", 100)))
        return {"items": items, "marker": marker}

    def rpc_alloc_scope(self, args, body):
        self._leader_gate()
        return {"start": self.alloc_scope(args["name"],
                                          int(args.get("count", 1)),
                                          op_id=args.get("op_id"))}

    def rpc_scope_watermark(self, args, body):
        return {"next": self.scope_watermark(args["name"])}

    def rpc_get_service(self, args, body):
        return {"addrs": self.get_service(args["name"])}

    def rpc_stat(self, args, body):
        return self.stat()

    def rpc_create_space(self, args, body):
        self._leader_gate()
        try:
            shards = self.create_space(args["name"], args["shard_count"],
                                       args["addrs"])
        except ValueError as e:
            raise rpc.RpcError(409, str(e)) from None
        return {"shards": shards}

    def rpc_get_space(self, args, body):
        self._leader_gate()
        try:
            return {"shards": self.get_space(args["name"])}
        except KeyError:
            raise rpc.RpcError(404, f"no space {args['name']!r}") from None

    def rpc_route_key(self, args, body):
        self._leader_gate()
        try:
            return {"shard": self.route_key(args["space"], args["key"])}
        except KeyError as e:
            raise rpc.RpcError(404, str(e)) from None

    def rpc_alloc_shard_id(self, args, body):
        self._leader_gate()
        return {"shard_id": self.alloc_shard_id()}

    def rpc_register_split(self, args, body):
        self._leader_gate()
        self.register_split(args["space"], args["parent_id"],
                            args["child_id"], args["split_key"])
        return {}

    def rpc_shardnode_heartbeat(self, args, body):
        self.shardnode_heartbeat(args["addr"])
        return {}

    def rpc_update_shard_addrs(self, args, body):
        self._leader_gate()
        self.update_shard_addrs(args["space"], args["shard_id"],
                                args["addrs"])
        return {}

    def rpc_raft_status(self, args, body):
        return self.raft.status() if self.raft else {"role": "standalone"}
