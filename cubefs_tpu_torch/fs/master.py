"""Master: the FS-plane resource manager.

Role parity: master/ — volume lifecycle (meta-partition inode ranges +
data-partition replica sets, cluster.go:3992 vol create / :1901 dp
create), node registries with heartbeat health checks (cluster.go:
851-902), and replica-repair orchestration on node death (decommission
machinery, cluster.go:2525).

Topology (master/topology.go): nodes belong to ZONES; within a zone
they chunk into NODESETS (failure domains). Placement spreads a
partition's replicas across zones when several exist (one per zone),
and keeps them inside one nodeset otherwise — via a PLUGGABLE node
selector (master/node_selector.go: carry-weight, round-robin,
least-load). Meta partitions SPLIT when their inode range fills
(docs/source/design/master.md:23-34): the maintenance sweep appends a
fresh mp for the next range, with zero interruption to existing ones.

The port's copy of ``cubefs_tpu/fs/master.py``, on the port's raft and
segmented ``utils/fsm.py``: its segment store, WAL and raft directory
have the reference's format.
"""

from __future__ import annotations

import json
import os
import threading
import time

from . import topology
from ..utils import lockwitness, metrics, rpc
from ..utils.fsm import ReplicatedFsm
from .topology import SELECTORS  # noqa: F401  (public selector registry)

INO_RANGE = 1 << 24  # inodes per meta partition


class MasterError(Exception):
    pass


class Master(ReplicatedFsm):
    HEARTBEAT_TIMEOUT = 10.0
    INO_RANGE = INO_RANGE  # inodes per meta partition (tests shrink it)
    MP_SPLIT_THRESHOLD = 0.8  # fill fraction that triggers an mp split
    NODESET_SIZE = 3

    def __init__(self, node_pool, replicas: int = 3, allow_single_node: bool = False,
                 data_dir: str | None = None, me: str | None = None,
                 peers: list[str] | None = None, selector: str = "least_load"):
        self.nodes = node_pool
        self.replicas = replicas
        self.allow_single_node = allow_single_node
        if selector not in SELECTORS:
            raise MasterError(f"unknown selector {selector!r}; "
                              f"have {sorted(SELECTORS)}")
        self.selector = selector
        self._selector_state: dict = {}
        self._lock = lockwitness.make_rlock("Master._lock")
        self.datanodes: dict[str, dict] = {}  # addr -> info (heartbeat-local)
        self.metanodes: dict[str, dict] = {}
        self.volumes: dict[str, dict] = {}
        # soft usage view from the latest quota sweep — NOT part of the
        # replicated FSM (a new leader re-learns it on its first sweep)
        self.vol_usage: dict[str, int] = {}
        # operator drains ARE replicated state: a restart or failover
        # must not re-place partitions on a drained node
        self.decommissioned: set[str] = set()
        # AK/SK user registry with per-volume grants (master/user.go):
        # replicated FSM state, served to gateways for authentication
        self.users: dict[str, dict] = {}  # ak -> {user_id, sk, volumes}
        # in-flight metapartition range migrations (fs/split.py):
        # REPLICATED state — split_prepare lands the fence (and the
        # target pid reservation) durably BEFORE any metanode RPC, so a
        # crash mid-PREPARE can neither mint a duplicate pid nor lose
        # track of a half-built target partition
        self.splits: dict[str, dict] = {}  # split_id -> plan
        self._split_engine = None  # lazy SplitEngine (fs/split.py)
        self._next_pid = 1
        self._next_dp = 1
        self.data_dir = data_dir
        self._init_fsm("master", data_dir, me, peers, node_pool)

    def _state_dict(self) -> dict:
        return {"volumes": self.volumes,
                "next": [self._next_pid, self._next_dp],
                "decommissioned": sorted(self.decommissioned),
                "users": self.users,
                "splits": self.splits}

    def _load_state_dict(self, state: dict) -> None:
        self.volumes = state["volumes"]
        self._next_pid, self._next_dp = state["next"]
        self.decommissioned = set(state.get("decommissioned", []))
        self.users = state.get("users", {})
        self.splits = state.get("splits", {})
        self._recalc_next_pid()

    def _recalc_next_pid(self) -> None:
        """Re-derive the pid high-water mark from every committed source.

        Committed volume mps are not enough: a split that crashed between
        split_prepare and split_commit has reserved a target pid that
        lives only in ``self.splits``.  Recovery (or a follower catching
        up from a snapshot) must scan those too, or the next volume
        create could mint a duplicate pid and two partitions would fight
        over one raft group directory.
        """
        hi = self._next_pid
        for vol in self.volumes.values():
            for m in vol["mps"]:
                hi = max(hi, m["pid"] + 1)
        for s in self.splits.values():
            for tp in s.get("target_pids", []):
                hi = max(hi, tp + 1)
        self._next_pid = hi

    def _state_bytes(self) -> bytes:
        with self._lock:
            return json.dumps(self._state_dict()).encode()

    def _restore_bytes(self, data: bytes) -> None:
        with self._lock:
            self._load_state_dict(json.loads(data))

    # ---- incremental snapshot segments (metadata_snapshot.go role:
    # snapshot cost is O(touched volumes/users), not O(cluster)) ----
    _SEG_OPS = {  # op -> (prefix, record key) for per-entity segments
        "put_volume": ("vol", "name"),
        "add_mp": ("vol", "name"),
        "update_dp": ("vol", "name"),
        "set_vol_capacity": ("vol", "name"),
        "set_quota": ("vol", "name"),
        "delete_quota": ("vol", "name"),
        "put_user": ("user", "ak"),
        "delete_user": ("user", "ak"),
        "set_grant": ("user", "ak"),
        "split_commit": ("vol", "name"),
        "merge_commit": ("vol", "name"),
    }

    def _segments_of(self, rec: dict) -> list[str]:
        op = rec["op"]
        segs = []
        ent = self._SEG_OPS.get(op)
        if ent is not None:
            segs.append(f"{ent[0]}:{rec[ent[1]]}")
        if op in ("put_volume", "add_mp", "decommission", "split_prepare",
                  "split_commit", "split_abort", "merge_commit"):
            segs.append("meta")  # id counters / drain set / splits moved
        return segs or ["meta"]  # unknown future op: at least the meta

    def _segment_state(self, seg: str):
        kind, _, key = seg.partition(":")
        with self._lock:
            if kind == "vol":
                return self.volumes.get(key)
            if kind == "user":
                return self.users.get(key)
            return {"next": [self._next_pid, self._next_dp],
                    "decommissioned": sorted(self.decommissioned),
                    "splits": self.splits}

    def _load_segment_state(self, seg: str, value) -> None:
        kind, _, key = seg.partition(":")
        if kind == "vol":
            self.volumes[key] = value
        elif kind == "user":
            self.users[key] = value
        else:
            self._next_pid, self._next_dp = value["next"]
            self.decommissioned = set(value["decommissioned"])
            self.splits = value.get("splits", {})
            self._recalc_next_pid()

    def _all_segments(self) -> list[str]:
        with self._lock:
            return (["meta"]
                    + [f"vol:{n}" for n in self.volumes]
                    + [f"user:{a}" for a in self.users])

    def _apply(self, rec: dict):
        rec = dict(rec)
        op = rec.pop("op")
        with self._lock:
            return getattr(self, f"_apply_{op}")(**rec)

    def _apply_put_volume(self, name: str, vol: dict) -> None:
        self.volumes[name] = vol
        # scan in-flight splits too: a crash mid-PREPARE has reserved
        # target pids in self.splits that no committed mp lists yet
        self._recalc_next_pid()
        self._next_dp = max([self._next_dp]
                            + [d["dp_id"] + 1 for d in vol["dps"]])

    # ------- elastic metadata plane (fs/split.py drives these) ---------
    # The three-phase migration commits its routing change as ONE master
    # FSM apply (split_commit / merge_commit): clients observe either the
    # old range table or the new one, never a torn intermediate, and
    # re-route on a single mp_version watermark bump.

    def _apply_split_prepare(self, name: str, split: dict) -> dict:
        """Reserve the split plan in the replicated ledger. Target pids
        are (re)assigned HERE, inside the apply: the engine plans
        without holding the proposal door, so a volume create can mint
        pids between plan and prepare — the apply is the one place the
        assignment is serial with every other pid source, and it is
        deterministic (same FSM state on every replica). Returns the
        stored record; the engine drives with the assigned pids."""
        sid = split["split_id"]
        split = dict(split, name=name)
        if split.get("target_pids"):
            split["target_pids"] = [self._next_pid]
            self._next_pid += 1
        self.splits[sid] = split
        return dict(split)

    def _apply_split_commit(self, split_id: str, name: str = "") -> None:
        s = self.splits.pop(split_id, None)
        if s is None:  # replayed / already aborted: nothing to do
            return
        vol = self.volumes.get(s["name"])
        if vol is None:
            return
        mps = vol["mps"]
        if s.get("kind") == "merge":
            # absorber extends over the donor's range; donor mp vanishes
            donor = next(m for m in mps if m["pid"] == s["donor_pid"])
            absorber = next(m for m in mps
                            if m["pid"] == s["absorber_pid"])
            absorber["end"] = max(absorber["end"], donor["end"])
            mps[:] = [m for m in mps if m["pid"] != s["donor_pid"]]
        else:
            donor = next(m for m in mps if m["pid"] == s["donor_pid"])
            hi = donor["end"]
            donor["end"] = s["split_ino"]
            mps.append({"pid": s["target_pids"][0],
                        "start": s["split_ino"], "end": hi,
                        "addr": s["addrs"][0], "addrs": s["addrs"]})
            mps.sort(key=lambda m: (m["start"], m["pid"]))
        vol["mp_version"] = vol.get("mp_version", 0) + 1

    def _apply_split_abort(self, split_id: str, name: str = "",
                           reason: str = "") -> None:
        self.splits.pop(split_id, None)

    # merge rides the same splits ledger; a distinct commit op keeps the
    # WAL legible and lets _SEG_OPS tag the volume segment it touches
    def _apply_merge_commit(self, split_id: str, name: str = "") -> None:
        self._apply_split_commit(split_id, name)

    # ---------------- users (master/user.go analog) --------------------
    def _apply_put_user(self, ak: str, user: dict) -> None:
        self.users[ak] = user

    def _apply_delete_user(self, ak: str) -> None:
        self.users.pop(ak, None)

    def _apply_set_grant(self, ak: str, volume: str,
                         perm: str | None) -> None:
        u = self.users.get(ak)
        if u is None:
            return
        if perm is None:
            u["volumes"].pop(volume, None)
        else:
            u["volumes"][volume] = perm

    def create_user(self, user_id: str) -> dict:
        import secrets as _secrets

        ak = _secrets.token_hex(8)
        sk = _secrets.token_hex(16)
        self._commit({"op": "put_user", "ak": ak, "user": {
            "user_id": user_id, "sk": sk, "volumes": {}}})
        return {"user_id": user_id, "access_key": ak, "secret_key": sk}

    def delete_user(self, ak: str) -> None:
        with self._lock:
            if ak not in self.users:
                raise MasterError(f"unknown access key {ak!r}")
        self._commit({"op": "delete_user", "ak": ak})

    def grant(self, ak: str, volume: str, perm: str = "rw") -> None:
        if perm not in ("r", "rw"):
            raise MasterError(f"bad perm {perm!r}")
        with self._lock:
            if ak not in self.users:
                raise MasterError(f"unknown access key {ak!r}")
        self._commit({"op": "set_grant", "ak": ak, "volume": volume,
                      "perm": perm})

    def revoke(self, ak: str, volume: str) -> None:
        self._commit({"op": "set_grant", "ak": ak, "volume": volume,
                      "perm": None})

    def secret_for(self, ak: str) -> str | None:
        with self._lock:
            u = self.users.get(ak)
            return u["sk"] if u else None

    def allowed(self, ak: str, volume: str, write: bool) -> bool:
        with self._lock:
            u = self.users.get(ak)
            if u is None:
                return False
            perm = u["volumes"].get(volume, "")
            return "w" in perm if write else bool(perm)

    def rpc_create_user(self, args, body):
        self._leader_gate()
        return self.create_user(args["user_id"])

    def rpc_delete_user(self, args, body):
        self._leader_gate()
        try:
            self.delete_user(args["ak"])
        except MasterError as e:
            raise rpc.RpcError(404, str(e)) from None
        return {}

    def rpc_grant(self, args, body):
        self._leader_gate()
        try:
            self.grant(args["ak"], args["volume"], args.get("perm", "rw"))
        except MasterError as e:
            raise rpc.RpcError(400, str(e)) from None
        return {}

    def rpc_revoke(self, args, body):
        self._leader_gate()
        self.revoke(args["ak"], args["volume"])
        return {}

    def rpc_list_users(self, args, body):
        with self._lock:
            # admin listing: secrets redacted
            return {"users": {ak: {"user_id": u["user_id"],
                                   "volumes": dict(u["volumes"])}
                              for ak, u in self.users.items()}}

    def rpc_user_auth_info(self, args, body):
        """Gateway authentication lookup: sk + grants for one access
        key (the objectnode's user-store backend)."""
        with self._lock:
            u = self.users.get(args["ak"])
            if u is None:
                raise rpc.RpcError(404, f"unknown access key")
            return {"sk": u["sk"], "user_id": u.get("user_id", ""),
                    "volumes": dict(u["volumes"])}

    # ---------------- quotas (master_quota_manager.go analog) ----------
    def _apply_set_vol_capacity(self, name: str, capacity: int) -> None:
        self.volumes[name]["capacity"] = capacity

    def _apply_set_quota(self, name: str, quota: dict) -> None:
        vol = self.volumes[name]
        vol.setdefault("quotas", {})[str(quota["qid"])] = quota

    def _apply_delete_quota(self, name: str, qid: int) -> None:
        self.volumes[name].get("quotas", {}).pop(str(qid), None)

    def set_vol_capacity(self, name: str, capacity: int) -> None:
        with self._lock:
            if name not in self.volumes:
                raise MasterError(f"no volume {name!r}")
        self._commit({"op": "set_vol_capacity", "name": name,
                      "capacity": capacity})

    def set_quota(self, name: str, dir_ino: int, max_bytes: int = 0,
                  max_files: int = 0) -> int:
        """Register a dir quota; files created under the dir inherit its
        quota id and metanodes enforce the limits. Returns the quota id
        (master_quota_manager.go setQuota analog)."""
        with self._propose_lock:
            with self._lock:
                if name not in self.volumes:
                    raise MasterError(f"no volume {name!r}")
                quotas = self.volumes[name].get("quotas", {})
                qid = 1 + max([int(k) for k in quotas], default=0)
            self._commit({"op": "set_quota", "name": name, "quota": {
                "qid": qid, "dir_ino": dir_ino, "max_bytes": max_bytes,
                "max_files": max_files}})
            return qid

    def delete_quota(self, name: str, qid: int) -> None:
        with self._lock:
            if name not in self.volumes:
                raise MasterError(f"no volume {name!r}")
            if str(qid) not in self.volumes[name].get("quotas", {}):
                raise MasterError(f"no quota {qid} on volume {name!r}")
        self._commit({"op": "delete_quota", "name": name, "qid": qid})

    def list_quotas(self, name: str) -> dict:
        with self._lock:
            vol = self.volumes.get(name)
            if vol is None:
                raise MasterError(f"no volume {name!r}")
            return dict(vol.get("quotas", {}))

    def enforce_quotas(self) -> dict:
        """Aggregation sweep (the reference's quota report/enforce loop):
        pull per-partition usage from metanode leaders, sum per volume
        and per quota id, then push vol-full + exceeded-quota flags to
        every partition replica. Enforcement is advisory-pushed (one
        sweep of lag), exactly like the reference. Returns the usage
        summary per volume."""
        with self._lock:
            vols = {n: ({"mps": [dict(m) for m in v["mps"]],
                         "capacity": v.get("capacity", 0),
                         "quotas": dict(v.get("quotas", {}))})
                    for n, v in self.volumes.items()}
        summary = {}
        for name, v in vols.items():
            used_bytes = used_files = 0
            per_quota: dict[str, dict] = {}
            for mp in v["mps"]:
                try:
                    meta, _ = rpc.call_replicas(
                        self.nodes, mp.get("addrs") or [mp["addr"]],
                        "usage_report", {"pid": mp["pid"]}, deadline=5.0)
                except Exception:
                    continue  # partition unreachable: retried next sweep
                used_bytes += meta["bytes"]
                used_files += meta["files"]
                for qid, u in meta.get("per_quota", {}).items():
                    agg = per_quota.setdefault(qid, {"bytes": 0, "files": 0})
                    agg["bytes"] += u["bytes"]
                    agg["files"] += u["files"]
            vol_full = bool(v["capacity"]) and used_bytes >= v["capacity"]
            exceeded = []
            for qid, q in v["quotas"].items():
                u = per_quota.get(qid, {"bytes": 0, "files": 0})
                if ((q["max_bytes"] and u["bytes"] >= q["max_bytes"])
                        or (q["max_files"] and u["files"] >= q["max_files"])):
                    exceeded.append(int(qid))
            for mp in v["mps"]:
                # every replica, directly: the usage pull above taught
                # the pool's client for a follower's address its leader
                for addr in mp.get("addrs") or [mp["addr"]]:
                    try:
                        self.nodes.get_direct(addr).call("set_enforcement", {
                            "pid": mp["pid"], "vol_full": vol_full,
                            "exceeded": exceeded})
                    except Exception:
                        pass
            with self._lock:
                self.vol_usage[name] = used_bytes
            summary[name] = {"used_bytes": used_bytes,
                             "used_files": used_files,
                             "vol_full": vol_full, "exceeded": exceeded,
                             "per_quota": per_quota}
        return summary

    def start_quota_sweeper(self, interval: float) -> None:
        """Run enforce_quotas on a fixed cadence (the reference's
        scheduleTask quota loop, master/cluster.go:492). The interval IS
        the enforcement-lag bound: a burst can overshoot a quota by at
        most interval x write-rate before the flags land at the
        metanodes (proved by tests/test_quota.py's overshoot test)."""
        self.stop_quota_sweeper()
        self._sweep_interval = interval
        self._sweep_stop = threading.Event()

        def loop():
            import sys

            from ..utils import metrics

            errs = metrics.DEFAULT.counter(
                "cubefs_quota_sweep_errors_total",
                "quota enforcement sweep failures")
            last_warned = 0.0
            while not self._sweep_stop.wait(interval):
                try:
                    self.enforce_quotas()
                except Exception as e:
                    # a persistently-failing sweep silently disables
                    # enforcement — count it and warn (rate-limited)
                    errs.inc()
                    now = time.time()
                    if now - last_warned > 60:
                        last_warned = now
                        print(f"quota sweep failed: {type(e).__name__}: {e}",
                              file=sys.stderr)

        self._sweep_thread = threading.Thread(target=loop, daemon=True)
        self._sweep_thread.start()

    def stop_quota_sweeper(self) -> None:
        ev = getattr(self, "_sweep_stop", None)
        if ev is not None:
            ev.set()
            self._sweep_thread.join(timeout=5)
            self._sweep_stop = None

    def _apply_update_dp(self, name: str, dp_id: int, replicas: list[str],
                         leader: str) -> None:
        for dp in self.volumes[name]["dps"]:
            if dp["dp_id"] == dp_id:
                dp["replicas"] = replicas
                dp["leader"] = leader

    # ---------------- registries ----------------
    def register_datanode(self, addr: str, zone: str = "default",
                          packet_addr: str | None = None,
                          disks: dict | None = None,
                          read_addr: str | None = None,
                          rack: str | None = None) -> None:
        with self._lock:
            info = self.datanodes.setdefault(addr, {"addr": addr})
            info["hb"] = time.time()
            info["zone"] = zone
            if rack:
                info["rack"] = rack
            if packet_addr:
                info["packet_addr"] = packet_addr
            if read_addr:
                info["read_addr"] = read_addr
            if disks is not None:
                info["disks"] = disks

    def register_metanode(self, addr: str, zone: str = "default",
                          packet_addr: str | None = None,
                          read_addr: str | None = None,
                          rack: str | None = None) -> None:
        with self._lock:
            info = self.metanodes.setdefault(addr, {"addr": addr})
            info["hb"] = time.time()
            info["zone"] = zone
            if rack:
                info["rack"] = rack
            if packet_addr:
                info["packet_addr"] = packet_addr
            if read_addr:
                info["read_addr"] = read_addr

    def heartbeat(self, addr: str, kind: str, zone: str | None = None,
                  packet_addr: str | None = None,
                  read_addr: str | None = None,
                  disks: dict | None = None,
                  rack: str | None = None) -> None:
        with self._lock:
            reg = self.datanodes if kind == "data" else self.metanodes
            # unknown addr re-registers: a restarted master recovers its
            # registries from the heartbeat stream — INCLUDING the packet
            # plane address, or a master restart would silently degrade
            # every client to HTTP
            info = reg.setdefault(addr, {"addr": addr})
            info["hb"] = time.time()
            if zone or "zone" not in info:
                info["zone"] = zone or "default"
            if rack:
                info["rack"] = rack
            if packet_addr:
                info["packet_addr"] = packet_addr
            if read_addr:
                info["read_addr"] = read_addr
            if disks is not None:
                # the disk report feeds the disk manager: a disk flagged
                # broken here gets its partitions migrated by the next
                # check_replicas sweep (master/disk_manager.go role)
                info["disks"] = disks

    def _live(self, reg: dict) -> list[str]:
        now = time.time()
        return [a for a, i in reg.items()
                if now - i["hb"] <= self.HEARTBEAT_TIMEOUT
                and a not in self.decommissioned]

    def _apply_decommission(self, addr: str) -> None:
        self.decommissioned.add(addr)

    def decommission_datanode(self, addr: str) -> list:
        """Operator-driven drain (cluster.go:2525 decommission analog):
        exclude the node from placement — committed through the
        replicated FSM, so restarts/failovers keep the drain — then
        rebuild every dp replica it holds onto live nodes. Returns the
        rebuild actions."""
        with self._lock:
            if addr not in self.datanodes:
                raise MasterError(f"unknown datanode {addr!r}")
        self._commit({"op": "decommission", "addr": addr})
        # the node no longer counts as live: the standard repair sweep
        # moves its replicas exactly as if it had died
        return self.check_replicas()

    def node_list(self) -> dict:
        with self._lock:
            now = time.time()

            def view(reg):
                return {
                    a: {"zone": i.get("zone", "default"),
                        "live": now - i["hb"] <= self.HEARTBEAT_TIMEOUT,
                        "decommissioned": a in self.decommissioned}
                    for a, i in reg.items()
                }

            return {"datanodes": view(self.datanodes),
                    "metanodes": view(self.metanodes)}

    # ---------------- topology (zones / nodesets) ----------------
    def _zones_of(self, reg: dict, live: list[str]) -> dict[str, list[str]]:
        return topology.zones_of(reg, live)

    def _nodesets(self, members: list[str]) -> list[list[str]]:
        """Chunk a zone's nodes into nodesets (failure domains) of
        NODESET_SIZE, deterministically by address order."""
        return topology.nodesets(members, self.NODESET_SIZE)

    def topology_view(self) -> dict:
        """Zone -> nodeset -> node tree for both node kinds, including
        dead/decommissioned nodes (flagged) so operators see the whole
        failure-domain picture (`cubefs-cli topology fs`)."""
        with self._lock:
            out = {}
            for kind, reg in (("datanodes", self.datanodes),
                              ("metanodes", self.metanodes)):
                live = set(self._live(reg))
                zones = self._zones_of(reg, list(reg))
                out[kind] = {
                    z: {
                        "nodesets": self._nodesets(members),
                        "nodes": {
                            a: {"live": a in live,
                                "decommissioned": a in self.decommissioned}
                            for a in sorted(members)
                        },
                    }
                    for z, members in sorted(zones.items())
                }
            return out

    def rpc_topology_view(self, args, body):
        return self.topology_view()

    def topology_tree(self) -> dict:
        """az -> rack -> node map for both node kinds (`cubefs-cli
        topology tree` renders this beside the blob-plane zone map)."""
        with self._lock:
            out = {}
            for kind, reg in (("datanodes", self.datanodes),
                              ("metanodes", self.metanodes)):
                out[kind] = topology.topology_tree(
                    reg, set(self._live(reg)), self.decommissioned)
            return out

    def rpc_topology_tree(self, args, body):
        return self.topology_tree()

    def _pick(self, cands: list[str], k: int, load: dict) -> list[str]:
        fn = SELECTORS[self.selector]
        return fn(cands, k, load, self._selector_state)

    def _select_hosts(self, reg: dict, live: list[str], k: int,
                      load: dict) -> list[str]:
        """Replica spread lives in the fs topology scorer (one-per-AZ
        when enough AZs, even spread, one nodeset otherwise); the
        master only supplies its pluggable selector."""
        return topology.select_hosts(reg, live, k, load, self._pick,
                                     self.NODESET_SIZE)

    # ---------------- volume lifecycle ----------------
    def create_volume(self, name: str, mp_count: int = 3, dp_count: int = 4) -> dict:
        # _propose_lock makes the duplicate-name check atomic with the
        # commit: without it two concurrent creates both pass the check
        # and the second silently clobbers the first's partition tables
        with self._propose_lock:
            return self._create_volume_locked(name, mp_count, dp_count)

    def _create_volume_locked(self, name: str, mp_count: int, dp_count: int) -> dict:
        if mp_count < 1 or dp_count < 1:
            raise MasterError("mp_count and dp_count must be >= 1")
        # Phase 1 — plan under the hot lock: dup-check, liveness, host
        # selection, id allocation. NO RPC in here: heartbeats contend
        # on _lock, so a slow node round-trip under it stalls liveness
        # tracking for the whole cluster. _propose_lock (held by our
        # caller) keeps the plan valid until commit.
        with self._lock:
            if name in self.volumes:
                raise MasterError(f"volume {name!r} exists")
            live_meta = self._live(self.metanodes)
            live_data = self._live(self.datanodes)
            if not live_meta or not live_data:
                raise MasterError("need live metanodes and datanodes")
            if len(live_data) < self.replicas and not self.allow_single_node:
                raise MasterError(
                    f"{len(live_data)} datanodes < {self.replicas} replicas"
                )

            mps = []
            meta_replicas = min(self.replicas, len(live_meta))
            meta_load = self._meta_load()
            for i in range(mp_count):
                pid = self._next_pid
                self._next_pid += 1
                start = 1 if i == 0 else i * self.INO_RANGE
                end = (i + 1) * self.INO_RANGE
                addrs = self._select_hosts(self.metanodes, live_meta,
                                           meta_replicas, meta_load)
                for a in addrs:
                    meta_load[a] = meta_load.get(a, 0) + 1
                mps.append({"pid": pid, "start": start, "end": end,
                            "addr": addrs[0], "addrs": addrs})

            dps = []
            intra_load: dict[str, int] = {}
            for i in range(dp_count):
                dps.append(self._plan_dp(live_data, intra_load))
            vol = {"name": name, "mps": mps, "dps": dps, "status": "active"}
        # Phase 2 — issue the partition creates lock-free (safe to
        # retry: nodes treat a duplicate create of a known pid/dp_id as
        # get-or-refresh). A failure aborts before commit, leaving only
        # idempotently re-creatable partitions behind.
        for m in mps:
            for a in m["addrs"]:
                self.nodes.get_direct(a).call(
                    "create_partition",
                    {"pid": m["pid"], "start": m["start"], "end": m["end"],
                     "peers": m["addrs"]},
                )
        for d in dps:
            for addr in d["replicas"]:
                self.nodes.get(addr).call(
                    "create_partition",
                    {"dp_id": d["dp_id"], "peers": d["replicas"],
                     "leader": d["leader"]},
                )
        # commit the volume table through the FSM door (wal or raft)
        self._commit({"op": "put_volume", "name": name, "vol": vol})
        return self.client_view(name)

    def _plan_dp(self, live_data: list[str], intra_load: dict | None = None) -> dict:
        """Place one dp — pure planning, caller holds _lock; the
        create_partition RPCs go out after the lock is released."""
        dp_id = self._next_dp
        self._next_dp += 1
        k = min(self.replicas, len(live_data))
        # load counts dps per node, INCLUDING ones placed earlier in
        # this same create_volume call (intra_load); topology-aware
        # selection spreads across zones / keeps inside a nodeset, and
        # leadership rotates so one node is not every dp's write leader
        load = {a: 0 for a in live_data}
        for v in self.volumes.values():
            for dp in v["dps"]:
                for r in dp["replicas"]:
                    if r in load:
                        load[r] += 1
        for a, n in (intra_load or {}).items():
            if a in load:
                load[a] += n
        picks = self._select_hosts(self.datanodes, live_data, k, load)
        leader = topology.pick_leader(picks, intra_load)
        if intra_load is not None:
            for a in picks:
                intra_load[a] = intra_load.get(a, 0) + 1
            intra_load[leader] = intra_load.get(leader, 0) + 1
        return {"dp_id": dp_id, "replicas": picks, "leader": leader}

    def client_view(self, name: str) -> dict:
        with self._lock:
            vol = self.volumes.get(name)
            if vol is None:
                raise MasterError(f"no volume {name!r}")
            # packet-plane discovery: every replica's binary-protocol
            # address (when the node registered one) rides the view
            packet_addrs = {a: i["packet_addr"]
                            for a, i in self.datanodes.items()
                            if i.get("packet_addr")}
            meta_packet_addrs = {a: i["packet_addr"]
                                 for a, i in self.metanodes.items()
                                 if i.get("packet_addr")}
            meta_read_addrs = {a: i["read_addr"]
                               for a, i in self.metanodes.items()
                               if i.get("read_addr")}
            data_read_addrs = {a: i["read_addr"]
                               for a, i in self.datanodes.items()
                               if i.get("read_addr")}
            return {"name": name, "mps": [dict(m) for m in vol["mps"]],
                    "dps": [dict(d) for d in vol["dps"]],
                    # single watermark: every committed range-table
                    # change (split/merge) bumps it exactly once, so
                    # clients refresh on compare instead of len()
                    "mp_version": vol.get("mp_version", 0),
                    "quotas": dict(vol.get("quotas", {})),
                    "packet_addrs": packet_addrs,
                    "meta_packet_addrs": meta_packet_addrs,
                    "meta_read_addrs": meta_read_addrs,
                    "data_read_addrs": data_read_addrs}

    def _meta_load(self) -> dict[str, int]:
        """Replica count per metanode across all volumes (placement load)."""
        load: dict[str, int] = {}
        for v in self.volumes.values():
            for mp in v["mps"]:
                for a in mp.get("addrs") or [mp["addr"]]:
                    load[a] = load.get(a, 0) + 1
        return load

    def _dp_load(self) -> dict[str, int]:
        """dp replica count per datanode (placement load; caller holds
        _lock)."""
        load: dict[str, int] = {}
        for v in self.volumes.values():
            for dp in v["dps"]:
                for r in dp["replicas"]:
                    load[r] = load.get(r, 0) + 1
        return load

    # ---------------- meta-partition split ----------------
    def _apply_add_mp(self, name: str, mp: dict) -> None:
        self.volumes[name]["mps"].append(mp)
        self._next_pid = max(self._next_pid, mp["pid"] + 1)

    def check_meta_partitions(self) -> list[tuple[str, int]]:
        """Split sweep (docs/source/design/master.md:23-34): when a
        volume's LAST meta partition passes the fill threshold, append a
        fresh partition for the next inode range. Existing partitions
        and in-flight IO are untouched — clients pick up the new one on
        their next view refresh. Returns (volume, new_pid) actions."""
        with self._lock:
            vols = {n: [dict(m) for m in v["mps"]]
                    for n, v in self.volumes.items()}
        actions = []
        for name, mps in vols.items():
            if not mps:
                continue
            last = max(mps, key=lambda m: m["end"])
            try:
                meta, _ = rpc.call_replicas(
                    self.nodes, last.get("addrs") or [last["addr"]],
                    "mp_fill", {"pid": last["pid"]}, deadline=5.0)
            except Exception:
                continue  # retried next sweep
            span = last["end"] - last["start"]
            if span <= 0 or (meta["next_ino"] - last["start"]) / span \
                    < self.MP_SPLIT_THRESHOLD:
                continue
            try:
                # after_end pins the observed state: a concurrent sweep
                # that already split makes this a no-op, not a second
                # redundant partition
                new_pid = self.split_meta_partition(name,
                                                    after_end=last["end"])
            except (MasterError, rpc.RpcError):
                continue  # one volume's failure must not end the sweep
            if new_pid is not None:
                actions.append((name, new_pid))
        return actions

    def split_meta_partition(self, name: str,
                             after_end: int | None = None) -> int | None:
        with self._propose_lock:
            with self._lock:
                vol = self.volumes.get(name)
                if vol is None:
                    raise MasterError(f"no volume {name!r}")
                if not vol["mps"]:
                    return None
                live_meta = self._live(self.metanodes)
                if not live_meta:
                    return None
                start = max(m["end"] for m in vol["mps"])
                if after_end is not None and start != after_end:
                    return None  # someone already split past our snapshot
                end = start + self.INO_RANGE
                pid = self._next_pid
                self._next_pid += 1
                meta_load = self._meta_load()
                k = min(self.replicas, len(live_meta))
                addrs = self._select_hosts(self.metanodes, live_meta, k,
                                           meta_load)
            created = []
            try:
                for a in addrs:
                    self.nodes.get_direct(a).call(
                        "create_partition",
                        {"pid": pid, "start": start, "end": end,
                         "peers": addrs})
                    created.append(a)
            except Exception as e:
                # roll back best-effort so failed splits don't leak
                # orphan partitions on the nodes that did succeed
                for a in created:
                    try:
                        self.nodes.get_direct(a).call("drop_partition",
                                                      {"pid": pid})
                    except Exception:
                        pass
                raise MasterError(f"split of {name!r} failed: {e}") from e
            self._commit({"op": "add_mp", "name": name, "mp": {
                "pid": pid, "start": start, "end": end,
                "addr": addrs[0], "addrs": addrs}})
            return pid

    # ---------------- failure handling ----------------
    def check_replicas(self) -> list[tuple[int, str, str]]:
        """Decommission dead datanodes: for every dp with a dead replica,
        pick a live substitute, resync its extents from a healthy peer,
        and repoint the replica set. Returns (dp_id, dead, new) actions.

        The (slow) extent copy runs OUTSIDE the master lock — heartbeats
        must keep landing while a rebuild streams data, or healthy nodes
        would go stale and cascade."""
        with self._lock:
            live = set(self._live(self.datanodes))
            load = self._dp_load()
            plans = []
            for vname, vol in self.volumes.items():
                for dp in vol["dps"]:
                    dead = [a for a in dp["replicas"] if a not in live]
                    for dead_addr in dead:
                        healthy = [a for a in dp["replicas"] if a in live]
                        cands = [a for a in live
                                 if a not in dp["replicas"]] or (
                                     list(live) if self.allow_single_node else []
                                 )
                        if not healthy or not cands:
                            continue
                        # rebuild into the dead replica's AZ when it has
                        # capacity, so a node loss doesn't erode the
                        # dp's one-per-AZ footprint
                        new = topology.pick_destination(
                            self.datanodes, cands, healthy,
                            prefer_az=topology.az_of(
                                self.datanodes.get(dead_addr) or {}),
                            load=load)
                        load[new] = load.get(new, 0) + 1
                        plans.append((vname, dict(dp), dead_addr, new,
                                      healthy[0]))
        # one sweep covers BOTH failure domains: dead nodes above,
        # broken disks below — existing periodic check_replicas callers
        # must pick up the disk manager without new wiring
        return self._execute_rebuilds(plans) + self.check_broken_disks()

    # ---------------- disk manager (master/disk_manager.go role) --------
    def offline_disk(self, addr: str, path: str) -> list:
        """Migrate every dp whose replica on `addr` lives on `path` to
        other nodes — the node itself stays in service for its healthy
        disks. Driven by the operator (disk offline) or the sweep when
        a heartbeat disk report flags the disk broken."""
        with self._lock:
            info = self.datanodes.get(addr)
            if info is None:
                raise MasterError(f"unknown datanode {addr}")
            cached = (info.get("disks") or {}).get(path)
        # prefer a LIVE disk report: partitions placed since the last
        # heartbeat must not be silently left behind on the dying disk
        report = cached
        try:
            live = self.nodes.get(addr).call("disk_report", {})[0]["disks"]
            report = live.get(path, cached)
        except rpc.RpcError:
            pass  # unreachable node: the cached report is the best view
        if report is None:
            raise MasterError(f"{addr} reports no disk {path}")
        dp_ids = set(report.get("dps") or [])
        # mark the disk on the NODE first: placement must stop preferring
        # the freshly emptied disk, and the next heartbeat's report keeps
        # the broken flag authoritative across master restarts
        try:
            self.nodes.get(addr).call("mark_disk_broken", {"path": path})
        except rpc.RpcError:
            pass  # node unreachable: migration below still proceeds
        return self._migrate_dps_off(addr, dp_ids)

    def _migrate_dps_off(self, addr: str, dp_ids: set) -> list:
        """Rebuild the `addr` replica of each dp in dp_ids onto another
        live node (the per-dp half of decommission; same resync path).
        The node is ALIVE here, so the superseded replica is dropped
        from it — a stale live replica would keep serving bytes that no
        longer receive writes."""
        with self._lock:
            live = set(self._live(self.datanodes))
            load = self._dp_load()
            plans = []
            for vname, vol in self.volumes.items():
                for dp in vol["dps"]:
                    if dp["dp_id"] not in dp_ids or addr not in dp["replicas"]:
                        continue
                    healthy = [a for a in dp["replicas"]
                               if a != addr and a in live]
                    cands = [a for a in live
                             if a not in dp["replicas"]] or (
                                 [a for a in live if a != addr]
                                 if self.allow_single_node else [])
                    if not healthy or not cands:
                        continue
                    # the drained node stays in its AZ: prefer keeping
                    # the migrated replica in that same AZ
                    new = topology.pick_destination(
                        self.datanodes, cands, healthy,
                        prefer_az=topology.az_of(
                            self.datanodes.get(addr) or {}),
                        load=load)
                    load[new] = load.get(new, 0) + 1
                    plans.append((vname, dict(dp), addr, new,
                                  healthy[0]))
        actions = self._execute_rebuilds(plans)
        for dp_id, dead, _new in actions:
            try:
                self.nodes.get(dead).call("drop_partition", {"dp_id": dp_id})
            except rpc.RpcError:
                pass  # node went away mid-migration: nothing to drop
        return actions

    def _execute_rebuilds(self, plans: list) -> list:
        """Shared rebuild driver (check_replicas + the disk manager):
        re-checks each plan against the LIVE dp entry — an earlier
        rebuild in the same sweep may have repointed it, and working
        from the planning snapshot would commit a stale replica list."""
        actions = []
        for vname, dp_snapshot, dead_addr, new_addr, src in plans:
            with self._lock:
                dp = next((d for d in self.volumes[vname]["dps"]
                           if d["dp_id"] == dp_snapshot["dp_id"]), None)
                if dp is None or dead_addr not in dp["replicas"]:
                    continue  # already handled
                dp = dict(dp)
            try:
                self._rebuild_replica(vname, dp, dead_addr, new_addr, src)
                actions.append((dp["dp_id"], dead_addr, new_addr))
            except rpc.RpcError:
                continue  # retried on the next sweep
        return actions

    def check_broken_disks(self) -> list:
        """Sweep half of the disk manager: every disk a heartbeat
        report marked broken gets its partitions migrated."""
        with self._lock:
            broken = [(addr, path, set(rep.get("dps") or []))
                      for addr, info in self.datanodes.items()
                      for path, rep in (info.get("disks") or {}).items()
                      if rep.get("broken")]
        actions = []
        for addr, path, dp_ids in broken:
            actions += self._migrate_dps_off(addr, dp_ids)
        return actions

    # ---------------- misplaced-replica sweep ----------------
    def misplacement_view(self) -> dict:
        """Score every dp against the one-per-AZ contract and publish
        the `cubefs_fs_placement_misplaced` gauge (0 == clean)."""
        with self._lock:
            view = topology.cluster_misplacement(self.datanodes,
                                                 self.volumes)
        metrics.fs_placement_misplaced.set(view["misplaced"])
        return view

    def sweep_misplaced(self, max_moves: int = 1) -> list:
        """Rate-limited sweep: migrate at most `max_moves` colocated dp
        replicas per call toward one-per-AZ. Rebuilds ride the standard
        resync path; the superseded replica (its node is ALIVE — this
        is a placement fix, not a failure) is dropped afterwards.
        Returns (dp_id, old, new) actions."""
        with self._lock:
            live = set(self._live(self.datanodes))
            load = self._dp_load()
            work = topology.cluster_misplacement(self.datanodes,
                                                 self.volumes)["dps"]
            plans = []
            moved = 0
            for vname, dp_id, excess in work:
                if moved >= max_moves:
                    break
                dp = next((d for d in self.volumes[vname]["dps"]
                           if d["dp_id"] == dp_id), None)
                if dp is None:
                    continue
                for old in excess:
                    if moved >= max_moves or old not in dp["replicas"]:
                        break
                    survivors = [a for a in dp["replicas"] if a != old]
                    healthy = [a for a in survivors if a in live]
                    cands = [a for a in live if a not in dp["replicas"]]
                    if not healthy or not cands:
                        continue
                    new = topology.pick_destination(
                        self.datanodes, cands, survivors, load=load)
                    moved_to = [new if a == old else a
                                for a in dp["replicas"]]
                    # only move when the destination actually improves
                    # the AZ spread — a full cluster can't, so the sweep
                    # must not churn replicas for nothing
                    if len(topology.replica_misplacement(
                            self.datanodes, moved_to)) >= len(excess):
                        continue
                    load[new] = load.get(new, 0) + 1
                    plans.append((vname, dict(dp), old, new, healthy[0]))
                    moved += 1
        actions = self._execute_rebuilds(plans)
        for dp_id, old, _new in actions:
            try:
                self.nodes.get(old).call("drop_partition", {"dp_id": dp_id})
            except rpc.RpcError:
                pass  # stale replica cleaned up on a later sweep
        self.misplacement_view()  # refresh the gauge post-move
        return actions

    def _rebuild_replica(self, vname: str, dp: dict, dead: str, new: str,
                         src: str) -> None:
        peers = [new if a == dead else a for a in dp["replicas"]]
        leader = new if dp["leader"] == dead else dp["leader"]
        self.nodes.get(new).call(
            "create_partition", {"dp_id": dp["dp_id"], "peers": peers,
                                 "leader": leader}
        )
        # copy every extent the healthy source actually has
        src_client = self.nodes.get(src)
        extents = src_client.call("list_extents", {"dp_id": dp["dp_id"]})[0]["extents"]
        for eid in extents:
            self.nodes.get(new).call(
                "sync_extent_from",
                {"dp_id": dp["dp_id"], "extent_id": eid, "src_addr": src},
            )
        # repoint every live replica's peer set, then install under lock
        for addr in peers:
            try:
                self.nodes.get(addr).call(
                    "create_partition",
                    {"dp_id": dp["dp_id"], "peers": peers, "leader": leader},
                )
            except rpc.RpcError:
                pass
        self._commit({"op": "update_dp", "name": vname, "dp_id": dp["dp_id"],
                      "replicas": peers, "leader": leader})

    # ---------------- RPC surface ----------------
    def rpc_register(self, args, body):
        zone = args.get("zone", "default")
        if args["kind"] == "data":
            self.register_datanode(args["addr"], zone,
                                   packet_addr=args.get("packet_addr"),
                                   disks=args.get("disks"),
                                   read_addr=args.get("read_addr"),
                                   rack=args.get("rack"))
        else:
            self.register_metanode(args["addr"], zone,
                                   packet_addr=args.get("packet_addr"),
                                   read_addr=args.get("read_addr"),
                                   rack=args.get("rack"))
        return {}

    def rpc_heartbeat(self, args, body):
        self.heartbeat(args["addr"], args["kind"], args.get("zone"),
                       packet_addr=args.get("packet_addr"),
                       read_addr=args.get("read_addr"),
                       disks=args.get("disks"),
                       rack=args.get("rack"))
        return {}

    def rpc_offline_disk(self, args, body):
        self._leader_gate()
        try:
            actions = self.offline_disk(args["addr"], args["path"])
        except MasterError as e:
            raise rpc.RpcError(404, str(e)) from None
        return {"actions": actions}

    def rpc_check_broken_disks(self, args, body):
        self._leader_gate()
        return {"actions": self.check_broken_disks()}

    def rpc_misplacement(self, args, body):
        view = self.misplacement_view()
        return {"misplaced": view["misplaced"],
                "dps": [list(t) for t in view["dps"]]}

    def rpc_sweep_misplaced(self, args, body):
        self._leader_gate()
        actions = self.sweep_misplaced(int(args.get("max_moves", 1)))
        return {"actions": actions,
                "misplaced": self.misplacement_view()["misplaced"]}

    def rpc_node_list(self, args, body):
        return self.node_list()

    def rpc_decommission_datanode(self, args, body):
        self._leader_gate()
        try:
            actions = self.decommission_datanode(args["addr"])
        except MasterError as e:
            raise rpc.RpcError(404, str(e)) from None
        return {"actions": actions}

    def rpc_check_meta_partitions(self, args, body):
        self._leader_gate()
        return {"actions": self.check_meta_partitions()}

    def rpc_split_meta_partition(self, args, body):
        self._leader_gate()
        try:
            return {"pid": self.split_meta_partition(args["name"])}
        except MasterError as e:
            raise rpc.RpcError(404, str(e)) from None

    # ------------- elastic metadata plane (fs/split.py) -------------
    def split_engine(self):
        """Lazy SplitEngine: masters that never migrate pay nothing,
        and tests reach the same instance the RPCs drive."""
        with self._lock:
            if self._split_engine is None:
                from .split import SplitEngine
                self._split_engine = SplitEngine(self)
            return self._split_engine

    def rpc_meta_split(self, args, body):
        self._leader_gate()
        try:
            return self.split_engine().split(
                args["name"], pid=args.get("pid"),
                split_ino=args.get("split_ino"))
        except MasterError as e:
            raise rpc.RpcError(404, str(e)) from None

    def rpc_meta_merge(self, args, body):
        self._leader_gate()
        try:
            return self.split_engine().merge(
                args["name"], donor_pid=args.get("donor_pid"),
                absorber_pid=args.get("absorber_pid"))
        except MasterError as e:
            raise rpc.RpcError(404, str(e)) from None

    def rpc_meta_balance(self, args, body):
        self._leader_gate()
        return self.split_engine().balance(
            int(args.get("max_moves", 1)),
            auto=bool(args.get("auto", False)))

    def rpc_meta_status(self, args, body):
        self._leader_gate()
        return self.split_engine().status(args.get("name"))

    def rpc_create_volume(self, args, body):
        self._leader_gate()
        return {"volume": self.create_volume(
            args["name"], args.get("mp_count", 3), args.get("dp_count", 4)
        )}

    def rpc_client_view(self, args, body):
        self._leader_gate()
        try:
            return {"volume": self.client_view(args["name"])}
        except MasterError as e:
            raise rpc.RpcError(404, str(e)) from None

    def rpc_dp_view(self, args, body):
        """Data partitions keyed by dp_id — all volumes by default, or
        one volume when args carries "name" (the CLI's dp view). The
        metanode free scan resolves freed extents' replicas from the
        unfiltered view (server-side deletes, partition_free_list.go)."""
        self._leader_gate()
        name = args.get("name")
        with self._lock:
            if name is not None and name not in self.volumes:
                raise rpc.RpcError(404, f"no volume {name!r}")
            vols = ([self.volumes[name]] if name is not None
                    else self.volumes.values())
            dps = {}
            for v in vols:
                for dp in v["dps"]:
                    dps[str(dp["dp_id"])] = {
                        "dp_id": dp["dp_id"], "replicas": dp["replicas"]}
            return {"dps": dps}

    def rpc_check_replica_health(self, args, body):
        """Alias of check_replicas (which sweeps both failure domains:
        dead nodes AND broken disks)."""
        self._leader_gate()
        return {"actions": self.check_replicas()}

    def rpc_check_replicas(self, args, body):
        # a deposed leader must not run datanode-mutating rebuilds
        self._leader_gate()
        return {"actions": self.check_replicas()}

    def rpc_set_quota(self, args, body):
        self._leader_gate()
        try:
            qid = self.set_quota(args["name"], args["dir_ino"],
                                 args.get("max_bytes", 0),
                                 args.get("max_files", 0))
        except MasterError as e:
            raise rpc.RpcError(404, str(e)) from None
        return {"qid": qid}

    def rpc_delete_quota(self, args, body):
        self._leader_gate()
        try:
            self.delete_quota(args["name"], args["qid"])
        except MasterError as e:
            raise rpc.RpcError(404, str(e)) from None
        return {}

    def rpc_list_quotas(self, args, body):
        try:
            return {"quotas": self.list_quotas(args["name"])}
        except MasterError as e:
            raise rpc.RpcError(404, str(e)) from None

    def rpc_set_vol_capacity(self, args, body):
        self._leader_gate()
        try:
            self.set_vol_capacity(args["name"], args["capacity"])
        except MasterError as e:
            raise rpc.RpcError(404, str(e)) from None
        return {}

    def rpc_enforce_quotas(self, args, body):
        self._leader_gate()
        return {"summary": self.enforce_quotas()}

    def rpc_stat(self, args, body):
        with self._lock:
            return {"datanodes": len(self.datanodes),
                    "metanodes": len(self.metanodes),
                    "volumes": sorted(self.volumes)}
