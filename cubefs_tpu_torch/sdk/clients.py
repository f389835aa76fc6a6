"""Typed RPC clients for every service surface.

The port's copy of ``cubefs_tpu/sdk/clients.py``. Role parity:
sdk/master (admin client, sdk/master/client.go),
blobstore/api/{access,clustermgr,scheduler} (typed clients per
service). Each wraps the framework's rpc.Client (in-process or HTTP,
421-leader-redirect aware) with concrete methods, so consumers — the
console, the metanode's range fetch, the geo gateway's snapshot pull,
the flash read tier, tools — never hand-roll method-name strings.
"""

from __future__ import annotations

import uuid

from ..utils import rpc


class _Base:
    def __init__(self, target):
        """target: an address string, an RpcServer, or a live service
        object (in-process)."""
        self._c = target if isinstance(target, rpc.Client) else rpc.Client(target)

    def _call(self, method: str, args: dict | None = None,
              body: bytes = b"", timeout: float = 30.0):
        return self._c.call(method, args, body, timeout)


class MasterClient(_Base):
    """FS-plane resource manager admin surface (sdk/master analog)."""

    def create_volume(self, name: str, mp_count: int = 3,
                      dp_count: int = 4) -> dict:
        return self._call("create_volume", {
            "name": name, "mp_count": mp_count, "dp_count": dp_count,
        })[0]["volume"]

    def client_view(self, name: str) -> dict:
        return self._call("client_view", {"name": name})[0]["volume"]

    def stat(self) -> dict:
        return self._call("stat")[0]

    def node_list(self) -> dict:
        return self._call("node_list")[0]

    def decommission_datanode(self, addr: str) -> list:
        return self._call("decommission_datanode",
                          {"addr": addr})[0]["actions"]

    def check_replicas(self) -> list:
        return self._call("check_replicas")[0]["actions"]

    # quotas
    def set_vol_capacity(self, name: str, capacity: int) -> None:
        self._call("set_vol_capacity", {"name": name, "capacity": capacity})

    def set_quota(self, name: str, dir_ino: int, max_bytes: int = 0,
                  max_files: int = 0) -> int:
        return self._call("set_quota", {
            "name": name, "dir_ino": dir_ino, "max_bytes": max_bytes,
            "max_files": max_files})[0]["qid"]

    def delete_quota(self, name: str, qid: int) -> None:
        self._call("delete_quota", {"name": name, "qid": qid})

    def list_quotas(self, name: str) -> dict:
        return self._call("list_quotas", {"name": name})[0]["quotas"]

    def enforce_quotas(self) -> dict:
        return self._call("enforce_quotas")[0]["summary"]

    # meta partitions
    def split_meta_partition(self, name: str) -> int | None:
        return self._call("split_meta_partition", {"name": name})[0]["pid"]

    def check_meta_partitions(self) -> list:
        return self._call("check_meta_partitions")[0]["actions"]

    # elastic metadata plane (fs/split.py): live inode-range migration
    def meta_split(self, name: str, pid: int | None = None,
                   split_ino: int | None = None) -> dict:
        args: dict = {"name": name}
        if pid is not None:
            args["pid"] = pid
        if split_ino is not None:
            args["split_ino"] = split_ino
        return self._call("meta_split", args)[0]

    def meta_merge(self, name: str, donor_pid: int | None = None,
                   absorber_pid: int | None = None) -> dict:
        args: dict = {"name": name}
        if donor_pid is not None:
            args["donor_pid"] = donor_pid
        if absorber_pid is not None:
            args["absorber_pid"] = absorber_pid
        return self._call("meta_merge", args)[0]

    def meta_balance(self, max_moves: int = 1, auto: bool = False) -> dict:
        return self._call("meta_balance",
                          {"max_moves": max_moves, "auto": auto})[0]

    def meta_status(self, name: str | None = None) -> dict:
        args = {"name": name} if name is not None else {}
        return self._call("meta_status", args)[0]

    # users (master/user.go surface)
    def create_user(self, user_id: str) -> dict:
        return self._call("create_user", {"user_id": user_id})[0]

    def delete_user(self, ak: str) -> None:
        self._call("delete_user", {"ak": ak})

    def grant(self, ak: str, volume: str, perm: str = "rw") -> None:
        self._call("grant", {"ak": ak, "volume": volume, "perm": perm})

    def revoke(self, ak: str, volume: str) -> None:
        self._call("revoke", {"ak": ak, "volume": volume})

    def list_users(self) -> dict:
        return self._call("list_users")[0]["users"]

    def register(self, kind: str, addr: str, zone: str = "default",
                 packet_addr: str | None = None,
                 rack: str | None = None) -> None:
        args = {"kind": kind, "addr": addr, "zone": zone}
        if rack:
            args["rack"] = rack
        if packet_addr:
            args["packet_addr"] = packet_addr
        self._call("register", args)

    def heartbeat(self, kind: str, addr: str, zone: str | None = None,
                  packet_addr: str | None = None,
                  rack: str | None = None) -> None:
        args = {"kind": kind, "addr": addr}
        if zone:
            args["zone"] = zone
        if rack:
            args["rack"] = rack
        if packet_addr:
            args["packet_addr"] = packet_addr
        self._call("heartbeat", args)

    def topology_tree(self) -> dict:
        return self._call("topology_tree")[0]

    def misplacement(self) -> dict:
        return self._call("misplacement")[0]

    def sweep_misplaced(self, max_moves: int = 1) -> dict:
        return self._call("sweep_misplaced", {"max_moves": max_moves})[0]


class SchedulerClient(_Base):
    """Background-task brain surface (api/scheduler analog)."""

    def acquire_task(self, worker_id: str) -> dict | None:
        return self._call("acquire_task",
                          {"worker_id": worker_id})[0].get("task")

    def renew_task(self, task_id: str, worker_id: str) -> bool:
        return self._call("renew_task", {
            "task_id": task_id, "worker_id": worker_id})[0]["ok"]

    def complete_task(self, task_id: str, worker_id: str) -> None:
        self._call("complete_task", {"task_id": task_id,
                                     "worker_id": worker_id})

    def fail_task(self, task_id: str, worker_id: str,
                  error: str = "") -> None:
        self._call("fail_task", {"task_id": task_id,
                                 "worker_id": worker_id, "error": error})

    def stats(self) -> dict:
        return self._call("stats")[0]

    def task_switch(self, action: str = "list",
                    kind: str | None = None) -> dict:
        args: dict = {"action": action}
        if kind:
            args["kind"] = kind
        return self._call("task_switch", args)[0]["switches"]


class ClusterMgrClient(_Base):
    """EC-plane metadata center surface (api/clustermgr analog)."""

    def stat(self) -> dict:
        return self._call("stat")[0]

    def register_disk(self, node_addr: str, path: str) -> int:
        return self._call("register_disk", {
            "node_addr": node_addr, "path": path,
            "op_id": uuid.uuid4().hex})[0]["disk_id"]

    def alloc_volume(self, codemode: int) -> dict:
        return self._call("alloc_volume",
                          {"codemode": codemode,
                           "op_id": uuid.uuid4().hex})[0]["volume"]

    def get_volume(self, vid: int) -> dict:
        return self._call("get_volume", {"vid": vid})[0]["volume"]

    def alloc_bids(self, count: int) -> dict:
        return self._call("alloc_bids", {"count": count,
                                         "op_id": uuid.uuid4().hex})[0]

    def get_service(self, name: str) -> dict:
        return self._call("get_service", {"name": name})[0]

    def register_service(self, name: str, addr: str) -> None:
        self._call("register_service", {"name": name, "addr": addr})

    # configmgr surface (clustermgr/configmgr analog)
    def set_config(self, key: str, value: str) -> None:
        self._call("set_config", {"key": key, "value": value})

    def get_config(self, key: str) -> str | None:
        return self._call("get_config", {"key": key})[0]["value"]

    def delete_config(self, key: str) -> None:
        self._call("delete_config", {"key": key})

    def list_config(self) -> dict:
        return self._call("list_config")[0]["config"]

    # kvmgr surface (clustermgr/kvmgr analog)
    def kv_set(self, key: str, value: str) -> None:
        self._call("kv_set", {"key": key, "value": value})

    def kv_get(self, key: str) -> str | None:
        return self._call("kv_get", {"key": key})[0]["value"]

    def kv_delete(self, key: str) -> None:
        self._call("kv_delete", {"key": key})

    def kv_list(self, prefix: str = "", marker: str = "",
                count: int = 100) -> tuple[list, str]:
        out = self._call("kv_list", {"prefix": prefix, "marker": marker,
                                     "count": count})[0]
        return out["items"], out["marker"]

    # scopemgr surface (clustermgr/scopemgr analog)
    def alloc_scope(self, name: str, count: int = 1) -> int:
        return self._call("alloc_scope",
                          {"name": name, "count": count,
                           "op_id": uuid.uuid4().hex})[0]["start"]


class MetaNodeClient(_Base):
    """Metanode mutation surface (sdk/meta analog, single node): typed
    submit / submit_batch against one metanode. op_ids are stamped
    client-side so retries after a lost response stay exactly-once —
    the same discipline as MetaWrapper, without the partition-routing
    layer (tools and tests that target ONE known partition use this)."""

    def submit(self, pid: int, record: dict) -> dict:
        rec = dict(record)
        rec.setdefault("op_id", uuid.uuid4().hex)
        return self._call("submit", {"pid": pid, "record": rec})[0]["result"]

    def submit_batch(self, pid: int, records: list[dict]) -> list:
        """Ship many mutations as ONE RPC (the wire shape the client
        fan-out coalescer emits). Returns per-record [result, None] |
        [None, [errno, msg]] pairs in submission order."""
        recs = []
        for r in records:
            r = dict(r)
            r.setdefault("op_id", uuid.uuid4().hex)
            recs.append(r)
        return self._call("submit_batch",
                          {"pid": pid, "records": recs})[0]["results"]

    def inode_get(self, pid: int, ino: int) -> dict:
        return self._call("inode_get", {"pid": pid, "ino": ino})[0]["inode"]

    def stat(self) -> dict:
        return self._call("stat")[0]


class GeoClient(_Base):
    """Geo-replication gateway surface (fs/georepl.GeoGateway): status
    for the CLI views, op_id-stamped transitions for the fenced
    promote/failback runbook — the stamp is what makes a retried
    `promote` replay its recorded outcome instead of minting a second
    fencing epoch."""

    def status(self) -> dict:
        return self._call("geo_status")[0]

    def transition(self, op: str, op_id: str | None = None) -> dict:
        return self._call("geo_transition", {
            "op": op, "op_id": op_id or uuid.uuid4().hex})[0]

    def fence(self, op_id: str | None = None) -> dict:
        return self.transition("fence", op_id)

    def promote(self, op_id: str | None = None) -> dict:
        return self.transition("promote", op_id)

    def demote(self, op_id: str | None = None) -> dict:
        return self.transition("demote", op_id)

    def failback_sync(self, op_id: str | None = None) -> dict:
        return self.transition("failback_sync", op_id)

    def resume_following(self, op_id: str | None = None) -> dict:
        return self.transition("resume_following", op_id)


class WireClient:
    """Packet-plane client surface (sdk/data streamer analog): the
    sanctioned home for raw binary-plane connections outside the fs
    client internals (lint family CFX fences `PacketClient(...)`
    construction to here and the fs/client plumbing).

    One persistent mux connection per target; `window` requests ride it
    in flight (CUBEFS_PKT_WINDOW by default, 1 when the mux door is
    closed so the legacy serial path keeps its shape). `submit_many`
    is the windowed meta-mutation pump loadgen's wire mode drives."""

    def __init__(self, addr: str, timeout: float = 30.0,
                 window: int | None = None):
        from ..utils import packet as pkt

        self._pkt = pkt
        self._c = pkt.PacketClient(addr, timeout=timeout)
        self.window = (window if window is not None
                       else (pkt.window_size() if self._c.mux else 1))

    def call(self, opcode: int, **kw):
        return self._c.call(opcode, **kw)

    def call_async(self, opcode: int, **kw):
        """Submit one request, returning its PacketFuture — the open-
        loop surface for callers that manage their own in-flight set
        (loadgen's wire workers) instead of the `pipeline` window."""
        return self._c.call_async(opcode, **kw)

    def ping(self) -> dict:
        args, _ = self._c.call(self._pkt.OP_PING)
        return args

    def pipeline(self, reqs: list[dict]) -> list:
        """Issue `reqs` (kwargs for PacketClient.call) keeping up to
        `window` in flight on the shared connection. Returns per-request
        (args, payload) | Exception in submission order — one failed
        stream does not abort its neighbours."""
        out: list = [None] * len(reqs)
        futs: list[tuple[int, object]] = []

        def reap(slot: int, fut) -> None:
            try:
                out[slot] = fut.result()
            except Exception as e:  # caller triages per-slot
                out[slot] = e

        for i, req in enumerate(reqs):
            futs.append((i, self._c.call_async(**req)))
            if len(futs) >= self.window:
                reap(*futs.pop(0))
        while futs:
            reap(*futs.pop(0))
        return out

    def submit_batched(self, pid: int, records: list[dict],
                       batch: int = 64) -> list:
        """The saturation pump: records grouped into submit_batch
        frames, `window` batches in flight on the shared connection —
        batching amortizes the per-op wire cost, the mux window hides
        the round trip. Returns per-record [result, None] |
        [None, [errno, msg]] pairs in submission order."""
        stamped = []
        for r in records:
            r = dict(r)
            r.setdefault("op_id", uuid.uuid4().hex)
            stamped.append(r)
        reqs = [{"opcode": self._pkt.OP_META_SUBMIT_BATCH,
                 "args": {"pid": pid, "records": stamped[i:i + batch]},
                 "idempotent": True}
                for i in range(0, len(stamped), batch)]
        res: list = []
        for got in self.pipeline(reqs):
            if isinstance(got, Exception):
                raise got
            res.extend(got[0]["results"])
        return res

    def submit_many(self, pid: int, records: list[dict]) -> list:
        """Pipeline many single-record meta mutations over one mux
        connection. op_ids are stamped client-side (MetaNodeClient's
        exactly-once discipline), which is what makes idempotent=True
        — and therefore reconnect-retry — safe for these mutations."""
        reqs = []
        for r in records:
            r = dict(r)
            r.setdefault("op_id", uuid.uuid4().hex)
            reqs.append({"opcode": self._pkt.OP_META_SUBMIT,
                         "args": {"pid": pid, "record": r},
                         "idempotent": True})
        res = []
        for got in self.pipeline(reqs):
            if isinstance(got, Exception):
                raise got
            res.append(got[0]["result"])
        return res

    def close(self) -> None:
        self._c.close()


class AuthClient(_Base):
    """Ticket service surface (sdk/auth/api.go analog): key
    registration and ticket issue against a running authnode role. The
    proof is computed client-side from the registered key, so the
    secret never travels on the ticket path."""

    def register(self, id_: str) -> bytes:
        import base64

        return base64.b64decode(self._call("register", {"id": id_})[0]["key"])

    def get_ticket(self, client_id: str, service_id: str,
                   client_key: bytes) -> dict:
        from ..fs.authnode import AuthNode

        proof = AuthNode.client_proof(client_id, service_id, client_key)
        return self._call("get_ticket", {
            "client_id": client_id, "service_id": service_id,
            "proof": proof})[0]

    # AK/SK user registry surface (UserStore role)
    def create_user(self, user_id: str) -> dict:
        return self._call("create_user", {"user_id": user_id})[0]

    def grant(self, ak: str, volume: str, perm: str = "rw") -> None:
        self._call("grant", {"ak": ak, "volume": volume, "perm": perm})

    def secret_for(self, ak: str) -> str | None:
        return self._call("secret_for", {"ak": ak})[0]["sk"]


class FlashClient(_Base):
    """Remote-cache engine surface (sdk/remotecache analog): one
    flashnode's cache ops."""

    def cache_get(self, key: str) -> bytes:
        return self._call("cache_get", {"key": key})[1]

    def cache_put(self, key: str, data: bytes,
                  path: str | None = None) -> None:
        args = {"key": key}
        if path is not None:
            args["path"] = path  # request family, for burn-aware eviction
        self._call("cache_put", args, data)

    def cache_delete(self, key: str) -> bool:
        return self._call("cache_delete", {"key": key})[0]["deleted"]

    def stats(self) -> dict:
        return self._call("stats")[0]


class FlashGroupClient(_Base):
    """FlashGroupManager admin surface (flashgroupmanager role)."""

    def register_group(self, group_id: int, addrs: list[str],
                       az: str | None = None) -> None:
        args = {"group_id": group_id, "addrs": addrs}
        if az:
            args["az"] = az
        self._call("register_group", args)

    def remove_group(self, group_id: int) -> None:
        self._call("remove_group", {"group_id": group_id})

    def set_group_status(self, group_id: int, status: str) -> None:
        self._call("set_group_status", {"group_id": group_id,
                                        "status": status})

    def flashnode_heartbeat(self, addr: str) -> None:
        self._call("flashnode_heartbeat", {"addr": addr})

    def ring(self) -> dict:
        return self._call("ring")[0]


class ConsoleClient:
    """Console management surface (sdk/graphql analog): AK/SK login +
    GraphQL queries/mutations over plain HTTP (the console is not an
    RpcServer — it speaks browser-shaped JSON)."""

    def __init__(self, addr: str):
        self.addr = addr
        self._token: str | None = None

    def _post(self, path: str, obj: dict) -> dict:
        import json as _json
        import urllib.error
        import urllib.request

        req = urllib.request.Request(
            f"http://{self.addr}{path}", data=_json.dumps(obj).encode(),
            method="POST",
            headers={"Content-Type": "application/json",
                     **({"X-Console-Token": self._token}
                        if self._token else {})})
        try:
            with urllib.request.urlopen(req, timeout=15) as r:
                return _json.loads(r.read())
        except urllib.error.HTTPError as e:
            body = _json.loads(e.read() or b"{}")
            raise rpc.RpcError(e.code, body.get("error", str(e))) from None

    def login(self, access_key: str, secret_key: str) -> None:
        self._token = self._post("/api/login", {
            "access_key": access_key, "secret_key": secret_key})["token"]

    def graphql(self, query: str, variables: dict | None = None):
        out = self._post("/api/graphql", {"query": query,
                                          "variables": variables or {}})
        if "errors" in out:
            raise rpc.RpcError(400, "; ".join(out["errors"]))
        return out["data"]

    # convenience wrappers over the mutation/query fields
    def users(self) -> dict:
        return self.graphql("query { users }")["users"]

    def create_user(self, user_id: str) -> dict:
        return self.graphql("mutation { createUser(userId: $u) "
                            "{ access_key secret_key user_id } }",
                            {"u": user_id})["createUser"]

    def grant(self, ak: str, volume: str, perm: str = "rw") -> None:
        self.graphql("mutation { grant(ak: $a, volume: $v, perm: $p) "
                     "{ ok } }", {"a": ak, "v": volume, "p": perm})

    def create_volume(self, name: str, mp_count: int = 3,
                      dp_count: int = 4) -> dict:
        return self.graphql(
            "mutation { createVolume(name: $n, mpCount: $m, dpCount: $d) }",
            {"n": name, "m": mp_count, "d": dp_count})["createVolume"]


class AccessClient(_Base):
    """Blob gateway surface (api/access analog): put/get/delete against
    a RUNNING access service. For an in-process embedded client with no
    access deployment, see cubefs_tpu_torch.blob.sdk.BlobClient."""

    def put(self, data: bytes, codemode: int | None = None) -> dict:
        args = {} if codemode is None else {"codemode": codemode}
        return self._call("put", args, data)[0]["location"]

    def get(self, location: dict) -> bytes:
        return self._call("get", {"location": location})[1]

    def delete(self, location: dict) -> None:
        self._call("delete", {"location": location})
