"""Role launcher of the port's server.

The port's counterpart of ``cubefs_tpu/cmd.py``: one binary dispatching
on the ``role`` key of a JSON config,

    python -m cubefs_tpu_torch.cmd -c config.json

for the file-system plane's roles (with its S3 gateway, its native
gateway, its FUSE mount and the console), the blob plane's and the codec
sidecar. Each role builds its service object(s), serves them with the
RPC layer (``utils/rpc.py``), registers with its control plane, and
blocks.

Config keys (JSON), with the reference's names and defaults:
  role:         master | metanode | datanode | objectnode | fuseclient |
                fsgateway | console | flashnode | flashgroupmanager |
                clustermgr | blobnode | proxy | access | scheduler | codec
  listen_host / listen_port: bind address (port 0: an ephemeral port)
  packet_port / read_port: a metanode's or datanode's binary packet
                plane and native read plane (0: ephemeral), beside HTTP
  master_addr / clustermgr_addr / proxy_addr / scheduler_addr: upstreams
  vol / mountpoint: the volume a fuseclient mounts at ``mountpoint`` or
                an fsgateway serves to the C ABI (``runtime/nativeclient``)
  replicas, allow_single_node, quota_sweep_interval, zone, rack, qos,
  disks:        the master's, metanode's and datanode's, as the reference's
  capacity_bytes / fgm_addr: a flashnode's cache budget (default 256 MiB)
                and the flash group manager it heartbeats to
  data_dirs / data_dir / queue_dir / task_dir: storage paths
  audit_dir:    the audit log, ``<audit_dir>/<role>.audit.log``, and the
                slow-trace log, ``<audit_dir>/slowtrace.jsonl``
  ec_engine:    the codec engine (codec/engine.py): cuda, numpy, cpp,
                numpy-xor, cpp-xor or auto; ``access`` and ``scheduler``
                (the port's own key there: the scrub's parity recompute)
                default to auto, ``codec`` to ``CUBEFS_TPU_EC_ENGINE`` or
                cuda
  tasks_off:    the port's own key: task kinds a scheduler switches off
                before its loop's first tick, as ``tasks disable`` would
                (e.g. ``disk_repair`` for a scheduler whose clustermgr
                state hears no heartbeats)
  blob_size, az, rack, node_id, allow_colocated_units: as the reference's
  vols:         {bucket: vol_name} (objectnode), each served by a
                ``FileSystem`` over the master's ``client_view``
  users:        objectnode identities, [{access_key, secret_key,
                user_id, grants: {vol: perm}}] (SigV4/V2 required); or
  users_from_master: true, the master's replicated user table
  audit_webhook_url / audit_queue_dir: the objectnode's audit sinks
  me / peers:   a clustermgr raft group (``peers`` lists every member,
                ``me`` among them; ports must be static, listen_port != 0)
  mq_members:   access produces its repair/delete events into the
                replicated bus hosted by these schedulers (QueueProducer)
  mq_me / mq_peers / mq_dir / mq_partitions: a scheduler hosting a
                member of the replicated ``repair`` and ``delete`` topics
                (ReplicatedQueue; ``mq_partitions`` default 2), with the
                ``mq_<topic>_*`` relay routes and ``mq_status`` mounted
  device:       the port's own key: the CUDA device of every role that
                runs the codec (default: the current one, and a role
                raises without a card), or "cpu" to run the kernels'
                plain versions; the master, metanode, datanode and
                objectnode run no kernel and take it without using it

A metanode and a datanode register with the master and heartbeat to it
every 3 s, a flashnode to its flash group manager. The fuseclient and
fsgateway roles build their ``FileSystem`` with no blob client, as the
reference's do: a tiered file reads as its size in zero bytes there.

Each role prints ``[<role>] listening on host:port`` once it serves, the
objectnode the reference's ``[objectnode] S3 on host:port``, the
fsgateway ``[fsgateway] <vol> on host:port`` after it, and the
fuseclient ``[fuseclient] <vol> mounted at <mountpoint>``. On
SIGTERM or SIGINT it stops what it started beside its service
(heartbeats, packet planes, a fuseclient's mount), the service (a
master's quota sweeper, ``stop``, then ``fsm_stop``, which stops a
clustermgr's or master's raft node), the replicated queues a scheduler
hosts, and then the server; an error while closing is printed and the
process exits 1. On SIGUSR1 it writes every thread's stack to stderr and
serves on.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import signal
import sys
import threading
import traceback


def _audit_for(cfg):
    from .utils.auditlog import AuditLogger

    if cfg.get("audit_dir"):
        return AuditLogger(f"{cfg['audit_dir']}/{cfg['role']}.audit.log")
    return None


def _serve(routes, cfg, audit=None):
    from .utils import rpc

    srv = rpc.RpcServer(
        routes, host=cfg.get("listen_host", "127.0.0.1"),
        port=int(cfg.get("listen_port", 0)),
        service=cfg["role"], audit=audit if audit is not None else _audit_for(cfg),
    ).start()
    print(f"[{cfg['role']}] listening on {srv.addr}", flush=True)
    return srv


def _heartbeat_loop(fn, interval=3.0):
    """Call ``fn`` now and every ``interval`` s on a daemon thread until
    the returned callable is called; an error is printed, not raised."""
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            try:
                fn()
            except Exception as e:
                print(f"heartbeat error: {e}", file=sys.stderr, flush=True)
            stop.wait(interval)

    threading.Thread(target=loop, daemon=True).start()
    return stop.set


def _fs_node(kind, svc, cfg):
    """Serve a metanode or datanode: HTTP, then the binary packet plane
    and the native read plane beside it (sharing HTTP's audit log),
    register with the master and heartbeat to it."""
    from .utils import rpc

    role = cfg["role"]
    host = cfg.get("listen_host", "127.0.0.1")
    audit = _audit_for(cfg)
    srv = _serve(svc, cfg, audit=audit)  # live routing: per-partition raft handlers
    svc.addr = srv.addr
    psrv = svc.serve_packets(host=host, port=int(cfg.get("packet_port", 0)), audit=audit)
    print(f"[{role}] packet plane on {psrv.addr}", flush=True)
    raddr = svc.serve_native(host=host, port=int(cfg.get("read_port", 0)))
    if raddr:
        print(f"[{role}] native read plane on {raddr}", flush=True)
    master = rpc.Client(cfg["master_addr"])
    zone, rack = cfg.get("zone", "default"), cfg.get("rack")

    def info():
        out = {"kind": kind, "addr": srv.addr, "zone": zone, "rack": rack,
               "packet_addr": psrv.addr, "read_addr": raddr}
        if kind == "data":
            # the master's disk manager migrates partitions off any disk
            # a heartbeat reports broken
            out["disks"] = svc.disk_report()
        return out

    master.call("register", info())
    svc.role_closers = [_heartbeat_loop(lambda: master.call("heartbeat", info())), psrv.stop]
    return srv, master


def run_role(cfg: dict):
    """Build and start the role's service; returns (server, service)."""
    from .utils import rpc
    from .utils.rpc import NodePool

    role = cfg.get("role")
    pool = NodePool()
    device = cfg.get("device")

    if role == "master":
        from .fs.master import Master

        svc = Master(pool, replicas=int(cfg.get("replicas", 3)),
                     allow_single_node=bool(cfg.get("allow_single_node", False)),
                     data_dir=cfg.get("data_dir"),
                     me=cfg.get("me"), peers=cfg.get("peers"))
        svc.start_quota_sweeper(float(cfg.get("quota_sweep_interval", 30.0)))
        return _serve(svc, cfg), svc

    if role == "metanode":
        from .fs.metanode import MetaNode

        svc = MetaNode(int(cfg.get("node_id", 0)), data_dir=cfg.get("data_dir"),
                       node_pool=pool)
        srv, master = _fs_node("meta", svc, cfg)

        def _dp_view():
            meta, _ = master.call("dp_view", {})
            return {int(k): v for k, v in meta["dps"].items()}

        svc.set_dp_view(_dp_view)  # enables the deferred-deletion scan
        return srv, svc

    if role == "datanode":
        from .fs.datanode import DataNode

        # the node learns its own address only after the server binds
        svc = DataNode(int(cfg.get("node_id", 0)), cfg["data_dir"], "pending", pool,
                       qos=cfg.get("qos"),  # {"read_bps":..., "write_bps":...}
                       disks=cfg.get("disks"))  # multi-disk: list of dirs
        return _fs_node("data", svc, cfg)[0], svc

    if role == "flashnode":
        from .fs.remotecache import FlashNode

        svc = FlashNode(capacity_bytes=int(cfg.get("capacity_bytes", 256 << 20)))
        srv = _serve(svc, cfg)
        if cfg.get("fgm_addr"):
            fgm = rpc.Client(cfg["fgm_addr"])
            svc.role_closers = [_heartbeat_loop(
                lambda: fgm.call("flashnode_heartbeat", {"addr": srv.addr}))]
        return srv, svc

    if role == "flashgroupmanager":
        from .fs.remotecache import FlashGroupManager

        svc = FlashGroupManager(data_dir=cfg.get("data_dir"), me=cfg.get("me"),
                                peers=cfg.get("peers"), node_pool=pool)
        return _serve(svc, cfg), svc

    if role == "objectnode":
        from .fs.client import FileSystem
        from .fs.objectnode import ObjectNode

        master = rpc.Client(cfg["master_addr"])
        vols = {}
        for bucket, vol_name in cfg.get("vols", {}).items():
            view = master.call("client_view", {"name": vol_name})[0]["volume"]
            vols[bucket] = FileSystem(view, pool, master_addr=cfg["master_addr"])
        auth = None
        if cfg.get("users_from_master"):
            # the master's replicated user table is the identity source
            from .fs.s3auth import MasterUserStore, S3V4Authenticator

            auth = S3V4Authenticator(MasterUserStore(master), dict(cfg.get("vols", {})))
        elif cfg.get("users"):  # [{access_key, secret_key, grants:{vol:perm}}]
            from .fs.authnode import UserStore
            from .fs.s3auth import S3V4Authenticator

            store = UserStore()
            for u in cfg["users"]:
                store.users[u["access_key"]] = {
                    "user_id": u.get("user_id", u["access_key"]),
                    "sk": u["secret_key"],
                    "volumes": dict(u.get("grants", {})),
                }
            auth = S3V4Authenticator(store, dict(cfg.get("vols", {})))
        sinks = []
        if cfg.get("audit_webhook_url"):
            from .fs.s3audit import WebhookAuditSink

            sinks.append(WebhookAuditSink(cfg["audit_webhook_url"]))
        if cfg.get("audit_queue_dir"):
            from .blob.mq import MessageQueue
            from .fs.s3audit import QueueAuditSink

            sinks.append(QueueAuditSink(MessageQueue(cfg["audit_queue_dir"], topic="s3audit")))
        node = ObjectNode(vols, host=cfg.get("listen_host", "127.0.0.1"),
                          port=int(cfg.get("listen_port", 0)),
                          authenticator=auth, audit_sinks=sinks).start()
        print(f"[objectnode] S3 on {node.addr}", flush=True)
        return node, node

    if role == "fuseclient":
        from .fs.client import FileSystem
        from .fs.fuse import mount as fuse_mount

        master = rpc.Client(cfg["master_addr"])
        view = master.call("client_view", {"name": cfg["vol"]})[0]["volume"]
        m = fuse_mount(FileSystem(view, pool, master_addr=cfg["master_addr"]),
                       cfg["mountpoint"])
        m.role_closers = [m.unmount]
        print(f"[fuseclient] {cfg['vol']} mounted at {cfg['mountpoint']}", flush=True)
        return m, m

    if role == "fsgateway":
        from .fs.client import FileSystem
        from .fs.fsgateway import FsGateway

        master = rpc.Client(cfg["master_addr"])
        view = master.call("client_view", {"name": cfg["vol"]})[0]["volume"]
        svc = FsGateway(FileSystem(view, pool, master_addr=cfg["master_addr"]))
        srv = _serve(rpc.expose(svc), cfg)
        print(f"[fsgateway] {cfg['vol']} on {srv.addr}", flush=True)
        return srv, svc

    if role == "console":
        from .fs.console import Console

        svc = Console(master_addr=cfg.get("master_addr"),
                      clustermgr_addr=cfg.get("clustermgr_addr"),
                      scheduler_addr=cfg.get("scheduler_addr"),
                      host=cfg.get("listen_host", "127.0.0.1"),
                      port=int(cfg.get("listen_port", 0))).start()
        print(f"[console] listening on {svc.addr}", flush=True)
        return svc, svc

    if role == "clustermgr":
        from .blob.clustermgr import ClusterMgr

        # peers (incl. our own addr) enable raft replication; addresses
        # must be static (listen_port != 0) so the group can dial us
        svc = ClusterMgr(data_dir=cfg.get("data_dir"),
                         allow_colocated_units=bool(cfg.get("allow_colocated_units", False)),
                         me=cfg.get("me"), peers=cfg.get("peers"),
                         node_pool=pool)
        return _serve(svc, cfg), svc

    if role == "blobnode":
        from .blob.blobnode import BlobNode

        svc = BlobNode(int(cfg.get("node_id", 0)), cfg["data_dirs"],
                       rpc.Client(cfg["clustermgr_addr"]), addr="",
                       az=cfg.get("az", ""), rack=cfg.get("rack", ""),
                       device=device)
        srv = _serve(rpc.expose(svc), cfg)
        svc.addr = srv.addr
        svc.register()
        svc.start_heartbeat()
        return srv, svc

    if role == "proxy":
        from .blob.proxy import ProxyAllocator

        svc = ProxyAllocator(rpc.Client(cfg["clustermgr_addr"]))
        return _serve(rpc.expose(svc), cfg), svc

    if role == "access":
        from .blob.access import AccessConfig, AccessHandler
        from .blob.mq import MessageQueue, QueueProducer

        q_dir = cfg.get("queue_dir")
        mq_members = cfg.get("mq_members")  # replicated bus (Kafka role)
        if mq_members:
            nparts = int(cfg.get("mq_partitions", 2))
            rq = QueueProducer("repair", mq_members, pool, nparts)
            dq = QueueProducer("delete", mq_members, pool, nparts)
        else:
            rq = MessageQueue(q_dir, "repair") if q_dir else None
            dq = MessageQueue(q_dir, "delete") if q_dir else None
        svc = AccessHandler(
            rpc.Client(cfg["clustermgr_addr"]), pool,
            AccessConfig(blob_size=int(cfg.get("blob_size", 8 << 20)),
                         engine=cfg.get("ec_engine", "auto"),
                         device=device, client_az=cfg.get("az")),
            repair_queue=rq,
            delete_queue=dq,
            proxy_client=rpc.Client(cfg["proxy_addr"]) if cfg.get("proxy_addr") else None,
        )
        return _serve(rpc.expose(svc), cfg), svc

    if role == "codec":
        from .codec.service import CodecService

        svc = CodecService(engine=cfg.get("ec_engine"), device=device)
        return _serve(rpc.expose(svc), cfg), svc

    if role == "scheduler":
        # The scheduler colocates with clustermgr state; in multi-process
        # deployments it owns its own ClusterMgr data dir (leader mode).
        from .blob.clustermgr import ClusterMgr
        from .blob.mq import MessageQueue
        from .blob.scheduler import Scheduler

        cm = ClusterMgr(data_dir=cfg.get("data_dir"))
        q_dir = cfg.get("queue_dir")
        mq_routes: dict = {}
        if cfg.get("mq_me") and cfg.get("mq_peers"):
            # replicated bus member (Kafka role): this scheduler hosts a
            # raft member of each topic; producers relay via mq_*_put
            from .blob.mq import ReplicatedQueue
            from .parallel import raft as raftlib

            nparts = int(cfg.get("mq_partitions", 2))
            rq, dq = (ReplicatedQueue(topic, cfg["mq_me"], cfg["mq_peers"], pool,
                                      data_dir=cfg.get("mq_dir"), n_partitions=nparts)
                      for topic in ("repair", "delete"))
            # one raft table for both topics: merging the two queues'
            # tables would keep only the second's batched-heartbeat route,
            # whose registry misses the first topic's groups, so their
            # followers would never hear a heartbeat and re-elect forever
            for q in (rq, dq):
                for node in q.rafts:
                    raftlib.register_routes(mq_routes, node)
                mq_routes.update((k, v) for k, v in q.extra_routes.items()
                                 if k.startswith("mq_"))
            mq_routes["mq_status"] = lambda a, b: {"repair": rq.status(),
                                                   "delete": dq.status()}
        else:
            rq = MessageQueue(q_dir, "repair") if q_dir else None
            dq = MessageQueue(q_dir, "delete") if q_dir else None
        svc = Scheduler(
            cm,
            repair_queue=rq,
            delete_queue=dq,
            node_pool=pool,
            data_dir=cfg.get("task_dir"),
            device=device,
            engine=cfg.get("ec_engine", "auto"),
        )
        for kind in cfg.get("tasks_off", ()):
            svc.switch.disable(kind)  # before the first tick of its loop
        svc.start()
        routes = {**rpc.expose(svc), **mq_routes,
                  **{f"cm_{k}": v for k, v in rpc.expose(cm).items()}}
        return _serve(dict(routes, role=lambda a, b: {"role": "scheduler"}), cfg), svc

    raise SystemExit(f"unknown role {role!r}")


def shutdown(srv, svc) -> int:
    """Stop what the role started beside the service (``role_closers``:
    heartbeats, packet planes), the service (a master's quota sweeper,
    ``stop``, then ``fsm_stop``), the replicated queues it hosts, then the server. Every step runs;
    returns 0, or 1 once any step raised (each error's traceback is
    printed to stderr)."""
    rc = 0
    queues = [getattr(svc, n, None) for n in ("repair_queue", "delete_queue")]
    steps = (list(getattr(svc, "role_closers", ()))
             + [getattr(svc, n, None) for n in ("stop_quota_sweeper", "stop", "fsm_stop")]
             + [q.stop for q in queues if callable(getattr(q, "stop", None))])
    for step in steps + [getattr(srv, "stop", None)]:
        if not callable(step):
            continue
        try:
            step()
        except Exception:
            traceback.print_exc()
            rc = 1
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cubefs-tpu-torch-server")
    ap.add_argument("-c", "--config", required=True, help="JSON config file")
    args = ap.parse_args(argv)
    with open(args.config) as f:
        cfg = json.load(f)
    stop = threading.Event()
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    srv, svc = run_role(cfg)
    # a signal that lands on another thread runs its Python handler only
    # once the main thread runs again: wake it twice a second
    while not stop.wait(0.5):
        pass
    print(f"[{cfg['role']}] shutting down", flush=True)
    return shutdown(srv, svc)


if __name__ == "__main__":
    raise SystemExit(main())
