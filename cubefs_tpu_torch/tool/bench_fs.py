"""FS-plane benchmark harness: the mdtest / fio role.

Role parity: the reference's published evaluation (docs/source/
evaluation: mdtest dir/file creation + stat ops/s, fio seq/rand MB/s,
small-file TPS — see BASELINE.md). Measures this framework's FS plane
with the same shapes: metadata ops/s (create/stat/readdir/remove),
sequential write/read MB/s, and small-file TPS, against an in-process
cluster (default) or a live master.

  python -m cubefs_tpu_torch.tool.bench_fs         # in-process cluster
  python -m cubefs_tpu_torch.tool.bench_fs --master H:P --vol NAME

The port's copy of ``cubefs_tpu/tool/bench_fs.py``: the same functions,
flags, JSON keys and exit codes, over the port's file-system plane. It is
host work (no kernel runs) and never imports torch, so its legs may fork
client and server processes. ``native_loadgen`` drives the C++ loadgen of
the port's file-system library (``runtime/fsnative.py``, ``ms_bench``).
A leg's CPU seconds come from ``getrusage`` and are reported as read: a
kernel that counts CPU time in coarse ticks may report 0 for a short
leg, and nothing divides by them.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor


def _rate(n: int, dt: float) -> float:
    return round(n / dt, 1) if dt > 0 else float("inf")


def run(fs, files: int = 200, io_mb: int = 16, threads: int = 8,
        small_size: int = 1024) -> dict:
    import uuid

    out: dict = {}
    pool = ThreadPoolExecutor(threads)
    root = f"/bench_{uuid.uuid4().hex[:8]}"  # rerunnable on a live volume

    # ---- mdtest analog: dirs ----
    fs.mkdir(root)
    t0 = time.perf_counter()
    list(pool.map(lambda i: fs.mkdir(f"{root}/d{i}"), range(files)))
    out["dir_create_ops"] = _rate(files, time.perf_counter() - t0)
    t0 = time.perf_counter()
    list(pool.map(lambda i: fs.stat(f"{root}/d{i}"), range(files)))
    out["dir_stat_ops"] = _rate(files, time.perf_counter() - t0)

    # ---- mdtest analog: files (+ small-file TPS with payload) ----
    payload = os.urandom(small_size)
    t0 = time.perf_counter()
    list(pool.map(lambda i: fs.write_file(f"{root}/d{i % files}/f{i}", payload),
                  range(files)))
    out["small_file_create_tps"] = _rate(files, time.perf_counter() - t0)
    t0 = time.perf_counter()
    list(pool.map(lambda i: fs.read_file(f"{root}/d{i % files}/f{i}"),
                  range(files)))
    out["small_file_read_tps"] = _rate(files, time.perf_counter() - t0)
    t0 = time.perf_counter()
    list(pool.map(lambda i: fs.stat(f"{root}/d{i % files}/f{i}"), range(files)))
    out["file_stat_ops"] = _rate(files, time.perf_counter() - t0)

    # ---- fio analog: sequential write / read ----
    blob = os.urandom(1 << 20)
    t0 = time.perf_counter()
    for i in range(io_mb):
        fs.write_file(f"{root}/big.bin", blob, append=i > 0)
    dt = time.perf_counter() - t0
    out["seq_write_mbps"] = _rate(io_mb, dt)
    t0 = time.perf_counter()
    got = fs.read_file(f"{root}/big.bin")
    dt = time.perf_counter() - t0
    assert len(got) == io_mb << 20
    out["seq_read_mbps"] = _rate(io_mb, dt)

    # ---- cleanup ops/s (mdtest removal) ----
    t0 = time.perf_counter()
    list(pool.map(lambda i: fs.unlink(f"{root}/d{i % files}/f{i}"),
                  range(files)))
    out["file_remove_ops"] = _rate(files, time.perf_counter() - t0)
    # leave the volume reusable: remove the whole bench tree
    fs.unlink(f"{root}/big.bin")
    list(pool.map(lambda i: fs.unlink(f"{root}/d{i}"), range(files)))
    fs.unlink(root)
    pool.shutdown()
    return out


def _inprocess_fs(workdir: str, n_data: int = 3, n_meta: int = 2):
    from ..fs.client import FileSystem
    from ..fs.datanode import DataNode
    from ..fs.master import Master
    from ..fs.metanode import MetaNode
    from ..utils.rpc import NodePool

    pool = NodePool()
    master = Master(pool)
    pool.bind("master", master)
    metas = []
    for i in range(n_meta):
        node = MetaNode(i, addr=f"meta{i}", node_pool=pool)
        pool.bind(f"meta{i}", node)
        master.register_metanode(f"meta{i}")
        metas.append(node)
    for i in range(n_data):
        node = DataNode(i, os.path.join(workdir, f"d{i}"), f"data{i}", pool)
        pool.bind(f"data{i}", node)
        master.register_datanode(f"data{i}")
    view = master.create_volume("bench", mp_count=2, dp_count=3)
    return FileSystem(view, pool), metas


def _stat_proc(view, paths, secs, threads, q):
    """One saturation client process: `threads` threads hammering stat.
    Separate PROCESSES because a single Python client tops out on its
    own GIL long before the native server does — server capacity only
    shows under multi-process load (the reference measures mdtest with
    8 clients x 64 procs for the same reason)."""
    from ..fs.client import FileSystem
    from ..utils.rpc import NodePool

    fs = FileSystem(view, NodePool())
    stop = time.perf_counter() + secs
    counts = [0] * threads

    def worker(t):
        i = t
        while time.perf_counter() < stop:
            fs.stat(paths[i % len(paths)])
            i += threads
            counts[t] += 1

    pool = ThreadPoolExecutor(threads)
    list(pool.map(worker, range(threads)))
    pool.shutdown()
    q.put(sum(counts))


def saturated_stat(view, procs: int = 8, threads: int = 4,
                   secs: float = 3.0, dirs: int = 64) -> float:
    """Aggregate stat ops/s from `procs` client processes (server-side
    capacity measurement; the mdtest dir-stat shape)."""
    import multiprocessing as mp_mod
    import uuid

    from ..fs.client import FileSystem
    from ..utils.rpc import NodePool

    fs = FileSystem(view, NodePool())
    root = f"/sat_{uuid.uuid4().hex[:6]}"
    fs.mkdir(root)
    paths = []
    for i in range(dirs):
        fs.mkdir(f"{root}/d{i}")
        paths.append(f"{root}/d{i}")
    q = mp_mod.Queue()
    ps = [mp_mod.Process(target=_stat_proc,
                         args=(view, paths, secs, threads, q))
          for _ in range(procs)]
    t0 = time.perf_counter()
    for p in ps:
        p.start()
    total = sum(q.get() for _ in ps)
    for p in ps:
        p.join()
    dt = time.perf_counter() - t0
    for i in range(dirs):
        fs.unlink(f"{root}/d{i}")
    fs.unlink(root)
    return round(total / dt, 1)


def _create_proc(view, parent_ino, secs, threads, q, tag):
    """One saturation client process: `threads` threads hammering mknod
    against the partition that owns `parent_ino` — the write-side
    sibling of _stat_proc (all creates target ONE raft group, the shape
    group commit amortizes)."""
    from ..fs import metanode as mn
    from ..fs.client import FileSystem
    from ..utils.rpc import NodePool

    fs = FileSystem(view, NodePool())
    stop = time.perf_counter() + secs
    counts = [0] * threads

    def worker(t):
        i = 0
        while time.perf_counter() < stop:
            fs.meta.mknod(parent_ino, f"c{tag}_{t}_{i}", mn.FILE)
            i += 1
            counts[t] += 1

    import resource

    cpu0 = resource.getrusage(resource.RUSAGE_SELF)
    pool = ThreadPoolExecutor(threads)
    list(pool.map(worker, range(threads)))
    pool.shutdown()
    cpu1 = resource.getrusage(resource.RUSAGE_SELF)
    q.put({"ops": sum(counts),
           "cpu_s": round((cpu1.ru_utime - cpu0.ru_utime)
                          + (cpu1.ru_stime - cpu0.ru_stime), 3)})


def saturated_create(view, procs: int = 8, threads: int = 8,
                     secs: float = 3.0) -> dict:
    """Aggregate file-create ops/s from `procs` client processes — the
    write-side capacity number (mdtest file-creation shape). Every
    create is one replicated mknod commit against the same parent
    directory, so per-op replication rounds vs group commit is exactly
    what this measures. Each client process reports its own rusage CPU
    seconds, so the artifact can show whether the measurement was
    client-bound or server-bound. The bench tree is left in place:
    removal is as expensive as creation and this runs against
    throwaway clusters."""
    import multiprocessing as mp_mod
    import uuid

    from ..fs.client import FileSystem
    from ..utils.rpc import NodePool

    fs = FileSystem(view, NodePool())
    root = f"/wr_{uuid.uuid4().hex[:6]}"
    fs.mkdir(root)
    parent_ino = fs.resolve(root)
    q = mp_mod.Queue()
    ps = [mp_mod.Process(target=_create_proc,
                         args=(view, parent_ino, secs, threads, q, i))
          for i in range(procs)]
    t0 = time.perf_counter()
    for p in ps:
        p.start()
    got = [q.get() for _ in ps]
    for p in ps:
        p.join()
    dt = time.perf_counter() - t0
    return {"create_ops": round(sum(g["ops"] for g in got) / dt, 1),
            "loadgen_cpu_s": sorted(g["cpu_s"] for g in got)}


def server_create_capacity(threads: int = 384, secs: float = 4.0) -> dict:
    """Server-side write capacity: `threads` concurrent creates against
    a live two-node replicated metanode over the in-process transport —
    no HTTP, no client processes — the write-side sibling of
    native_loadgen's ms_bench number. On a shared-core box the deployed
    measurement is client-bound long before the commit path saturates
    (same reason the 132k read number needed the C++ loadgen); this
    measures what the replicated commit path itself sustains, with real
    raft WALs and fsyncs. Honors the CUBEFS_RAFT_GROUP_COMMIT /
    CUBEFS_META_COALESCE env knobs, so an A/B isolates group commit."""
    import tempfile as _tf
    import threading as _th

    from ..fs.metanode import MetaNode
    from ..utils import metrics
    from ..utils.rpc import NodePool

    wd = _tf.mkdtemp(prefix="cubefs-wcap-")
    pool = NodePool()
    addrs = ["wcap0", "wcap1"]
    nodes = []
    for i, a in enumerate(addrs):
        node = MetaNode(300 + i, data_dir=os.path.join(wd, a),
                        addr=a, node_pool=pool)
        pool.bind(a, node)
        nodes.append(node)
    for node in nodes:
        node.create_partition(9, 1, 1 << 20, peers=addrs)
    leader = None
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline and leader is None:
        for node in nodes:
            if node.rafts[9].status()["role"] == "leader":
                leader = node
        time.sleep(0.02)
    if leader is None:
        for node in nodes:
            node.stop()
        raise TimeoutError("capacity partition never elected a leader")
    client = pool.get(leader.addr)
    gid, pid = "mp9", "9"
    base = {
        "entries": metrics.raft_proposals.value(group=gid),
        "fsyncs": metrics.raft_wal_fsyncs.value(group=gid),
        "batched": metrics.meta_batched_ops.value(pid=pid),
        "batch_entries": metrics.meta_batch_entries.value(pid=pid),
    }
    stop = time.perf_counter() + secs
    counts = [0] * threads

    def worker(t):
        i = 0
        while time.perf_counter() < stop:
            client.call("submit", {"pid": 9, "record": {
                "op": "mknod", "parent": 1, "name": f"n{t}_{i}",
                "type": "file", "mode": 0o644, "ts": time.time(),
                "op_id": f"cap{t}-{i}"}})
            i += 1
            counts[t] += 1

    t0 = time.perf_counter()
    ths = [_th.Thread(target=worker, args=(t,)) for t in range(threads)]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    dt = time.perf_counter() - t0
    total = sum(counts)
    entries = metrics.raft_proposals.value(group=gid) - base["entries"]
    fsyncs = metrics.raft_wal_fsyncs.value(group=gid) - base["fsyncs"]
    batched = metrics.meta_batched_ops.value(pid=pid) - base["batched"]
    bentries = (metrics.meta_batch_entries.value(pid=pid)
                - base["batch_entries"])
    for node in nodes:
        node.stop()
    return {
        "create_ops": round(total / dt, 1),
        "creates": total,
        "threads": threads,
        "raft_entries": int(entries),
        "wal_fsyncs": int(fsyncs),
        "coalesced_ops": int(batched),
        "ops_per_batch_entry": round(batched / bentries, 1)
        if bentries else None,
    }


def write_ab(workdir: str, procs: int = 8, threads: int = 8,
             secs: float = 3.0, cap_threads: int = 384) -> dict:
    """Write-side capacity A/B: with group commit + coalescing forced
    OFF (the round-5 per-op behavior) and then ON (default), measure
    (a) server capacity — in-process create saturation against the
    replicated commit path (server_create_capacity) — and (b) the
    deployed full-system number: real-socket cluster + multi-process
    HTTP clients, which on a shared-core box is client-bound (same
    caveat as the r05 stat numbers). The per-node /metrics write-path
    digest is captured alongside, so the claimed batching (entries ≪
    ops, fsyncs ≪ ops) is inspectable in the artifact, not just
    inferred from the ratio."""
    from ..cli import _fetch_metrics, _write_path_view
    from ..deploy.cluster import Cluster as DeployCluster
    from ..fs.client import FileSystem
    from ..utils import rpc
    from ..utils.rpc import NodePool

    knobs = ("CUBEFS_RAFT_GROUP_COMMIT", "CUBEFS_META_COALESCE")
    legs = (("baseline_per_op", "0"), ("group_commit", "1"))
    topo = {"metanodes": 2, "datanodes": 3, "replicas": 2,
            "volume": {"name": "bench", "mp_count": 2, "dp_count": 3}}
    out: dict = {}
    saved = {k: os.environ.get(k) for k in knobs}
    try:
        for leg, knob in legs:
            for k in knobs:
                os.environ[k] = knob  # read at node/raft construction
            cap = server_create_capacity(threads=cap_threads, secs=secs)
            c = DeployCluster(topo, os.path.join(workdir, leg))
            try:
                state = c.up()  # role processes inherit the knobs
                master = state["roles"]["master"][0]
                view = rpc.call(master, "client_view",
                                {"name": "bench"})[0]["volume"]
                warm = FileSystem(view, NodePool())
                deadline = time.time() + 20
                while time.time() < deadline:
                    try:
                        warm.write_file("/warmup", b"x" * 100)
                        warm.unlink("/warmup")
                        break
                    except Exception:
                        time.sleep(0.5)
                sat = saturated_create(view, procs=procs,
                                       threads=threads, secs=secs)
                digests = {}
                for addr in state["roles"].get("metanode", []):
                    try:
                        digests[addr] = _write_path_view(_fetch_metrics(addr))
                    except Exception:
                        pass
                out[leg] = {"server_capacity": cap,
                            "deployed": {"create_ops": sat["create_ops"],
                                         "loadgen_cpu_s":
                                             sat["loadgen_cpu_s"],
                                         "write_path": digests}}
            finally:
                c.down()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    from ..utils import slo as slolib

    # per-stage write-path tails observed across both legs (the stage
    # histogram is process-wide; the trace door defaults to open here)
    out["stage_tails"] = slolib.quantiles_from_histogram().get(
        "meta.write", {})
    cap_base = out["baseline_per_op"]["server_capacity"]["create_ops"]
    cap_gc = out["group_commit"]["server_capacity"]["create_ops"]
    dep_base = out["baseline_per_op"]["deployed"]["create_ops"]
    out["summary"] = {
        "server_capacity_speedup": round(cap_gc / cap_base, 1)
        if cap_base else None,
        "deployed_speedup": round(
            out["group_commit"]["deployed"]["create_ops"] / dep_base, 1)
        if dep_base else None,
        # r05 dir_create_ops was 726-821 (META_PACKET_AB_r05.json) —
        # the "~800 creates/s" write-path hole this PR targets
        "server_capacity_vs_r05_create": round(cap_gc / 821.0, 1),
    }
    return out


def _wire_fs_cluster(workdir: str, n_data: int = 3, n_meta: int = 2):
    """In-process master/meta/data cluster whose hot paths listen on
    real-TCP binary packet planes (serve_packets on BOTH node kinds), so
    a FileSystem client built from the view routes meta submits and
    extent reads/writes over the wire — the transport the mux door
    gates. Returns (fs, view, metas, datas, psrvs)."""
    from ..fs.client import FileSystem
    from ..fs.datanode import DataNode
    from ..fs.master import Master
    from ..fs.metanode import MetaNode
    from ..utils.rpc import NodePool

    pool = NodePool()
    master = Master(pool)
    pool.bind("master", master)
    metas, datas, psrvs = [], [], []
    for i in range(n_meta):
        addr = f"meta{i}"
        node = MetaNode(i, addr=addr, node_pool=pool)
        pool.bind(addr, node)
        psrv = node.serve_packets()
        psrvs.append(psrv)
        master.register_metanode(addr, packet_addr=psrv.addr)
        metas.append(node)
    for i in range(n_data):
        addr = f"data{i}"
        node = DataNode(i, os.path.join(workdir, f"d{i}"), addr, pool)
        pool.bind(addr, node)
        psrv = node.serve_packets()
        psrvs.append(psrv)
        master.register_datanode(addr, packet_addr=psrv.addr)
        datas.append(node)
    master.create_volume("bench", mp_count=2, dp_count=3)
    view = master.client_view("bench")
    return FileSystem(view, pool), view, metas, datas, psrvs


# The deterministic mutation tape for the wire FSM-identity proof:
# fixed names, types, timestamps and op_ids, issued SERIALLY over the
# packet plane. Serial on purpose — mknod allocates inos in ARRIVAL
# order, so a windowed (reorderable) pipeline would legitimately build
# a different FSM; the claim under test is that the TRANSPORT (mux
# framing, chunked CRC, reader-thread demux) never perturbs what the
# server applies, and a serial tape isolates exactly that.
def _wire_digest_tape(n: int = 256) -> list[dict]:
    return [{"op": "mknod", "parent": 1, "name": f"wid_{i}",
             "type": "file" if i % 3 else "dir", "mode": 0o644,
             "ts": 1000.0 + i, "op_id": f"wire-ident-{i}"}
            for i in range(n)]


def _wire_sat_server_main(conn, workdir: str) -> None:
    """Saturated-create server PROCESS: a two-node replicated metanode
    pair (real raft WAL + fsyncs), each node serving the binary packet
    plane. Lives in its own process so `getrusage(RUSAGE_SELF)` is the
    server's CPU and nothing else — the honest half of the
    server-is-bottleneck evidence. It hands the parent the leader's plane
    and every node's (``peers``): a leader that starves its heartbeat
    under load can lose the election to its peer, and the workers then
    follow the redirect's leader hint to the peer's plane (the
    reference's pair serves the first leader's plane alone, so its
    workers give up after their retries)."""
    import resource

    from ..fs.metanode import MetaNode
    from ..utils.rpc import NodePool

    pool = NodePool()
    addrs = ["wsat0", "wsat1"]
    nodes = []
    for i, a in enumerate(addrs):
        node = MetaNode(800 + i, data_dir=os.path.join(workdir, a),
                        addr=a, node_pool=pool)
        pool.bind(a, node)
        nodes.append(node)
    for node in nodes:
        node.create_partition(9, 1, 1 << 20, peers=addrs)
    leader = None
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline and leader is None:
        for node in nodes:
            if node.rafts[9].status()["role"] == "leader":
                leader = node
        if leader is None:
            time.sleep(0.02)
    if leader is None:
        conn.send({"error": "no leader"})
        return
    srvs = {node.addr: node.serve_packets() for node in nodes}
    cpu0 = resource.getrusage(resource.RUSAGE_SELF)
    conn.send({"addr": srvs[leader.addr].addr,
               "peers": {a: srv.addr for a, srv in srvs.items()}})
    conn.recv()  # block until the parent says stop
    cpu1 = resource.getrusage(resource.RUSAGE_SELF)
    for srv in srvs.values():
        srv.stop()
    for node in nodes:
        node.stop()
    conn.send({"cpu_s": round((cpu1.ru_utime - cpu0.ru_utime)
                              + (cpu1.ru_stime - cpu0.ru_stime), 3)})


def _wire_sat_worker_main(widx: int, addr: str, n_records: int,
                          batch: int, q, peers: dict | None = None) -> None:
    """Saturated-create loadgen PROCESS: pumps `n_records` mknods over
    ONE mux connection via submit_batched (the OP_META_SUBMIT_BATCH
    frames, `window` batches in flight). A redirect naming a node of
    `peers` (node -> packet address) moves the connection to that node's
    plane. Reports its own rusage CPU and counts each chunk's records
    once, on the attempt that landed it. Always posts a result — a
    worker that died silently would park the parent on q.get() forever."""
    import re
    import resource

    from ..sdk import WireClient
    from ..utils import packet as pkt

    try:
        cli = WireClient(addr, timeout=30.0)
        cpu0 = resource.getrusage(resource.RUSAGE_SELF)
        t0 = time.perf_counter()
        ok = 0
        for lo in range(0, n_records, 2048):
            recs = [{"op": "mknod", "parent": 1,
                     "name": f"ws{widx}_{i}", "type": "file",
                     "mode": 0o644, "op_id": f"wsat-{widx}-{i}"}
                    for i in range(lo, min(lo + 2048, n_records))]
            # under heavy load the single-core leader can starve its
            # heartbeat loop and drop leadership; the redirect is
            # retryable (an empty leader while the election runs: wait;
            # the peer that won it: move to its plane), and fixed op_ids
            # make the resubmit exactly-once
            for attempt in range(50):
                try:
                    ok += sum(err is None for _, err in
                              cli.submit_batched(9, recs, batch=batch))
                    break
                except pkt.PacketError as e:
                    hint = re.search(r"leader=(\S*)", str(e))
                    if hint is None or attempt == 49:
                        raise
                    moved = (peers or {}).get(hint.group(1))
                    if moved and moved != addr:
                        # the election moved the partition to the peer
                        cli.close()
                        addr = moved
                        cli = WireClient(addr, timeout=30.0)
                    else:
                        time.sleep(0.2)
        dt = time.perf_counter() - t0
        cpu1 = resource.getrusage(resource.RUSAGE_SELF)
        cli.close()
        q.put({"widx": widx, "ok": ok, "secs": round(dt, 3),
               "cpu_s": round((cpu1.ru_utime - cpu0.ru_utime)
                              + (cpu1.ru_stime - cpu0.ru_stime), 3)})
    except BaseException as e:  # noqa: BLE001 — relayed to the parent
        q.put({"widx": widx, "error": f"{type(e).__name__}: {e}"})
        raise


def _wire_saturated_create(workdir: str, workers: int = 2,
                           records_per_worker: int = 16000,
                           batch: int = 256) -> dict:
    """Multi-process saturated create over the packet wire: a server
    process (replicated metanode pair, leader on the packet plane) and
    `workers` loadgen processes pumping submit_batched. Aggregate
    records/s plus per-side CPU attribution — worker CPU < server CPU
    is the machine-checkable server-is-bottleneck claim."""
    import multiprocessing as mp_mod

    parent, child = mp_mod.Pipe()
    srv = mp_mod.Process(target=_wire_sat_server_main,
                         args=(child, workdir))
    srv.start()
    hello = parent.recv()
    if "error" in hello:
        srv.join()
        raise TimeoutError(f"wire sat server: {hello['error']}")
    addr = hello["addr"]
    q = mp_mod.Queue()
    ps = [mp_mod.Process(target=_wire_sat_worker_main,
                         args=(i, addr, records_per_worker, batch, q,
                               hello.get("peers")))
          for i in range(workers)]
    t0 = time.perf_counter()
    for p in ps:
        p.start()
    got = [q.get(timeout=600) for _ in ps]
    for p in ps:
        p.join()
    dt = time.perf_counter() - t0
    dead = [g for g in got if "error" in g]
    if dead:
        parent.send("stop")
        srv.join(timeout=30)
        raise RuntimeError(f"wire sat workers failed: {dead}")
    parent.send("stop")
    tail = parent.recv()
    srv.join()
    total = sum(g["ok"] for g in got)
    worker_cpu = sorted(g["cpu_s"] for g in got)
    return {
        "workers": workers,
        "records": total,
        "records_per_s": round(total / dt, 1),
        "batch": batch,
        "worker_cpu_s": worker_cpu,
        "server_cpu_s": tail["cpu_s"],
        "server_is_bottleneck": tail["cpu_s"] > max(worker_cpu),
    }


def _wire_leg(workdir: str, blob: bytes, small: bytes,
              n_objects: int = 6, n_meta_writes: int = 2000,
              n_small_reads: int = 600) -> dict:
    """One door position of the wire A/B: the four instrumented hot
    paths over the packet plane, plus the serial FSM-digest tape. The
    mux door was latched into the environment by the caller BEFORE
    this runs — every packet client here is constructed fresh under
    that door."""
    import hashlib

    from ..sdk import WireClient
    from ..utils import packet as pkt

    fs, view, metas, datas, psrvs = _wire_fs_cluster(workdir)
    out: dict = {"mux": pkt.mux_enabled(),
                 "window": pkt.window_size() if pkt.mux_enabled() else 1}
    try:
        # ---- FSM digest: serial deterministic tape over the wire ----
        # (standalone partition, untouched by the benchmark traffic)
        metas[0].create_partition(77, 1, 1 << 20)
        ident = WireClient(view["meta_packet_addrs"]["meta0"])
        for rec in _wire_digest_tape():
            ident.call(pkt.OP_META_SUBMIT,
                       args={"pid": 77, "record": dict(rec)})
        out["fsm_digest"] = hashlib.sha256(
            metas[0].partitions[77].state_bytes()).hexdigest()

        # ---- meta write: windowed single-record submits, ops/s ----
        metas[0].create_partition(78, 1, 1 << 20)
        recs = [{"op": "mknod", "parent": 1, "name": f"mw_{i}",
                 "type": "file", "mode": 0o644, "op_id": f"mw-{i}"}
                for i in range(n_meta_writes)]
        t0 = time.perf_counter()
        got = ident.submit_many(78, recs)
        dt = time.perf_counter() - t0
        assert len(got) == n_meta_writes
        out["meta_write_ops"] = round(n_meta_writes / dt, 1)
        ident.close()

        # ---- blob PUT / GET: large streaming objects, MB/s ----
        # (continuation-frame trains + chunked CRC; pipelined pieces)
        mb = len(blob) / (1 << 20)
        t0 = time.perf_counter()
        for i in range(n_objects):
            fs.write_file(f"/obj{i}", blob)
        dt = time.perf_counter() - t0
        out["blob_put_mbps"] = round(n_objects * mb / dt, 1)
        t0 = time.perf_counter()
        shas = {hashlib.sha256(fs.read_file(f"/obj{i}")).hexdigest()
                for i in range(n_objects)}
        dt = time.perf_counter() - t0
        out["blob_get_mbps"] = round(n_objects * mb / dt, 1)
        assert shas == {hashlib.sha256(blob).hexdigest()}
        out["blob_sha"] = shas.pop()

        # ---- fs read: small-file reads, ops/s ----
        n_files = 64
        for i in range(n_files):
            fs.write_file(f"/s{i}", small)
        t0 = time.perf_counter()
        for i in range(n_small_reads):
            data = fs.read_file(f"/s{i % n_files}")
        dt = time.perf_counter() - t0
        assert data == small
        out["fs_read_ops"] = round(n_small_reads / dt, 1)
        out["fs_read_sha"] = hashlib.sha256(small).hexdigest()
    finally:
        # close this leg's packet clients first — otherwise each leg
        # leaks a mux reader thread per plane (and the matching server
        # conn thread) into every later leg
        for wrapper in (fs.meta, fs.data):
            for cli in wrapper._packet_clients.values():
                try:
                    cli.close()
                except Exception:
                    pass
        for s in psrvs:
            s.stop()
        for n in metas + datas:
            n.stop()
    return out


def wire_ab(workdir: str, n_objects: int = 6, n_meta_writes: int = 2000,
            n_small_reads: int = 600, sat_records: int = 32000) -> dict:
    """The wire A/B: ABBA legs over CUBEFS_PKT_MUX=1,0,0,1 (the
    multiplexed streaming plane vs the legacy serial one-packet-per-
    round-trip plane) measuring blob PUT, blob GET, meta write and fs
    read over real-TCP packet transports, with bit-identical FSM
    digests at both door positions and the multi-process saturated-
    create knee (server CPU vs loadgen CPU). ABBA ordering lands
    thermal/cache drift on both doors evenly; a discarded warmup leg
    absorbs the first-cluster penalty (allocator growth, page-cache
    fill, pool spin-up) that would otherwise land on door A alone."""
    import hashlib
    import statistics

    # deterministic payloads shared by every leg (identity checks
    # compare digests ACROSS legs, so the bytes must not vary)
    blob = hashlib.sha256(b"wire-ab-blob").digest()
    blob = (blob * ((4 << 20) // len(blob) + 1))[:4 << 20]
    small = hashlib.sha256(b"wire-ab-small").digest() * 128  # 4 KiB

    legs = []
    sat = {}
    saved = os.environ.get("CUBEFS_PKT_MUX")
    try:
        # saturated create FIRST, once per door, while the parent's heap
        # is pristine: the server/worker children fork from this
        # process, and a heap dirtied by earlier legs depresses them
        # (copy-on-write faults + inherited collector state)
        for door in ("1", "0"):
            os.environ["CUBEFS_PKT_MUX"] = door
            sat[door] = _wire_saturated_create(
                os.path.join(workdir, f"sat{door}"),
                records_per_worker=sat_records // 2)
        os.environ["CUBEFS_PKT_MUX"] = "1"
        _wire_leg(os.path.join(workdir, "warmup"), blob, small,
                  n_objects=2, n_meta_writes=300, n_small_reads=100)
        for i, door in enumerate(("1", "0", "0", "1")):
            os.environ["CUBEFS_PKT_MUX"] = door
            legs.append(_wire_leg(
                os.path.join(workdir, f"leg{i}"), blob, small,
                n_objects=n_objects, n_meta_writes=n_meta_writes,
                n_small_reads=n_small_reads))
    finally:
        if saved is None:
            os.environ.pop("CUBEFS_PKT_MUX", None)
        else:
            os.environ["CUBEFS_PKT_MUX"] = saved

    on = [l for l in legs if l["mux"]]
    off = [l for l in legs if not l["mux"]]

    def med(ls, k):
        return round(statistics.median(x[k] for x in ls), 1)

    paths = ("blob_put_mbps", "blob_get_mbps", "meta_write_ops",
             "fs_read_ops")
    summary: dict = {"mux_on": {k: med(on, k) for k in paths},
                     "mux_off": {k: med(off, k) for k in paths}}
    summary["speedup"] = {
        k: round(summary["mux_on"][k] / summary["mux_off"][k], 2)
        if summary["mux_off"][k] else None for k in paths}
    sat_on = sat["1"]["records_per_s"]
    summary["fsm_digest_identical"] = (
        len({l["fsm_digest"] for l in legs}) == 1)
    summary["blob_bytes_identical"] = (
        len({l["blob_sha"] for l in legs}) == 1)
    summary["saturated_create"] = {
        "r08_plateau_ops": 8000.0,
        "mux_on_records_per_s": sat_on,
        "mux_off_records_per_s": sat["0"]["records_per_s"],
        "vs_r08": round(sat_on / 8000.0, 2),
        "target_2x_met": sat_on >= 16000.0,
    }
    summary["server_is_bottleneck"] = all(
        s["server_is_bottleneck"] for s in sat.values())
    return {"cores": os.cpu_count(), "abba": ["1", "0", "0", "1"],
            "saturated_create": sat, "legs": legs, "summary": summary}


def _metric_sum(metric) -> float:
    return sum(v for _, v in metric.samples())


def _hist_totals(metric) -> tuple[float, float]:
    tot = cnt = 0.0
    for _, s in metric.samples():
        tot += s["sum"]
        cnt += s["count"]
    return tot, cnt


def _mk_meta_cluster(workdir: str, n_parts: int, base_id: int = 500):
    """Two replicated metanodes carrying `n_parts` raft groups each —
    the multi-partition sibling of server_create_capacity's cluster.
    Returns (pool, nodes, mps-view) once every group has a leader."""
    from ..fs.metanode import MetaNode
    from ..utils.rpc import NodePool

    pool = NodePool()
    addrs = ["scale0", "scale1"]
    nodes = []
    for i, a in enumerate(addrs):
        node = MetaNode(base_id + i, data_dir=os.path.join(workdir, a),
                        addr=a, node_pool=pool)
        pool.bind(a, node)
        nodes.append(node)
    for node in nodes:
        for pid in range(1, n_parts + 1):
            node.create_partition(pid, 1, 1 << 20, peers=addrs)
    deadline = time.monotonic() + max(20.0, 0.25 * n_parts)
    pending = set(range(1, n_parts + 1))
    while pending and time.monotonic() < deadline:
        for pid in list(pending):
            for node in nodes:
                if node.rafts[pid].status()["role"] == "leader":
                    pending.discard(pid)
                    break
        if pending:
            time.sleep(0.02)
    if pending:
        for node in nodes:
            node.stop()
        raise TimeoutError(
            f"{len(pending)} of {n_parts} groups never elected a leader")
    mps = [{"pid": pid, "start": 1, "end": 1 << 20, "addrs": list(addrs)}
           for pid in range(1, n_parts + 1)]
    return pool, nodes, mps


def _scale_leg(workdir: str, n_parts: int, threads: int,
               secs: float) -> dict:
    """One measured round: saturated mixed create/mkdir spread across
    `n_parts` partitions through the real client layer (MetaWrapper →
    fan-out coalescer when enabled → submit/submit_batch wire), so the
    number reflects the whole write path, not just the raft core."""
    import threading as _th

    from ..fs.client import MetaWrapper
    from ..utils import metrics

    pool, nodes, mps = _mk_meta_cluster(workdir, n_parts)
    wrapper = MetaWrapper({"mps": mps}, pool)
    base = {
        "pipelined": _metric_sum(metrics.raft_pipelined_appends),
        "mux_jobs": _metric_sum(metrics.raft_mux_jobs),
        "fan_batches": _metric_sum(metrics.meta_fanout_batches),
        "fan_ops": _metric_sum(metrics.meta_fanout_ops),
        "win": _hist_totals(metrics.raft_inflight_window),
        "fsyncs": _metric_sum(metrics.raft_wal_fsyncs),
    }
    stop = time.perf_counter() + secs
    counts = [0] * threads

    def _rec(t, i):
        return {"op": "mknod", "parent": 1, "name": f"s{t}_{i}",
                "type": "file" if i % 2 else "dir", "mode": 0o644,
                "ts": time.time(), "op_id": f"sc{t}-{i}"}

    def worker(t):
        i = 0
        if wrapper.fanout is not None:
            # the async fan-out shape: keep a window of submits in
            # flight across partitions sized so every partition sees a
            # fat batch (~32 records) even when load is spread over
            # hundreds of groups
            window = max(32, (32 * n_parts) // threads)
            while time.perf_counter() < stop:
                ws = []
                for _ in range(window):
                    mp = mps[(t + i) % n_parts]
                    ws.append(wrapper.fanout.submit_async(mp, _rec(t, i)))
                    i += 1
                for w in ws:
                    w.wait()
                counts[t] += window
            return
        # control: the per-op client — one blocking submit per op
        while time.perf_counter() < stop:
            mp = mps[(t + i) % n_parts]
            wrapper._call(mp, "submit", {"record": _rec(t, i)})
            i += 1
            counts[t] += 1

    t0 = time.perf_counter()
    ths = [_th.Thread(target=worker, args=(t,)) for t in range(threads)]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    dt = time.perf_counter() - t0
    win = _hist_totals(metrics.raft_inflight_window)
    out = {
        "create_ops": round(sum(counts) / dt, 1),
        "creates": sum(counts),
        "pipelined_appends": int(
            _metric_sum(metrics.raft_pipelined_appends) - base["pipelined"]),
        "mux_jobs": int(_metric_sum(metrics.raft_mux_jobs)
                        - base["mux_jobs"]),
        "fanout_batches": int(_metric_sum(metrics.meta_fanout_batches)
                              - base["fan_batches"]),
        "fanout_ops": int(_metric_sum(metrics.meta_fanout_ops)
                          - base["fan_ops"]),
        "wal_fsyncs": int(_metric_sum(metrics.raft_wal_fsyncs)
                          - base["fsyncs"]),
        "inflight_window_avg": round(
            (win[0] - base["win"][0]) / (win[1] - base["win"][1]), 2)
        if win[1] > base["win"][1] else None,
    }
    if wrapper.fanout is not None:
        wrapper.fanout.close()
    for node in nodes:
        node.stop()
    return out


_SCALE_KNOBS = {
    # control = the unpipelined write path: group commit on, but per-follower
    # lockstep replication, per-partition timers, per-op client submits
    "control": {"CUBEFS_RAFT_PIPELINE": "0", "CUBEFS_RAFT_MUX": "0",
                "CUBEFS_META_FANOUT": "0"},
    # K=16 measured best on the bench box: enough partition-level
    # concurrency to hide commit latency, few enough drain workers that
    # scheduler churn doesn't eat the batching win
    "pipelined": {"CUBEFS_RAFT_PIPELINE": "4", "CUBEFS_RAFT_MUX": "1",
                  "CUBEFS_META_FANOUT": "16"},
}


def fsm_identity_check(workdir: str, n_parts: int = 4,
                       records_per_part: int = 200) -> dict:
    """Drive an IDENTICAL deterministic mutation sequence (fixed op_ids,
    fixed timestamps, serial order) through the pipelined and the
    unpipelined write path, wait for every follower to catch up, and
    compare sha256 digests of each partition's serialized FSM state
    across replicas AND across the two configurations. Equal digests on
    the follower prove replication delivered exactly-once (no double-
    apply, no gap); equal digests across configs prove the pipeline door
    changes scheduling only, never state."""
    import hashlib

    digests: dict[str, dict] = {}
    saved = {k: os.environ.get(k)
             for leg in _SCALE_KNOBS.values() for k in leg}
    try:
        for leg, knobs in _SCALE_KNOBS.items():
            os.environ.update(knobs)
            pool, nodes, mps = _mk_meta_cluster(
                os.path.join(workdir, f"ident_{leg}"), n_parts,
                base_id=700)
            from ..fs.client import MetaWrapper

            wrapper = MetaWrapper({"mps": mps}, pool)
            for mp in mps:
                for i in range(records_per_part):
                    wrapper._call(mp, "submit", {"record": {
                        "op": "mknod", "parent": 1, "name": f"id_{i}",
                        "type": "file" if i % 2 else "dir",
                        "mode": 0o644, "ts": 1000.0 + i,
                        "op_id": f"ident-{mp['pid']}-{i}"}})
            # followers apply behind the commit index: wait for every
            # replica of every group to reach the leader's apply_id
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                ids = {pid: {n.addr: n.partitions[pid].apply_id
                             for n in nodes}
                       for pid in range(1, n_parts + 1)}
                if all(len(set(v.values())) == 1 for v in ids.values()):
                    break
                time.sleep(0.05)
            digests[leg] = {
                str(pid): {n.addr: hashlib.sha256(
                    n.partitions[pid].state_bytes()).hexdigest()
                    for n in nodes}
                for pid in range(1, n_parts + 1)}
            if wrapper.fanout is not None:
                wrapper.fanout.close()
            for node in nodes:
                node.stop()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    replicas_agree = all(
        len(set(per_node.values())) == 1
        for leg in digests.values() for per_node in leg.values())
    configs_agree = all(
        set(digests["control"][pid].values())
        == set(digests["pipelined"][pid].values())
        for pid in digests["control"])
    return {"replicas_agree": replicas_agree,
            "configs_agree": configs_agree,
            "bit_identical": replicas_agree and configs_agree,
            "partitions": n_parts,
            "records_per_partition": records_per_part,
            "digests": digests}


def _obs_digest_leg(workdir: str, n_parts: int = 2,
                    records_per_part: int = 150) -> dict:
    """Fixed mutation sequence (fixed op_ids/timestamps, serial order)
    -> per-partition/replica sha256 of the FSM state, under whatever
    CUBEFS_TRACE setting is active. Run once per door position: equal
    digests prove spans never perturb the state machine."""
    import hashlib

    from ..fs.client import MetaWrapper

    pool, nodes, mps = _mk_meta_cluster(workdir, n_parts, base_id=900)
    wrapper = MetaWrapper({"mps": mps}, pool)
    for mp in mps:
        for i in range(records_per_part):
            wrapper._call(mp, "submit", {"record": {
                "op": "mknod", "parent": 1, "name": f"ob_{i}",
                "type": "file" if i % 2 else "dir", "mode": 0o644,
                "ts": 1000.0 + i, "op_id": f"obs-{mp['pid']}-{i}"}})
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        ids = {pid: {n.addr: n.partitions[pid].apply_id for n in nodes}
               for pid in range(1, n_parts + 1)}
        if all(len(set(v.values())) == 1 for v in ids.values()):
            break
        time.sleep(0.05)
    digests = {str(pid): {n.addr: hashlib.sha256(
        n.partitions[pid].state_bytes()).hexdigest() for n in nodes}
        for pid in range(1, n_parts + 1)}
    if wrapper.fanout is not None:
        wrapper.fanout.close()
    for node in nodes:
        node.stop()
    return digests


def _obs_window(wrapper, mps, threads: int, secs: float,
                tag: str) -> float:
    """One timed create window against an already-running cluster
    (names/op_ids namespaced by `tag` so windows never collide).
    Returns creates/s."""
    import threading as _th

    n_parts = len(mps)
    stop = time.perf_counter() + secs
    counts = [0] * threads

    def _rec(t, i):
        return {"op": "mknod", "parent": 1, "name": f"{tag}_{t}_{i}",
                "type": "file" if i % 2 else "dir", "mode": 0o644,
                "ts": time.time(), "op_id": f"{tag}-{t}-{i}"}

    def worker(t):
        i = 0
        if wrapper.fanout is not None:
            window = max(32, (32 * n_parts) // threads)
            while time.perf_counter() < stop:
                ws = []
                for _ in range(window):
                    mp = mps[(t + i) % n_parts]
                    ws.append(wrapper.fanout.submit_async(mp, _rec(t, i)))
                    i += 1
                for w in ws:
                    w.wait()
                counts[t] += window
            return
        while time.perf_counter() < stop:
            mp = mps[(t + i) % n_parts]
            wrapper._call(mp, "submit", {"record": _rec(t, i)})
            i += 1
            counts[t] += 1

    t0 = time.perf_counter()
    ths = [_th.Thread(target=worker, args=(t,)) for t in range(threads)]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    return round(sum(counts) / (time.perf_counter() - t0), 1)


def obs_tail(workdir: str, threads: int = 16, secs: float = 1.5,
             rounds: int = 3, n_parts: int = 4) -> dict:
    """Meta-write observability A/B (the OBS_TAIL artifact's meta
    section). The trace door is read per request, so the A/B
    interleaves CUBEFS_TRACE=1 / =0 create windows against ONE
    cluster — construction variance and host drift cancel instead of
    landing on one leg. Reports per-window medians, per-stage
    p50/p95/p99/p999 from the shared stage histogram, one rendered
    example trace tree, and the FSM-digest proof that the door changes
    observability only, never state."""
    import statistics

    from ..fs.client import MetaWrapper
    from ..utils import slo as slolib
    from ..utils import trace as tracelib

    on: list[float] = []
    off: list[float] = []
    example = ""
    saved = os.environ.get("CUBEFS_TRACE")
    try:
        os.environ["CUBEFS_TRACE"] = "1"
        pool, nodes, mps = _mk_meta_cluster(
            os.path.join(workdir, "ab"), n_parts, base_id=940)
        wrapper = MetaWrapper({"mps": mps}, pool)
        try:
            _obs_window(wrapper, mps, threads, 0.4, "warm")
            tracelib.reset_collector()
            # ABBA pair ordering so monotone drift cancels across legs
            order: list[bool] = []
            for i in range(rounds):
                order += [True, False] if i % 2 == 0 else [False, True]
            for b, is_on in enumerate(order):
                os.environ["CUBEFS_TRACE"] = "1" if is_on else "0"
                ops = _obs_window(wrapper, mps, threads, secs, f"b{b}")
                (on if is_on else off).append(ops)
            # example tree + submit_coalesce/raft_propose tails ride
            # the per-op client path (the saturated windows drive the
            # fan-out coalescer, whose drains root at the batcher)
            os.environ["CUBEFS_TRACE"] = "1"
            for i in range(8):
                wrapper._call(mps[0], "submit", {"record": {
                    "op": "mknod", "parent": 1, "name": f"ex_{i}",
                    "type": "file", "mode": 0o644, "ts": 2000.0 + i,
                    "op_id": f"obs-ex-{i}"}})
            roots = [s for s in tracelib.finished_spans()
                     if s["op"].startswith("client.submit")
                     and s["parent_id"] is None]
            if roots:
                example = tracelib.render_tree(
                    tracelib.trace_tree(roots[-1]["trace_id"]))
        finally:
            if wrapper.fanout is not None:
                wrapper.fanout.close()
            for node in nodes:
                node.stop()
        stage_tails = slolib.quantiles_from_histogram().get(
            "meta.write", {})
        os.environ["CUBEFS_TRACE"] = "1"
        dig_on = _obs_digest_leg(os.path.join(workdir, "dig_on"))
        os.environ["CUBEFS_TRACE"] = "0"
        dig_off = _obs_digest_leg(os.path.join(workdir, "dig_off"))
    finally:
        if saved is None:
            os.environ.pop("CUBEFS_TRACE", None)
        else:
            os.environ["CUBEFS_TRACE"] = saved
    med_on = statistics.median(on)
    med_off = statistics.median(off)
    # per-pair ratios: window i of each leg ran back-to-back, so host
    # drift cancels inside the pair instead of biasing one leg
    pair_overheads = [round((off_v / on_v - 1.0) * 100, 2)
                      for on_v, off_v in zip(on, off)]
    replicas_agree = all(
        len(set(d.values())) == 1
        for leg in (dig_on, dig_off) for d in leg.values())
    doors_agree = all(set(dig_on[pid].values())
                      == set(dig_off[pid].values()) for pid in dig_on)
    return {
        "path": "meta.write",
        "threads": threads,
        "secs_per_window": secs,
        "window_pairs": rounds,
        "partitions": n_parts,
        "interleaved": True,
        "trace_on": {"median_create_ops": round(med_on, 1),
                     "create_ops": on},
        "trace_off": {"median_create_ops": round(med_off, 1),
                      "create_ops": off},
        "overhead_pct": statistics.median(pair_overheads)
        if pair_overheads else None,
        "pair_overheads_pct": pair_overheads,
        "stage_tails": stage_tails,
        "fsm_digests": {
            "replicas_agree": replicas_agree,
            "trace_door_agrees": doors_agree,
            "bit_identical": replicas_agree and doors_agree,
            "trace_on": dig_on,
            "trace_off": dig_off,
        },
        "example_trace": example,
    }


def _mk_read_cluster(workdir: str, n_meta: int = 2):
    """In-process fs cluster for the read A/B, shaped like the
    deployment the hot-read tier exists for: the client lives in a
    compute-only AZ (az1) with NO datanode replica, storage datanodes
    sit one-per-AZ in az2/az3/az4, and the flash ring has an az1-local
    group (plus a cross-AZ group so slot fallback is exercised). Every
    cold read is a cross-AZ hop; every hot read can stay in az1."""
    from ..fs.datanode import DataNode
    from ..fs.master import Master
    from ..fs.metanode import MetaNode
    from ..fs.remotecache import FlashGroupManager, FlashNode
    from ..utils.rpc import NodePool

    pool = NodePool()
    master = Master(pool)
    pool.bind("master", master)
    metas = []
    for i in range(n_meta):
        node = MetaNode(i, addr=f"meta{i}", node_pool=pool)
        pool.bind(f"meta{i}", node)
        master.register_metanode(f"meta{i}")
        metas.append(node)
    azs = ("az2", "az3", "az4")
    for i in range(3):
        node = DataNode(i, os.path.join(workdir, f"d{i}"), f"data{i}", pool)
        pool.bind(f"data{i}", node)
        master.register_datanode(f"data{i}", zone=azs[i])
    view = master.create_volume("bench", mp_count=2, dp_count=3)
    fgm = FlashGroupManager()
    for gid, az in ((1, "az1"), (2, "az2")):
        pool.bind(f"flash-{az}", FlashNode())
        fgm.register_group(gid, [f"flash-{az}"], az=az)
    return pool, view, fgm, metas


# Cross-AZ round-trip cost injected on the wire during timed windows
# (both doors pay it identically). 1ms + seeded jitter is the usual
# intra-region inter-AZ figure; in-process calls are otherwise free,
# which would erase the topology the tier is built around.
CROSS_AZ_RTT_S = 0.001
CROSS_AZ_JITTER_S = 0.0002


def _rtt_plan(seed: int):
    """Seeded delay-only fault plan: every cross-AZ data/flash read
    pays CROSS_AZ_RTT_S. az1-local flash and (az1-resident) meta RPCs
    are left at in-process speed."""
    from ..utils import faultinject as fi

    plan = fi.FaultPlan(seed=seed)
    for i in range(3):
        plan.on(f"data{i}", "read", kind="delay",
                delay=CROSS_AZ_RTT_S, jitter=CROSS_AZ_JITTER_S)
    plan.on("flash-az2", "cache_get", kind="delay",
            delay=CROSS_AZ_RTT_S, jitter=CROSS_AZ_JITTER_S)
    return plan


def _metric_total(name: str, **match) -> float:
    """Sum a DEFAULT-registry series over label matches (bench-side
    twin of the CLI's /metrics parser)."""
    from ..utils import metrics as mlib

    total = 0.0
    for line in mlib.DEFAULT.render_text().splitlines():
        if not line.startswith(name):
            continue
        head, _, val = line.rpartition(" ")
        if all(f'{k}="{v}"' in head for k, v in match.items()):
            try:
                total += float(val)
            except ValueError:
                continue
    return total


def read_ab(workdir: str, files: int = 48, file_kb: int = 768,
            secs: float = 1.0, rounds: int = 3, zipf_s: float = 1.2,
            seed: int = 11) -> dict:
    """Hot-read tier A/B (the READ_AB artifact): a zipf-skewed read mix
    over ONE cluster, interleaving CUBEFS_READ_CACHE=1 / =0 windows
    (ABBA pairs so host drift cancels). Every read is byte-checked
    against the written payload in BOTH door positions, and the off
    leg is asserted to be the plain (pre-door) ExtentClient path.
    Reports per-window read/s + p99 medians, flash hit ratio, AZ-local
    vs cross-AZ serve counts, singleflight collapses (from a dedicated
    cold-key thundering-herd phase), and the fs.read per-stage tails
    from a trace-on sampling pass.

    Topology model: the client sits in compute-only az1 (see
    _mk_read_cluster); a seeded delay plan charges CROSS_AZ_RTT_S per
    cross-AZ data/flash read RPC in BOTH door positions, so the A/B
    measures exactly what the tier buys — hot reads that stay in az1
    instead of hopping AZs."""
    import random
    import statistics
    import threading

    from ..fs.client import FileSystem
    from ..utils import faultinject as fi
    from ..utils import slo as slolib

    pool, view, fgm, metas = _mk_read_cluster(workdir)
    saved = {k: os.environ.get(k) for k in
             ("CUBEFS_READ_CACHE", "CUBEFS_READ_HOT", "CUBEFS_TRACE")}
    on: list[float] = []
    off: list[float] = []
    on_p99: list[float] = []
    off_p99: list[float] = []
    serves0 = {s: _metric_total("cubefs_readcache_serves_total", scope=s)
               for s in ("az_local", "cross_az")}
    sf0 = _metric_total("cubefs_readcache_singleflight_total")
    try:
        os.environ["CUBEFS_READ_CACHE"] = "0"
        os.environ["CUBEFS_READ_HOT"] = "2"
        os.environ.pop("CUBEFS_TRACE", None)
        fs0 = FileSystem(view, pool)
        rng = random.Random(seed)
        fs0.mkdir("/hot")
        payloads = {}
        for i in range(files):
            payloads[i] = rng.randbytes(file_kb << 10)
            fs0.write_file(f"/hot/f{i}", payloads[i])
        # zipf-skewed access sequence, SHARED by every window: both
        # legs replay the identical byte stream
        weights = [1.0 / (r + 1) ** zipf_s for r in range(files)]
        seq = rng.choices(range(files), weights=weights, k=4096)

        # ONE long-lived client per door position, reused across every
        # window — a real mount's heat tracker doesn't reset each
        # second, and admission must be allowed to reach steady state
        os.environ["CUBEFS_READ_CACHE"] = "1"
        fs_on = FileSystem(view, pool, flash_fgm=fgm, client_az="az1")
        os.environ["CUBEFS_READ_CACHE"] = "0"
        fs_off = FileSystem(view, pool, flash_fgm=fgm, client_az="az1")
        assert fs_off.read_cache is None  # door off == pre-PR path

        def window(with_cache: bool) -> tuple[float, float]:
            fs = fs_on if with_cache else fs_off
            lat: list[float] = []
            t_start = time.perf_counter()
            t_end = t_start + secs
            i = 0
            while time.perf_counter() < t_end:
                fi = seq[i % len(seq)]
                t0 = time.perf_counter()
                got = fs.read_file(f"/hot/f{fi}")
                lat.append(time.perf_counter() - t0)
                if got != payloads[fi]:
                    raise AssertionError(
                        f"byte mismatch on f{fi} (cache={with_cache})")
                i += 1
            rate = i / (time.perf_counter() - t_start)
            p99 = sorted(lat)[min(len(lat) - 1, int(0.99 * len(lat)))]
            return rate, p99 * 1000.0

        with fi.installed(_rtt_plan(seed)):
            window(True)  # warm: fill the flash tier outside the timing
            window(True)  # second pass clears the 2-touch admission gate
            h0, m0 = fs_on.read_cache.hits, fs_on.read_cache.misses
            order: list[bool] = []
            for r in range(rounds):
                order += [True, False] if r % 2 == 0 else [False, True]
            for is_on in order:
                rate, p99 = window(is_on)
                (on if is_on else off).append(rate)
                (on_p99 if is_on else off_p99).append(p99)
            # hit ratio of the TIMED windows only (warm-up misses are
            # admission cost, not steady-state behaviour)
            hits = fs_on.read_cache.hits - h0
            misses = fs_on.read_cache.misses - m0

            # stage-tail sampling pass: trace door on, cache door on —
            # the cache_lookup / cache_fill / datanode_read stages feed
            # the shared request_stage_seconds histogram (the SLO
            # tracker)
            os.environ["CUBEFS_TRACE"] = "1"
            os.environ["CUBEFS_READ_CACHE"] = "1"
            fs_t = FileSystem(view, pool, flash_fgm=fgm, client_az="az1")
            for i in range(512):
                fs_t.read_file(f"/hot/f{seq[i % len(seq)]}")
            stage_tails = slolib.quantiles_from_histogram().get(
                "fs.read", {})

            # thundering-herd phase: N threads race one COLD key; the
            # singleflight door must collapse them onto one cross-AZ
            # fill (followers reuse the leader's bytes)
            os.environ.pop("CUBEFS_TRACE", None)
            os.environ["CUBEFS_READ_HOT"] = "1"
            from ..fs.remotecache import CACHE_BLOCK
            herd_payload = rng.randbytes(CACHE_BLOCK)
            fs0.write_file("/hot/herd", herd_payload)
            fs_h = FileSystem(view, pool, flash_fgm=fgm, client_az="az1")
            herd_errs: list[Exception] = []

            def _herd_read():
                try:
                    if fs_h.read_file("/hot/herd") != herd_payload:
                        raise AssertionError("herd byte mismatch")
                except Exception as e:  # pragma: no cover - surfaced below
                    herd_errs.append(e)

            threads = [threading.Thread(target=_herd_read)
                       for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if herd_errs:
                raise herd_errs[0]
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for m in metas:
            m.stop()
    med_on = statistics.median(on)
    med_off = statistics.median(off)
    med_on_p99 = statistics.median(on_p99)
    med_off_p99 = statistics.median(off_p99)
    serves = {s: _metric_total("cubefs_readcache_serves_total", scope=s)
              - serves0[s] for s in ("az_local", "cross_az")}
    return {
        "path": "fs.read",
        "files": files,
        "file_kb": file_kb,
        "zipf_s": zipf_s,
        "window_secs": secs,
        "window_pairs": rounds,
        "interleaved": True,
        "topology_model": {
            "client_az": "az1",
            "datanode_azs": ["az2", "az3", "az4"],
            "flash_azs": ["az1", "az2"],
            "cross_az_rtt_ms": CROSS_AZ_RTT_S * 1000.0,
            "cross_az_jitter_ms": CROSS_AZ_JITTER_S * 1000.0,
            "note": "seeded delay plan charges the RTT on every "
                    "cross-AZ data/flash read RPC in both door "
                    "positions; az1 is a compute-only AZ",
        },
        "cache_on": {"median_reads_per_s": round(med_on, 1),
                     "reads_per_s": [round(x, 1) for x in on],
                     "median_p99_ms": round(med_on_p99, 3),
                     "p99_ms": [round(x, 3) for x in on_p99]},
        "cache_off": {"median_reads_per_s": round(med_off, 1),
                      "reads_per_s": [round(x, 1) for x in off],
                      "median_p99_ms": round(med_off_p99, 3),
                      "p99_ms": [round(x, 3) for x in off_p99]},
        "speedup": round(med_on / med_off, 2) if med_off else None,
        "p99_reduction": round(med_off_p99 / med_on_p99, 2)
        if med_on_p99 else None,
        "byte_identical": True,  # asserted on every read, both doors
        "door_off_is_plain_path": True,  # asserted per off window
        "hit_ratio": round(hits / (hits + misses), 4)
        if hits + misses else None,
        "serves_by_scope": serves,
        "singleflight_collapses":
            _metric_total("cubefs_readcache_singleflight_total") - sf0,
        "stage_tails": stage_tails,
    }


# WAN round-trip between geo REGIONS (not AZs): ~30ms intra-continent
# is the figure the fenced promote/failback design is built around.
# Charged per geo_ship/geo_resync RPC on the ship edge by a seeded
# plan, so the steady-lag leg measures the pump against real geography.
GEO_WAN_RTT_S = 0.03
GEO_WAN_JITTER_S = 0.005


def geo_ab(workdir: str, files: int = 48, file_kb: int = 768,
           secs: float = 1.0, rounds: int = 3, zipf_s: float = 1.2,
           seed: int = 18, load_secs: float = 3.0) -> dict:
    """Geo-replication A/B (the GEO_AB artifact), three legs:

    1. follower-read: the read_ab zipf mix over ONE cluster measured in
       BOTH roles — PRIMARY windows first, then a demote to FOLLOWING
       and the identical windows again (same long-lived clients, same
       seeded cross-AZ delay plan, ABBA cache on/off pairs). A follower
       region serves reads from local replicated state while mutations
       bounce GeoRedirect 452 (asserted mid-leg), so follower p50/p99
       must sit within 10% of the primary leg AND of the stored
       READ_AB_r11 baselines.
    2. steady-lag: saturated deterministic creates (zipf-skewed across
       partitions, the loadgen mix) against a geo pair with seeded
       GEO_WAN_RTT_S delay on every ship RPC; samples
       cubefs_geo_lag_seconds and the RPO byte ledger while pumping,
       proves lag is bounded (never grows with the run), the pending
       ledger drains to zero once load stops, and per-partition FSM
       digests converge with zero gaps.
    3. geo-off: the identical mutation tape with CUBEFS_GEO=0 against a
       never-attached partition — byte-identical FSM digest to the
       geo-on primary (the tap/gate are invisible to the FSM).
    """
    import random
    import statistics
    from types import SimpleNamespace

    from ..fs import georepl as fsgeo
    from ..fs.client import FileSystem
    from ..fs.metanode import FILE, MetaPartition
    from ..utils import faultinject as fi
    from ..utils import georepl as geo
    from ..utils import metrics as mlib
    from ..utils import rpc as rpclib
    from ..utils.rpc import NodePool

    saved = {k: os.environ.get(k) for k in
             ("CUBEFS_READ_CACHE", "CUBEFS_READ_HOT", "CUBEFS_TRACE",
              "CUBEFS_GEO")}
    out: dict = {}
    metas: list = []
    gws: list = []
    try:
        os.environ["CUBEFS_GEO"] = "1"
        os.environ["CUBEFS_READ_CACHE"] = "0"
        os.environ["CUBEFS_READ_HOT"] = "2"
        os.environ.pop("CUBEFS_TRACE", None)

        # ---------------- leg 1: follower-region read serving ----------
        # ONE metanode so the partitions are standalone FSMs (geo ships
        # standalone clusters only; raft hosts are refused by contract).
        # Reads never touch raft either way, so the window is the same
        # read path READ_AB_r11 measured.
        pool, view, fgm, metas = _mk_read_cluster(workdir, n_meta=1)
        fs0 = FileSystem(view, pool)
        rng = random.Random(seed)
        fs0.mkdir("/hot")
        payloads = {}
        for i in range(files):
            payloads[i] = rng.randbytes(file_kb << 10)
            fs0.write_file(f"/hot/f{i}", payloads[i])
        weights = [1.0 / (r + 1) ** zipf_s for r in range(files)]
        seq = rng.choices(range(files), weights=weights, k=4096)
        os.environ["CUBEFS_READ_CACHE"] = "1"
        fs_on = FileSystem(view, pool, flash_fgm=fgm, client_az="az1")
        os.environ["CUBEFS_READ_CACHE"] = "0"
        fs_off = FileSystem(view, pool, flash_fgm=fgm, client_az="az1")

        gw = fsgeo.GeoGateway("read-region", pool, "geo-read",
                              role="primary")
        gws.append(gw)
        pids = sorted(metas[0].partitions)
        gw.attach_metanode(metas[0],
                           primaries={p: "geo-primary-mn" for p in pids})

        def window(fs) -> tuple[float, list[float]]:
            lat: list[float] = []
            t_start = time.perf_counter()
            t_end = t_start + secs
            i = 0
            while time.perf_counter() < t_end:
                k = seq[i % len(seq)]
                t0 = time.perf_counter()
                got = fs.read_file(f"/hot/f{k}")
                lat.append(time.perf_counter() - t0)
                if got != payloads[k]:
                    raise AssertionError(f"byte mismatch on f{k}")
                i += 1
            return i / (time.perf_counter() - t_start), lat

        # Roles interleave per round through the REAL promote/failback
        # FSM edges (demote / fence+promote / failback_sync+fence+demote)
        # so host-load drift cancels across roles the same way the ABBA
        # pairs cancel it across cache doors. Latencies pool across every
        # window of a (role, door) cell: the pooled p99 over ~N*1000
        # samples is far stabler run to run than a median of per-window
        # p99s (12th-worst of a 1.2k-sample window moves with every
        # scheduler hiccup).
        rates: dict[tuple, list] = {(role, k): []
                                    for role in ("primary", "follower")
                                    for k in (True, False)}
        pooled: dict[tuple, list] = {(role, k): []
                                     for role in ("primary", "follower")
                                     for k in (True, False)}
        tseq = iter(range(1000))

        def _set_role(serving: bool) -> None:
            st = gw.controller.state
            if not serving and st in ("PRIMARY", "PROMOTED"):
                ops = (("demote",) if st == "PRIMARY"
                       else ("failback_sync", "fence", "demote"))
            elif serving and st == "FOLLOWING":
                ops = ("fence", "promote")
            else:
                return
            for op in ops:
                gw.transition(op, op_id=f"geoab-t{next(tseq)}")

        bounce_checked = False
        with fi.installed(_rtt_plan(seed)):
            window(fs_on)  # warm: fill the flash tier outside the timing
            window(fs_on)  # second pass clears the 2-touch admission gate
            for r in range(rounds):
                roles = (("primary", "follower") if r % 2 == 0
                         else ("follower", "primary"))
                for role in roles:
                    _set_role(serving=role == "primary")
                    if role == "follower" and not bounce_checked:
                        bounce_checked = True
                        # the follower region must bounce mutations with
                        # the primary's address while reads serve locally
                        red0 = mlib.geo_redirects.value(
                            part=f"mp:{pids[0]}")
                        try:
                            pool.get(metas[0].addr).call("submit", {
                                "pid": pids[0], "record": {
                                    "op": "mknod", "parent": 1,
                                    "name": "geoab_bounce",
                                    "type": "file", "mode": 0o644,
                                    "ts": 1.0, "op_id": "geoab-bounce"}})
                            raise AssertionError(
                                "follower accepted a mutation")
                        except rpclib.RpcError as e:
                            if e.code != rpclib.GEO_REDIRECT:
                                raise
                        assert mlib.geo_redirects.value(
                            part=f"mp:{pids[0]}") == red0 + 1
                    for is_on in ((True, False) if r % 2 == 0
                                  else (False, True)):
                        rate, lat = window(fs_on if is_on else fs_off)
                        rates[(role, is_on)].append(rate)
                        pooled[(role, is_on)] += lat

        def _pct(lat: list[float], q: float) -> float:
            lat = sorted(lat)
            return lat[min(len(lat) - 1, int(q * len(lat)))] * 1000.0

        legs = {
            role: {
                door: {
                    "median_reads_per_s":
                        round(statistics.median(rates[(role, k)]), 1),
                    "p50_ms": round(_pct(pooled[(role, k)], 0.50), 3),
                    "p99_ms": round(_pct(pooled[(role, k)], 0.99), 3),
                    "reads_per_s":
                        [round(x, 1) for x in rates[(role, k)]],
                    "samples": len(pooled[(role, k)]),
                }
                for door, k in (("cache_on", True), ("cache_off", False))
            }
            for role in ("primary", "follower")
        }

        def _cmp(got: dict, ref: dict, ref_p99: str = "p99_ms") -> dict:
            """Faster-or-equal always passes; slower passes within 10%."""
            rate_ratio = (got["median_reads_per_s"]
                          / ref["median_reads_per_s"])
            p99_ratio = got["p99_ms"] / ref[ref_p99]
            return {"reads_per_s_ratio": round(rate_ratio, 3),
                    "p99_ratio": round(p99_ratio, 3),
                    "within_10pct": rate_ratio >= 0.9 and p99_ratio <= 1.1}

        vs_primary = {d: _cmp(legs["follower"][d], legs["primary"][d])
                      for d in ("cache_on", "cache_off")}
        root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        base = None
        bpath = os.path.join(root, "artifacts", "READ_AB_r11.json")
        if os.path.exists(bpath):
            try:
                with open(bpath) as f:
                    base = json.load(f).get("fs_read")
            except (OSError, ValueError):
                base = None
        vs_r11 = ({d: _cmp(legs["follower"][d], base[d],
                           ref_p99="median_p99_ms")
                   for d in ("cache_on", "cache_off")}
                  if base else None)
        # The primary leg IS the r11 recipe re-run on today's host, so
        # primary/r11 isolates HOST drift (CPU contention at run time)
        # from the follower-role effect; the drift-normalized r11 check
        # is therefore exactly the follower-vs-primary comparison.
        host_drift = ({d: {
            "reads_per_s": round(
                legs["primary"][d]["median_reads_per_s"]
                / base[d]["median_reads_per_s"], 3),
            "p99": round(legs["primary"][d]["p99_ms"]
                         / base[d]["median_p99_ms"], 3)}
            for d in ("cache_on", "cache_off")} if base else None)
        out["follower_read"] = {
            "files": files, "file_kb": file_kb, "zipf_s": zipf_s,
            "window_secs": secs, "window_pairs": rounds,
            "primary": legs["primary"], "follower": legs["follower"],
            "mutation_bounced_452": True,  # asserted mid-leg
            "byte_identical": True,  # asserted on every read, both roles
            "interleaved_roles": True,
            "final_state": gw.controller.state,
            "final_epoch": gw.controller.epoch,
            "vs_primary": vs_primary,
            "vs_read_ab_r11": vs_r11,
            "host_drift_vs_r11": host_drift,
            "baseline_r11": ({d: {k: base[d][k] for k in
                                  ("median_reads_per_s", "median_p99_ms")}
                              for d in ("cache_on", "cache_off")}
                             if base else None),
        }
        for m in metas:
            m.stop()
        metas = []

        # ---------------- leg 2: bounded lag under saturated creates ---
        n_parts = 4
        pids2 = list(range(1, n_parts + 1))
        pool2 = NodePool()
        mps_a = {p: MetaPartition(p, 100, 10**6) for p in pids2}
        mps_b = {p: MetaPartition(p, 100, 10**6) for p in pids2}
        gw_a = fsgeo.GeoGateway("geo-a", pool2, "geo-r1",
                                peer_addr="geo-r2", role="primary")
        gw_b = fsgeo.GeoGateway("geo-b", pool2, "geo-r2",
                                peer_addr="geo-r1", role="follower")
        gws += [gw_a, gw_b]
        gw_a.attach_metanode(
            SimpleNamespace(partitions=mps_a, rafts={}),
            primaries={p: "mn-r1" for p in pids2})
        gw_b.attach_metanode(
            SimpleNamespace(partitions=mps_b, rafts={}),
            primaries={p: "mn-r1" for p in pids2})
        plan = fi.FaultPlan(seed=seed)
        plan.wan(["geo-r1"], ["geo-r2"],
                 delay=GEO_WAN_RTT_S, jitter=GEO_WAN_JITTER_S)
        # Async replication has no equilibrium when the producer outruns
        # the WAN ship path — lag just grows with the run. Real systems
        # bound the RPO window by throttling writers once the unshipped
        # ledger exceeds a cap; the leg does the same, so "bounded lag"
        # means bounded BY the cap, and creates_per_s is the max create
        # rate sustainable under that RPO guarantee.
        rpo_cap = 1 << 20
        base_ctr = {
            "shipped": sum(mlib.geo_shipped.value(part=f"mp:{p}")
                           for p in pids2),
            "applied": sum(mlib.geo_applied.value(
                part=f"mp:{p}", outcome="applied") for p in pids2),
            "gap": sum(mlib.geo_applied.value(
                part=f"mp:{p}", outcome="gap") for p in pids2),
            "duplicate": sum(mlib.geo_applied.value(
                part=f"mp:{p}", outcome="duplicate") for p in pids2),
        }
        pick = rng.choices(pids2, weights=[1.0 / (r + 1) ** zipf_s
                                           for r in range(n_parts)],
                           k=8192)
        lag_samples: list[float] = []
        rpo_samples: list[int] = []
        # continuous pump thread (no interval): the creates run at full
        # client speed while replication keeps pace, so the leg measures
        # whether steady-state lag stays bounded at the WAN cycle time
        # instead of gating the load on the synchronous ship RPC
        import threading as _th
        stop_evt = _th.Event()

        def _pump_loop():
            while not stop_evt.is_set():
                try:
                    gw_a.pump(max_records=2048)
                except Exception:  # noqa: BLE001 - keep the pump alive
                    pass

        pump_th = _th.Thread(target=_pump_loop, daemon=True,
                             name="geoab-pump")
        throttle_waits = 0
        with fi.installed(plan):
            pump_th.start()
            t0 = time.perf_counter()
            stop = t0 + load_secs
            i = 0
            while time.perf_counter() < stop:
                ino = 200 + i
                mps_a[pick[i % len(pick)]].submit({
                    "op": "mk_inode", "ino": ino, "type": FILE,
                    "mode": 0o644, "ts": float(ino),
                    "op_id": f"geoab-{i}"})
                i += 1
                if i % 512 == 0:
                    st = gw_a.status()["parts"]
                    pending = sum(p["pending_bytes"]
                                  for p in st.values())
                    rpo_samples.append(pending)
                    lag_samples.append(max(
                        mlib.geo_lag.value(part=f"mp:{p}", tenant="fs")
                        for p in pids2))
                    while pending > rpo_cap \
                            and time.perf_counter() < stop:
                        # lint: allow[CFB002] RPO backpressure pacing (the measured behaviour), not failover backoff
                        time.sleep(0.001)
                        throttle_waits += 1
                        pending = sum(
                            p["pending_bytes"] for p in
                            gw_a.status()["parts"].values())
            created = i
            dt = time.perf_counter() - t0
            # load stopped: the RPO ledger must drain to zero
            deadline = time.perf_counter() + 30
            while time.perf_counter() < deadline:
                if not any(p["pending_bytes"]
                           for p in gw_a.status()["parts"].values()):
                    break
                # lint: allow[CFB002] deadline-bounded drain poll while the pump thread ships, not failover backoff
                time.sleep(0.02)
            stop_evt.set()
            pump_th.join(timeout=10)
        final_rpo = sum(p["pending_bytes"]
                        for p in gw_a.status()["parts"].values())
        half = max(1, len(lag_samples) // 2)
        lag_max = max(lag_samples) if lag_samples else 0.0
        digests_ok = all(geo.fsm_digest(mps_a[p]) == geo.fsm_digest(mps_b[p])
                         for p in pids2)
        ctr = {k: sum(mlib.geo_applied.value(part=f"mp:{p}", outcome=k)
                      for p in pids2) - base_ctr[k]
               for k in ("applied", "gap", "duplicate")}
        ctr["shipped"] = sum(mlib.geo_shipped.value(part=f"mp:{p}")
                             for p in pids2) - base_ctr["shipped"]
        out["steady_lag"] = {
            "wan_rtt_ms": GEO_WAN_RTT_S * 1000.0,
            "wan_jitter_ms": GEO_WAN_JITTER_S * 1000.0,
            "load_secs": round(dt, 2), "partitions": n_parts,
            "zipf_s": zipf_s, "creates": created,
            "creates_per_s": round(created / dt, 1),
            "shipped_per_s": round(created / dt, 1)
            if final_rpo == 0 else None,
            "rpo_cap_bytes": rpo_cap,
            "throttle_waits": throttle_waits,
            "lag_ms": {
                "max": round(lag_max * 1000.0, 2),
                "p50_first_half": round(statistics.median(
                    lag_samples[:half]) * 1000.0, 2) if lag_samples else 0,
                "p50_second_half": round(statistics.median(
                    lag_samples[half:]) * 1000.0, 2)
                if lag_samples[half:] else 0,
            },
            "rpo_bytes": {"max": max(rpo_samples) if rpo_samples else 0,
                          "final": final_rpo},
            "lag_bounded": lag_max < 1.0,
            "drained": final_rpo == 0,
            "digests_converged": digests_ok,
            "counters": ctr,
        }

        # ---------------- leg 3: CUBEFS_GEO=0 digest identity ----------
        tape = [{"op": "mk_inode", "ino": 200 + i, "type": FILE,
                 "mode": 0o644, "ts": float(200 + i),
                 "op_id": f"tape-{i}"} for i in range(300)]
        pool3 = NodePool()
        mp_p = MetaPartition(1, 100, 10**6)
        mp_f = MetaPartition(1, 100, 10**6)
        gw_p = fsgeo.GeoGateway("tape-a", pool3, "geo-t1",
                                peer_addr="geo-t2", role="primary")
        gw_f = fsgeo.GeoGateway("tape-b", pool3, "geo-t2",
                                peer_addr="geo-t1", role="follower")
        gws += [gw_p, gw_f]
        gw_p.attach_metanode(SimpleNamespace(partitions={1: mp_p},
                                             rafts={}),
                             primaries={1: "mn-t1"})
        gw_f.attach_metanode(SimpleNamespace(partitions={1: mp_f},
                                             rafts={}),
                             primaries={1: "mn-t1"})
        for rec in tape:
            mp_p.submit(dict(rec))
        gw_p.pump(max_records=512)
        d_on = geo.fsm_digest(mp_p)
        d_follower = geo.fsm_digest(mp_f)
        os.environ["CUBEFS_GEO"] = "0"
        plain = MetaPartition(1, 100, 10**6)
        for rec in tape:
            plain.submit(dict(rec))
        d_off = geo.fsm_digest(plain)
        out["geo_off_digest"] = {
            "records": len(tape),
            "digest_geo_on": d_on, "digest_follower": d_follower,
            "digest_geo_off": d_off,
            "geo_off_identical": d_off == d_on,
            "follower_converged": d_follower == d_on,
        }

        out["summary"] = {
            "follower_within_10pct_of_primary": all(
                v["within_10pct"] for v in vs_primary.values()),
            "follower_within_10pct_of_r11_raw": (all(
                v["within_10pct"] for v in vs_r11.values())
                if vs_r11 else None),
            # drift-normalized: follower/(r11*host_drift) == follower/
            # primary — the host-controlled form of the r11 criterion
            "follower_within_10pct_of_r11_drift_normalized": (all(
                v["within_10pct"] for v in vs_primary.values())
                if vs_r11 else None),
            "lag_bounded_and_drained":
                out["steady_lag"]["lag_bounded"]
                and out["steady_lag"]["drained"]
                and out["steady_lag"]["digests_converged"]
                and out["steady_lag"]["counters"]["gap"] == 0,
            "geo_off_digest_identical":
                out["geo_off_digest"]["geo_off_identical"]
                and out["geo_off_digest"]["follower_converged"],
        }
        s = out["summary"]
        s["ok"] = bool(
            s["follower_within_10pct_of_primary"]
            and s["lag_bounded_and_drained"]
            and s["geo_off_digest_identical"]
            and (s["follower_within_10pct_of_r11_raw"]
                 or s["follower_within_10pct_of_r11_drift_normalized"]
                 is not False))
        return out
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for m in metas:
            m.stop()
        for g in gws:
            g.close()


def merge_artifact(path: str, section: str, data: dict) -> None:
    """Read-merge-write one section of a shared artifact JSON, so
    bench_fs and bench_codec can fill their halves independently."""
    existing: dict = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                existing = json.load(f)
        except (OSError, ValueError):
            existing = {}
    existing[section] = data
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(json.dumps(existing, indent=1) + "\n")


def scale_partitions(workdir: str, parts=(1, 16, 64, 256),
                     threads: int = 128, secs: float = 1.5,
                     rounds: int = 3, fan_threads: int = 4) -> dict:
    """The hundreds-of-partitions write bench: aggregate creates/s at
    1→256 metapartitions with the pipelined+fanned-out write path,
    against the unpipelined single-partition control (the per-op shape).
    Each leg is driven at its saturating client shape: the control
    needs one blocking thread per in-flight op (`threads`), the fan-out
    path keeps thousands of ops in flight from a few submit_async
    windows (`fan_threads` — more would only burn scheduler time).
    Rounds alternate control / pipelined legs so drift lands on both
    sides evenly; medians are reported. The FSM identity check runs
    once at the end on a small cluster."""
    import statistics

    out: dict = {"threads": threads, "fan_threads": fan_threads,
                 "secs_per_round": secs, "rounds": rounds,
                 "knobs": _SCALE_KNOBS}
    runs: dict[str, list[dict]] = {"control": []}
    for p in parts:
        runs[f"pipelined_{p}"] = []
    saved = {k: os.environ.get(k)
             for leg in _SCALE_KNOBS.values() for k in leg}
    try:
        for r in range(rounds):
            os.environ.update(_SCALE_KNOBS["control"])
            runs["control"].append(_scale_leg(
                os.path.join(workdir, f"ctl_r{r}"), 1, threads, secs))
            os.environ.update(_SCALE_KNOBS["pipelined"])
            for p in parts:
                runs[f"pipelined_{p}"].append(_scale_leg(
                    os.path.join(workdir, f"p{p}_r{r}"), p, fan_threads,
                    secs))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    for leg, rs in runs.items():
        med = statistics.median(x["create_ops"] for x in rs)
        out[leg] = {"rounds": rs, "median_create_ops": round(med, 1)}
    ctl = out["control"]["median_create_ops"]
    out["speedup_vs_control"] = {
        str(p): round(out[f"pipelined_{p}"]["median_create_ops"] / ctl, 2)
        for p in parts} if ctl else None
    out["fsm_identity"] = fsm_identity_check(
        os.path.join(workdir, "identity"))
    return out


def native_loadgen(view, iters: int = 30_000, conns: int = 4) -> dict:
    """Server-capacity measurement with the C++ load generator
    (metaserve.cc ms_bench): serial round-trips over `conns`
    connections with no Python client in the loop. This is the honest
    server-side number on a box where client and server share cores —
    the Python saturation phase above measures the full-system
    (client-bound) figure."""
    import json as _json
    import uuid

    from ..fs.client import FileSystem
    from ..runtime import fsnative
    from ..utils.rpc import NodePool

    read_addrs = view.get("meta_read_addrs") or {}
    if not read_addrs:
        return {}
    fs = FileSystem(view, NodePool())
    root = f"/lg_{uuid.uuid4().hex[:6]}"
    fs.mkdir(root)
    ino = fs.resolve(root)
    mp = fs.meta._mp_for(ino)
    lib = fsnative.load()
    out: dict = {}
    # hit the node leader-serving the root's partition
    for addr in list(mp.get("addrs") or [mp["addr"]]):
        raddr = read_addrs.get(addr)
        if not raddr:
            continue
        host, port = raddr.rsplit(":", 1)
        args = _json.dumps({"ino": 1, "names": [root.lstrip("/")],
                            "stat": True}).encode()
        dt = lib.ms_bench(host.encode(), int(port), 0x26, args, iters, conns)
        if dt > 0:
            out["walk_stat_ops"] = round(conns * iters / dt, 1)
            break
    fs.unlink(root)
    return out


def deployed_ab(workdir: str, files: int = 300, threads: int = 8,
                procs: int = 8) -> dict:
    """Launch the real-socket deploy cluster and run the mdtest shapes
    three ways: meta ops over HTTP only, over the binary packet plane
    (manager_op.go parity), and with the native C++ read plane
    (metaserve.cc) on top. The in-process NodePool default cannot show
    this — its 'RPC' is a function call — so the transport A/B only
    means something against live listeners. A multi-process saturation
    phase then measures server-side stat capacity past the single
    client's GIL ceiling."""
    from ..deploy.cluster import Cluster as DeployCluster
    from ..fs.client import FileSystem
    from ..utils import rpc
    from ..utils.rpc import NodePool

    topo = {"metanodes": 2, "datanodes": 3, "replicas": 2,
            "volume": {"name": "bench", "mp_count": 2, "dp_count": 3}}
    c = DeployCluster(topo, workdir)
    out: dict = {}
    try:
        state = c.up()
        master = state["roles"]["master"][0]
        view = rpc.call(master, "client_view", {"name": "bench"})[0]["volume"]
        # warmup: per-dp rafts elect after boot; don't time the storm
        # against elections
        warm = FileSystem(view, NodePool())
        deadline = time.time() + 20
        while time.time() < deadline:
            try:
                warm.write_file("/warmup", b"x" * 100)
                warm.unlink("/warmup")
                break
            except Exception:
                time.sleep(0.5)
        http_view = {**view, "meta_packet_addrs": {}, "meta_read_addrs": {}}
        pkt_view = {**view, "meta_read_addrs": {}}
        out["meta_http"] = run(FileSystem(http_view, NodePool()),
                               files=files, io_mb=4, threads=threads)
        out["meta_packet"] = run(FileSystem(pkt_view, NodePool()),
                                 files=files, io_mb=4, threads=threads)
        out["meta_native"] = run(FileSystem(view, NodePool()),
                                 files=files, io_mb=4, threads=threads)
        out["stat_saturation"] = {
            "packet_ops": saturated_stat(pkt_view, procs=procs),
            "native_ops": saturated_stat(view, procs=procs),
        }
        out["native_loadgen"] = native_loadgen(view)
    finally:
        c.down()
    return out


# ------------- elastic metadata plane A/B (fs/split.py) -------------

def _mk_split_cluster(workdir: str, mp_count: int, ino_range: int):
    """Master + 2 replicated metanodes + 3 datanodes + one volume —
    the fs/split.py elastic-plane cluster. The per-partition inode
    range is shrunk (instance override, same knob the tests use) so
    saturated creates actually reach the fill bar inside a bench
    window instead of after 16M inodes."""
    from ..fs.datanode import DataNode
    from ..fs.master import Master
    from ..fs.metanode import MetaNode
    from ..utils.rpc import NodePool

    pool = NodePool()
    master = Master(pool, data_dir=os.path.join(workdir, "master"))
    master.INO_RANGE = ino_range
    pool.bind("master", master)
    nodes = []
    for i in range(2):
        n = MetaNode(900 + i, data_dir=os.path.join(workdir, f"meta{i}"),
                     addr=f"bm{i}", node_pool=pool)
        pool.bind(f"bm{i}", n)
        master.register_metanode(f"bm{i}")
        nodes.append(n)
    datas = []
    for i in range(3):
        d = DataNode(900 + i, os.path.join(workdir, f"data{i}"),
                     f"bd{i}", pool)
        pool.bind(f"bd{i}", d)
        master.register_datanode(f"bd{i}")
        datas.append(d)
    view = master.create_volume("vol1", mp_count=mp_count, dp_count=2)
    return pool, master, nodes, datas, view


def _split_leg(workdir: str, mode: str, threads: int, secs: float,
               ino_range: int = 256) -> dict:
    """One saturated-create round against a fresh WAL-backed cluster.

    ``elastic``  — 4-mp volume, CUBEFS_META_SPLIT=1, a sweeper thread
    drives ``check_meta_partitions`` (fresh ranges appended when the
    tail partition fills) plus ``SplitEngine.balance`` (live range
    migration off hot partitions); ``static`` — the same 4-mp volume
    with the door off and no sweeper, so creates hit the fixed-space
    wall and plateau; ``static64`` — the pre-provisioned 64-partition
    control (META_PIPELINE_AB_r08's scaling ceiling)."""
    import threading as _th

    from ..fs import split as splitmod
    from ..fs.client import FileSystem, FsError
    from ..utils import metrics
    from ..utils import retry as retrylib

    # constant 2 ms jittered backoff while every partition is
    # exhausted/frozen (multiplier 1.0: a stalled loadgen should poll,
    # not exponentiate itself out of the measurement window)
    stall_policy = retrylib.RetryPolicy(base=0.002, cap=0.004,
                                        multiplier=1.0, deadline=None)
    mp_count = 64 if mode == "static64" else 4
    # the bench shrinks the WORLD (inode ranges) so the fill bar is
    # reachable at disk-fsync create rates; the minimum splittable span
    # must shrink with it or the shrunk world could never migrate
    saved_span = splitmod.MIN_SPLIT_SPAN
    splitmod.MIN_SPLIT_SPAN = max(32, ino_range // 8)
    pool, master, nodes, datas, view = _mk_split_cluster(
        workdir, mp_count, ino_range)
    fs = FileSystem(view, pool, master_addr="master")
    wrapper = fs.meta
    base_migr = _metric_sum(metrics.meta_range_migrations)
    base_redir = _metric_sum(metrics.meta_range_redirects)

    stop_at = time.perf_counter() + secs
    stop_evt = _th.Event()
    counts = [0] * threads
    stalls = [0] * threads
    errors: list[str] = []
    sweep = {"appends": 0, "splits": 0, "merges": 0, "failed": 0}

    def sweeper():
        eng = master.split_engine()
        while not stop_evt.is_set():
            try:
                # registration doubles as the heartbeat the liveness
                # window wants when a leg outlives HEARTBEAT_TIMEOUT
                for i in range(len(nodes)):
                    master.register_metanode(f"bm{i}")
                sweep["appends"] += len(master.check_meta_partitions())
                out = eng.balance(max_moves=2, auto=True)
                for act in out["actions"]:
                    k = "splits" if act["kind"] == "split" else "merges"
                    sweep[k] += 1
                sweep["failed"] += len(out["failed"])
            except Exception:  # noqa: BLE001 - sweep must not die
                pass
            stop_evt.wait(0.05)

    def worker(t):
        r = stall_policy.start(op="bench.split_ab.create")
        while time.perf_counter() < stop_at:
            try:
                wrapper.inode_create("file")
                counts[t] += 1
            except FsError as e:
                if e.errno == 28:
                    # every partition exhausted (the static wall) or
                    # momentarily frozen mid-migration: back off
                    stalls[t] += 1
                    r.tick(reason="range-exhausted")
                    continue
                errors.append(f"worker{t}: errno {e.errno}: {e}")
                return
            except Exception as e:  # noqa: BLE001 - keep the AB honest
                errors.append(f"worker{t}: {type(e).__name__}: {e}")
                return

    sw = None
    if mode == "elastic":
        sw = _th.Thread(target=sweeper)
        sw.start()
    ths = [_th.Thread(target=worker, args=(t,)) for t in range(threads)]
    t0 = time.perf_counter()
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    dt = time.perf_counter() - t0
    stop_evt.set()
    if sw is not None:
        sw.join()
    final_mps = len(master.client_view("vol1")["mps"])
    for n in nodes:
        n.stop()
    for d in datas:
        d.stop()
    splitmod.MIN_SPLIT_SPAN = saved_span
    return {
        "mode": mode, "threads": threads, "secs": round(dt, 3),
        "creates": sum(counts),
        "create_ops": round(sum(counts) / dt, 1),
        "alloc_stalls": sum(stalls),
        "mps_start": mp_count, "mps_final": final_mps,
        "sweep": dict(sweep),
        "migrations": int(_metric_sum(metrics.meta_range_migrations)
                          - base_migr),
        "redirects": int(_metric_sum(metrics.meta_range_redirects)
                         - base_redir),
        "errors": errors,
    }


def _split_identity_leg(workdir: str, records_per_part: int = 250) -> dict:
    """CUBEFS_META_SPLIT=0 (the shipped default): drive a FIXED
    mutation tape (fixed op_ids, fixed timestamps, serial order) with
    an auto-balance sweep wedged in the middle. The sweep must report
    itself skipped, and the final per-partition FSM digests must be
    byte-identical across replicas AND across two independent runs —
    the door-off build is bit-for-bit the pre-elastic build."""
    import hashlib

    from ..fs.client import MetaWrapper

    digests: dict[str, dict] = {}
    sweeps = []
    for run_idx in ("a", "b"):
        pool, master, nodes, datas, view = _mk_split_cluster(
            os.path.join(workdir, f"ident_{run_idx}"), 2, 1 << 13)
        wrapper = MetaWrapper(view, pool)
        mps = sorted(view["mps"], key=lambda m: m["start"])
        for mp in mps:
            for i in range(records_per_part):
                # explicit deterministic inos inside the partition's
                # range (disjoint master-minted ranges: only mp 1 holds
                # the root dir, so dentry ops can't span the tape)
                wrapper._call(mp, "submit", {"record": {
                    "op": "mk_inode", "ino": mp["start"] + 1 + i,
                    "type": "file" if i % 2 else "dir", "mode": 0o644,
                    "ts": 1000.0 + i,
                    "op_id": f"ident-{mp['pid']}-{i}"}})
                if i == records_per_part // 2 and mp is mps[0]:
                    # mid-tape: every partition looks hot, yet the
                    # door-off auto sweep must not move a byte
                    master.MP_SPLIT_THRESHOLD = 0.0
                    out = master.split_engine().balance(max_moves=4,
                                                        auto=True)
                    sweeps.append({"skipped": bool(out.get("skipped")),
                                   "actions": len(out["actions"])})
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            ids = {mp["pid"]: {n.addr: n.partitions[mp["pid"]].apply_id
                               for n in nodes} for mp in mps}
            if all(len(set(v.values())) == 1 for v in ids.values()):
                break
            time.sleep(0.05)
        digests[run_idx] = {
            str(mp["pid"]): {n.addr: hashlib.sha256(
                n.partitions[mp["pid"]].state_bytes()).hexdigest()
                for n in nodes}
            for mp in mps}
        for n in nodes:
            n.stop()
        for d in datas:
            d.stop()
    replicas_agree = all(
        len(set(per_node.values())) == 1
        for run in digests.values() for per_node in run.values())
    runs_agree = all(
        set(digests["a"][pid].values()) == set(digests["b"][pid].values())
        for pid in digests["a"])
    return {"sweeps_inert": all(s["skipped"] and not s["actions"]
                                for s in sweeps),
            "replicas_agree": replicas_agree,
            "runs_agree": runs_agree,
            "bit_identical": replicas_agree and runs_agree,
            "records_per_partition": records_per_part,
            "digests": digests}


def split_ab(workdir: str, threads: int = 12, secs: float = 4.0,
             rounds: int = 2, ino_range: int = 256) -> dict:
    """Elastic metadata plane A/B: ABBA rounds of saturated creates on
    a 4-mp volume that auto-splits under load vs the same volume held
    static (the fixed-space plateau), a pre-provisioned static-64
    ceiling reference with a half-threads loadgen probe (server-bound
    evidence), and the door-off digest-identity leg."""
    legs: dict[str, list] = {"elastic": [], "static": []}
    order: list[str] = []
    for r in range(max(1, rounds)):
        order += (["elastic", "static"] if r % 2 == 0
                  else ["static", "elastic"])
    saved = os.environ.get("CUBEFS_META_SPLIT")
    try:
        for i, mode in enumerate(order):
            os.environ["CUBEFS_META_SPLIT"] = \
                "1" if mode == "elastic" else "0"
            legs[mode].append(_split_leg(
                os.path.join(workdir, f"{mode}{i}"), mode, threads,
                secs, ino_range))
        os.environ["CUBEFS_META_SPLIT"] = "0"
        ceiling = _split_leg(os.path.join(workdir, "ceil"), "static64",
                             threads, secs, ino_range)
        probe = _split_leg(os.path.join(workdir, "probe"), "static64",
                           max(1, threads // 2), secs, ino_range)
        os.environ.pop("CUBEFS_META_SPLIT", None)
        identity = _split_identity_leg(workdir)
    finally:
        if saved is None:
            os.environ.pop("CUBEFS_META_SPLIT", None)
        else:
            os.environ["CUBEFS_META_SPLIT"] = saved

    def med(xs):
        return sorted(xs)[len(xs) // 2]

    e_ops = med([l["create_ops"] for l in legs["elastic"]])
    s_ops = med([l["create_ops"] for l in legs["static"]])
    e_creates = med([l["creates"] for l in legs["elastic"]])
    s_creates = med([l["creates"] for l in legs["static"]])
    # doubling the loadgen must NOT double throughput, else the bench
    # measured the client, not the server
    server_bound = (ceiling["create_ops"]
                    < 1.5 * max(1.0, probe["create_ops"]))
    summary = {
        "elastic_create_ops": e_ops, "static_create_ops": s_ops,
        "elastic_creates": e_creates, "static_creates": s_creates,
        "static64_ceiling_ops": ceiling["create_ops"],
        "elastic_final_mps": med([l["mps_final"]
                                  for l in legs["elastic"]]),
        "elastic_migrations": med([l["migrations"]
                                   for l in legs["elastic"]]),
        "scaling_past_plateau": e_creates > s_creates and e_ops > s_ops,
        "server_bound": server_bound,
        "door_off_identical": identity["bit_identical"],
        "ok": (e_creates > s_creates and e_ops > s_ops and server_bound
               and identity["bit_identical"]
               and not any(l["errors"] for ls in legs.values()
                           for l in ls)),
    }
    return {"config": {"threads": threads, "secs": secs,
                       "rounds": rounds, "order": order,
                       "ino_range": ino_range},
            "legs": legs, "static64_ceiling": ceiling,
            "loadgen_probe": probe, "identity": identity,
            "summary": summary}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="cubefs-tpu-torch-fs-bench")
    ap.add_argument("--master")
    ap.add_argument("--vol")
    ap.add_argument("--files", type=int, default=200)
    ap.add_argument("--io-mb", type=int, default=16)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--deploy", action="store_true",
                    help="real-socket cluster; A/B meta HTTP vs packet "
                         "vs native read plane")
    ap.add_argument("--procs", type=int, default=8,
                    help="client processes for the saturation phase")
    ap.add_argument("--write-ab", action="store_true",
                    help="write-side capacity A/B: create saturation "
                         "with group commit off vs on")
    ap.add_argument("--secs", type=float, default=3.0,
                    help="seconds per saturation leg")
    ap.add_argument("--cap-threads", type=int, default=384,
                    help="concurrent creates for the in-process "
                         "server-capacity leg")
    ap.add_argument("--wire-ab", action="store_true",
                    help="packet-plane mux A/B: ABBA CUBEFS_PKT_MUX "
                         "1,0,0,1 over blob put/get, meta write, fs "
                         "read + FSM digest identity + saturated "
                         "create with CPU attribution")
    ap.add_argument("--obs-tail", action="store_true",
                    help="instrumentation overhead A/B (CUBEFS_TRACE=1 "
                         "vs 0) + per-stage meta.write tails + FSM "
                         "digest proof; merges into --out")
    ap.add_argument("--read-ab", action="store_true",
                    help="hot-read tier A/B: zipf read mix with "
                         "CUBEFS_READ_CACHE=1 vs 0, byte-identity "
                         "checked; merges into --out")
    ap.add_argument("--geo-ab", action="store_true",
                    help="geo-replication A/B: follower-region read "
                         "p50/p99 vs primary role + READ_AB_r11 "
                         "baseline, bounded ship lag under saturated "
                         "creates with WAN delay, CUBEFS_GEO=0 digest "
                         "identity; merges into --out")
    ap.add_argument("--split-ab", action="store_true",
                    help="elastic metadata plane A/B: ABBA saturated "
                         "creates on a 4-mp auto-splitting volume vs "
                         "the static plateau + static-64 ceiling, "
                         "door-off FSM digest identity")
    ap.add_argument("--scale-partitions", action="store_true",
                    help="aggregate creates/s at 1..256 metapartitions: "
                         "pipelined replication + client fan-out vs the "
                         "unpipelined single-partition control")
    ap.add_argument("--parts", type=int, nargs="+",
                    default=[1, 16, 64, 256],
                    help="partition counts for the scale sweep")
    ap.add_argument("--rounds", type=int, default=3,
                    help="alternating rounds per leg (median reported)")
    ap.add_argument("--out", help="also write the result JSON here")
    args = ap.parse_args(argv)
    metas = []
    if args.wire_ab:
        workdir = tempfile.mkdtemp(prefix="cubefs-bench-wireab-")
        res = wire_ab(workdir)
        print(json.dumps(res, indent=1))
        if args.out:
            merge_artifact(args.out, "wire_ab", res)
        ok = res["summary"]["fsm_digest_identical"] \
            and res["summary"]["blob_bytes_identical"]
        raise SystemExit(0 if ok else 1)
    if args.obs_tail:
        workdir = tempfile.mkdtemp(prefix="cubefs-bench-obs-")
        res = obs_tail(workdir, threads=args.threads, secs=args.secs,
                       rounds=args.rounds)
        print(json.dumps(res, indent=1))
        if args.out:
            merge_artifact(args.out, "meta_write", res)
        return
    if args.read_ab:
        workdir = tempfile.mkdtemp(prefix="cubefs-bench-readab-")
        res = read_ab(workdir, secs=args.secs, rounds=args.rounds)
        print(json.dumps(res, indent=1))
        if args.out:
            merge_artifact(args.out, "fs_read", res)
        return
    if args.geo_ab:
        workdir = tempfile.mkdtemp(prefix="cubefs-bench-geoab-")
        res = geo_ab(workdir, secs=args.secs, rounds=args.rounds)
        print(json.dumps(res, indent=1))
        if args.out:
            merge_artifact(args.out, "geo_ab", res)
        raise SystemExit(0 if res["summary"]["ok"] else 1)
    if args.split_ab:
        workdir = tempfile.mkdtemp(prefix="cubefs-bench-splitab-")
        res = split_ab(workdir, threads=args.threads, secs=args.secs,
                       rounds=args.rounds)
        text = json.dumps(res, indent=1)
        if args.out:
            with open(args.out, "w") as f:
                f.write(text)
        print(text)
        raise SystemExit(0 if res["summary"]["ok"] else 1)
    if args.scale_partitions:
        workdir = tempfile.mkdtemp(prefix="cubefs-bench-scale-")
        res = scale_partitions(workdir, parts=tuple(args.parts),
                               threads=args.cap_threads, secs=args.secs,
                               rounds=args.rounds)
        text = json.dumps(res, indent=1)
        if args.out:
            with open(args.out, "w") as f:
                f.write(text)
        print(text)
        return
    if args.write_ab:
        workdir = tempfile.mkdtemp(prefix="cubefs-bench-writeab-")
        print(json.dumps(write_ab(workdir, procs=args.procs,
                                  threads=args.threads, secs=args.secs,
                                  cap_threads=args.cap_threads)))
        return
    if args.deploy:
        workdir = tempfile.mkdtemp(prefix="cubefs-bench-deploy-")
        print(json.dumps(deployed_ab(workdir, files=args.files,
                                     threads=args.threads,
                                     procs=args.procs)))
        return
    if args.master:
        from ..fs.client import FileSystem
        from ..utils import rpc
        from ..utils.rpc import NodePool

        view = rpc.call(args.master, "client_view",
                        {"name": args.vol})[0]["volume"]
        fs = FileSystem(view, NodePool())
    else:
        workdir = tempfile.mkdtemp(prefix="cubefs-bench-")
        fs, metas = _inprocess_fs(workdir)
    print(json.dumps(run(fs, args.files, args.io_mb, args.threads)))
    for m in metas:
        m.stop()


if __name__ == "__main__":
    main()
