"""Group commit and elections under CPU contention, the port against the
reference: the clusters of ``tests/test_meta_batch.py``'s
``test_concurrent_creates_batch_entries_and_fsyncs`` (two metanodes, one
replicated partition, 16 threads x 12 creates) and of
``tests/test_fs_e2e.py``'s ``test_master_raft_replication`` (three
masters electing), each run in a fresh process of its own beside
``--busy`` processes that spin on the CPU, the packages taking turns.

    JAX_PLATFORMS=cpu python tests/torch_group_commit_ab.py --runs 20 --busy 11

One JSON line a run: the package, the raft entries, drains and WAL
fsyncs of the 192 creates, whether the term moved during them, and the
seconds to the masters' first leader; then a summary by package. The
scenario's bounds are 64 entries and 64 fsyncs.

``--sizes`` also records each drain's width (a wrapper around the
coalescer's ``_SubmitBatcher._land``, in both packages alike: it adds a
clock read to every drain). ``--port-ref-observe`` adds a third kind of
run, the port with the reference's ``Histogram.observe`` (one call, no
``observe_many``).
"""

import argparse
import bisect
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules(pkg: str):
    if pkg == "port":
        from cubefs_tpu_torch.fs import metanode as mn
        from cubefs_tpu_torch.fs.master import Master
        from cubefs_tpu_torch.utils import metrics, rpc
    else:
        from cubefs_tpu.fs import metanode as mn
        from cubefs_tpu.fs.master import Master
        from cubefs_tpu.utils import metrics, rpc
    return mn, Master, metrics, rpc


def _reference_observe(self, value: float, **labels) -> None:
    k = self._key(labels)
    with self._lock:
        s = self._series.get(k)
        if s is None:
            s = self._series[k] = {"count": 0, "sum": 0.0, "buckets": [0] * len(self.BUCKETS)}
        s["count"] += 1
        s["sum"] += value
        for j in range(bisect.bisect_left(self.BUCKETS, value), len(self.BUCKETS)):
            s["buckets"][j] += 1


def one_run(pkg: str, root: str, sizes: list | None = None) -> dict:
    mn, Master, metrics, rpc = _modules(pkg)
    if sizes is not None:
        land = mn._SubmitBatcher._land

        def sized(self, batch):
            t0 = time.perf_counter()
            land(self, batch)
            sizes.append((len(batch), time.perf_counter() - t0))

        mn._SubmitBatcher._land = sized
    pool = rpc.NodePool()
    masters = [Master(pool, data_dir=f"{root}/{n}", me=n, peers=["ma", "mb", "mc"],
                      allow_single_node=True, replicas=1) for n in ("ma", "mb", "mc")]
    for n, m in zip(("ma", "mb", "mc"), masters):
        pool.bind(n, m)
    t0 = time.monotonic()
    while sum(m.is_leader() for m in masters) != 1 and time.monotonic() - t0 < 30:
        time.sleep(0.01)
    leader_s = time.monotonic() - t0
    for m in masters:
        m.raft.stop()

    nodes = []
    for i, a in enumerate(("bm0", "bm1")):
        node = mn.MetaNode(100 + i, data_dir=f"{root}/{a}", addr=a, node_pool=pool)
        pool.bind(a, node)
        nodes.append(node)
    for node in nodes:
        node.create_partition(7, 1, 1 << 20, peers=["bm0", "bm1"])
    t0 = time.monotonic()
    leader = None
    while leader is None and time.monotonic() - t0 < 30:
        leader = next((n for n in nodes if n.rafts[7].status()["role"] == "leader"), None)
        time.sleep(0.02)
    client = pool.get(leader.addr)
    counts = (metrics.raft_proposals, metrics.raft_proposal_batches, metrics.raft_wal_fsyncs)
    before = [c.value(group="mp7") for c in counts]
    term = leader.rafts[7].status()["term"]
    gate, errors = threading.Barrier(16), []

    def worker(t):
        try:
            gate.wait(timeout=10)
            for i in range(12):
                client.call("submit", {"pid": 7, "record": {
                    "op": "mknod", "parent": mn.ROOT_INO, "name": f"f{t}_{i}", "type": mn.FILE,
                    "mode": 0o644, "ts": 1.0, "op_id": f"c{t}-{i}"}})
        except Exception as e:  # noqa: BLE001  (reported in the run's line)
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    entries, drains, fsyncs = (c.value(group="mp7") - b for c, b in zip(counts, before))
    out = {"pkg": pkg, "entries": entries, "drains": drains, "fsyncs": fsyncs,
           "term_moved": leader.rafts[7].status()["term"] != term, "errors": errors[:2],
           "masters_leader_s": round(leader_s, 3)}
    if sizes is not None:
        out["sizes"] = [n for n, _ in sizes]
        out["drain_ms"] = [round(dt * 1e3, 2) for _, dt in sizes]
    for node in nodes:
        node.stop()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=20, help="runs of each package")
    ap.add_argument("--busy", type=int, default=11, help="processes spinning on the CPU")
    ap.add_argument("--sizes", action="store_true", help="record each drain's width")
    ap.add_argument("--port-ref-observe", action="store_true",
                    help="also run the port with the reference's Histogram.observe")
    ap.add_argument("--one", choices=("port", "ref", "port-ref-observe"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        sys.path.insert(0, ROOT)
        pkg = "ref" if args.one == "ref" else "port"
        if args.one == "port-ref-observe":
            from cubefs_tpu_torch.utils import metrics

            metrics.Histogram.observe = _reference_observe
        with tempfile.TemporaryDirectory() as d:
            out = one_run(pkg, d, [] if args.sizes else None)
        print(json.dumps({**out, "pkg": args.one}), flush=True)
        os._exit(0)  # leftover daemon threads of the stopped nodes
    kinds = ("port", "port-ref-observe", "ref") if args.port_ref_observe else ("port", "ref")
    spin = [subprocess.Popen([sys.executable, "-c", "while True: pass"]) for _ in range(args.busy)]
    rows = []
    try:
        for _ in range(args.runs):
            for pkg in kinds:
                out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", pkg,
                                      *(["--sizes"] if args.sizes else [])],
                                     capture_output=True, text=True, timeout=300)
                row = json.loads(out.stdout.strip().splitlines()[-1])
                print(json.dumps(row), flush=True)
                rows.append(row)
    finally:
        for p in spin:
            p.kill()
            p.wait()
    for pkg in kinds:
        mine = [r for r in rows if r["pkg"] == pkg]
        print(json.dumps({"summary": pkg, "runs": len(mine),
                          "entries": [min(r["entries"] for r in mine),
                                      max(r["entries"] for r in mine)],
                          "over_24_entries": sum(r["entries"] > 24 for r in mine),
                          "over_the_bound": sum(r["entries"] > 64 or r["fsyncs"] > 64
                                                for r in mine),
                          "term_moved": sum(r["term_moved"] for r in mine),
                          "masters_leader_s_max": max(r["masters_leader_s"] for r in mine)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
