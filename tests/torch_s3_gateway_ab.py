"""The S3 gateway, the port's against the reference's, on the CPU.

``--listings`` (the default): the launcher's file-system plane of one
package (a master, 3 metanodes, 4 datanodes at replicas 3, a volume of 3
meta and 4 data partitions, each a process), with one ``objectnode`` role
of each package over it; 1,024 objects of 4 KiB PUT from 8 threads, then
``--listings`` ListObjectsV2 of them (pages of 512) on each gateway, the
two taking turns. One JSON line a listing: its ms, its pages' ms, the
gateway process's CPU seconds and the host's steal share during it; at
every 20th, the gateway's threads, descriptors and RSS. ``--runs`` fresh
clusters of each package in turn.

    JAX_PLATFORMS=cpu python tests/torch_s3_gateway_ab.py --runs 3 --out ab.json

``--small-get``: one in-process cluster and a gateway over it, a 4 KiB GET
100 times on one keep-alive connection, with Nagle's algorithm and
without (``disable_nagle_algorithm`` of the gateway's handler), in turns:
the p50 and p90 of each.
"""

import argparse
import hashlib
import http.client
import json
import os
import pathlib
import shutil
import statistics
import sys
import tempfile
import threading
import time
import urllib.parse
import xml.etree.ElementTree as ET

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
# the reference's launcher starts its roles with `python -m cubefs_tpu.cmd`
os.environ["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)

from cubefs_tpu_torch.fs import s3auth  # noqa: E402

OWNER = {"access_key": "AKIDABOWNER000000001", "secret_key": "ab-owner-secret-key"}
USERS = [{**OWNER, "grants": {"vol1": "rw"}}]
TOPO = {"metanodes": 3, "datanodes": 4, "replicas": 3,
        "volume": {"name": "vol1", "mp_count": 3, "dp_count": 4}}


class S3:
    """SigV4-signed requests, one keep-alive connection a thread."""

    def __init__(self, addr: str):
        self.addr, self.local = addr, threading.local()

    def req(self, method: str, path: str, body: bytes = b"", query: str = ""):
        amz = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        h = {"host": self.addr, "x-amz-date": amz,
             "x-amz-content-sha256": hashlib.sha256(body).hexdigest()}
        h["authorization"] = s3auth.sign_v4(method, path, query, h, body, OWNER["access_key"],
                                            OWNER["secret_key"], amz)
        conn = getattr(self.local, "conn", None)
        if conn is None:
            host, port = self.addr.rsplit(":", 1)
            conn = self.local.conn = http.client.HTTPConnection(host, int(port), timeout=600)
        conn.request(method, path + (f"?{query}" if query else ""), body=body or None, headers=h)
        resp = conn.getresponse()
        return resp.status, resp.read()


def cpu_s(pid: int) -> float:
    with open(f"/proc/{pid}/stat") as f:
        v = f.read().rsplit(")", 1)[1].split()
    return (int(v[11]) + int(v[12])) / os.sysconf("SC_CLK_TCK")


def host_ticks() -> tuple[int, int]:
    """(steal, all) jiffies of the host's CPUs."""
    v = [int(x) for x in open("/proc/stat").readline().split()[1:9]]
    return v[7], sum(v)


def proc_stats(pid: int) -> dict:
    out = {"fds": len(os.listdir(f"/proc/{pid}/fd"))}
    with open(f"/proc/{pid}/status") as f:
        for ln in f:
            if ln.startswith(("Threads:", "VmRSS:")):
                k, v = ln.split(":", 1)
                out[k] = int(v.split()[0])
    return out


def listing(s3: S3) -> list[float]:
    token, keys, pages = None, 0, []
    while True:
        q = {"list-type": "2", "max-keys": "512", "prefix": "small/"}
        if token:
            q["continuation-token"] = token
        t = time.perf_counter()
        st, body = s3.req("GET", "/bkt", query=urllib.parse.urlencode(q))
        pages.append((time.perf_counter() - t) * 1e3)
        assert st == 200, body[:300]
        tags = [(e.tag.rsplit("}", 1)[-1], e.text) for e in ET.fromstring(body).iter()]
        keys += sum(1 for tag, _ in tags if tag == "Key")
        token = next((text for tag, text in tags if tag == "NextContinuationToken"), None)
        if ("IsTruncated", "true") not in tags:
            break
    assert keys == 1024, keys
    return pages


def listings_run(cluster_pkg: str, run: int, n: int) -> list[dict]:
    from cubefs_tpu.deploy import cluster as ref_cluster
    from cubefs_tpu_torch.deploy import cluster as port_cluster

    launchers = {"port": port_cluster, "ref": ref_cluster}
    wd = tempfile.mkdtemp(prefix=f"s3ab-{cluster_pkg}-")
    c = launchers[cluster_pkg].Cluster(TOPO, wd)
    gws, out = {}, []
    try:
        master = c.up()["roles"]["master"][0]
        for pkg, mod in launchers.items():
            cfg = {"name": f"objectnode-{pkg}", "master_addr": master,
                   "vols": {"bkt": "vol1"}, "users": USERS}
            proc = mod.Proc("objectnode", {**cfg, "role": "objectnode"}, wd)
            proc.name = cfg["name"]
            c.procs.append(proc)
            gws[pkg] = (S3(proc.wait_addr()), proc.p.pid)
        s3 = gws["port"][0]
        deadline = time.monotonic() + 120
        while s3.req("PUT", "/bkt/warmup", b"w")[0] != 200:
            assert time.monotonic() < deadline, "the first PUT never succeeded"
            time.sleep(0.2)
        body = os.urandom(4096)

        def put(i):
            for j in range(i, 1024, 8):
                assert s3.req("PUT", f"/bkt/small/o{j:05d}", body)[0] == 200
        threads = [threading.Thread(target=put, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for k in range(n):
            for pkg in (("port", "ref") if k % 2 == 0 else ("ref", "port")):
                gw, pid = gws[pkg]
                c0, h0, t0 = cpu_s(pid), host_ticks(), time.perf_counter()
                pages = listing(gw)
                ms = (time.perf_counter() - t0) * 1e3
                h1 = host_ticks()
                rec = {"cluster": cluster_pkg, "run": run, "listing": k, "gateway": pkg,
                       "ms": ms, "pages_ms": pages, "gateway_cpu_s": cpu_s(pid) - c0,
                       "steal_share": (h1[0] - h0[0]) / max(1, h1[1] - h0[1])}
                if k % 20 == 0 or k == n - 1:
                    rec["gateway_process"] = proc_stats(pid)
                print(json.dumps(rec), flush=True)
                out.append(rec)
    finally:
        c.down()
        shutil.rmtree(wd, ignore_errors=True)
    return out


def small_get(rounds: int = 4, n: int = 100) -> list[dict]:
    from test_torch_fs import PORT, WireFs, _close, first_mkdir
    from cubefs_tpu_torch.fs.objectnode import ObjectNode

    root = tempfile.mkdtemp(prefix="s3ab-get-")
    c = WireFs(PORT, pathlib.Path(root))
    fs = PORT.FileSystem(c.view, PORT.rpc.NodePool())
    out = []
    try:
        first_mkdir(fs, "/d")
        for j in range(20):
            fs.write_file(f"/d/o{j}", b"x" * 4096)
        for r in range(rounds):
            gw = ObjectNode({"bkt": fs})
            gw._httpd.RequestHandlerClass.disable_nagle_algorithm = bool(r % 2)
            gw.start()
            host, port = gw.addr.rsplit(":", 1)
            conn = http.client.HTTPConnection(host, int(port), timeout=60)
            ms = []
            for k in range(n):
                t = time.perf_counter()
                conn.request("GET", f"/bkt/d/o{k % 20}")
                resp = conn.getresponse()
                assert resp.status == 200 and len(resp.read()) == 4096
                ms.append((time.perf_counter() - t) * 1e3)
            conn.close()
            gw.stop()
            ms.sort()
            rec = {"nodelay": bool(r % 2), "p50_ms": statistics.median(ms),
                   "p90_ms": ms[int(0.9 * n) - 1]}
            print(json.dumps(rec), flush=True)
            out.append(rec)
    finally:
        _close(fs)
        c.stop()
        shutil.rmtree(root, ignore_errors=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--small-get", action="store_true", help="Nagle's cost on a 4 KiB GET")
    ap.add_argument("--runs", type=int, default=3, help="clusters of each package")
    ap.add_argument("--listings", type=int, default=60, help="listings on each gateway a run")
    ap.add_argument("--out", default=None, help="write every record here as JSON")
    args = ap.parse_args(argv)
    if args.small_get:
        recs = small_get()
    else:
        recs = [rec for run in range(args.runs) for pkg in ("port", "ref")
                for rec in listings_run(pkg, run, args.listings)]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(recs, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
