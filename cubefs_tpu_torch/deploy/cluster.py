"""Cluster launcher: the blob half of the reference's docker-compose analog.

The port's copy of ``cubefs_tpu/deploy/cluster.py`` for the blob plane:
one topology JSON spawns every role as a local process (``python -m
cubefs_tpu_torch.cmd``), waits for each to listen, and writes a state
file with all addresses (``<workdir>/cluster.json``).

  python -m cubefs_tpu_torch.deploy.cluster --topo topo.json --workdir /tmp/c1

Topology JSON (all keys optional), the reference's blob keys:
  {"blobnodes": 6, "disks_per_blobnode": 9, "blob_azs": 3,
   "access": true, "blob_size": 8388608, "codec": false}

and the port's own:
  "proxy": false       a proxy role, whose address access is given
  "scheduler": false   a scheduler role with its own data directory
  "ec_engine": null    access's and codec's engine (the roles' defaults)
  "audit_dir": null    every role's audit log and slow-trace log
  "device": null       every role's card (None: the current CUDA
                       device), or "cpu" for the plain versions

blob_azs spreads blobnodes across failure domains round-robin: an int
yields AZ names az0..azN-1, a list supplies the names. The file-system
plane (master, metanodes, datanodes, objectnode, fsgateway, console) is
not ported: a topology that asks for any of it raises
``NotImplementedError`` (ROADMAP.md §1 item 6), and absent counts are 0
(the reference starts 3 metanodes and 4 datanodes by default).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time

FS_ROLES = ("metanodes", "datanodes", "objectnode", "fsgateway", "console")
# the directory that holds the package: spawned roles import it from there
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class Proc:
    def __init__(self, role: str, cfg: dict, workdir: str):
        self.role = role
        self.name = cfg.get("name", role)
        path = os.path.join(workdir, f"{self.name}.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        self.log_path = os.path.join(workdir, f"{self.name}.log")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_ROOT, env.get("PYTHONPATH")) if p)
        with open(self.log_path, "w") as log:
            self.p = subprocess.Popen(
                [sys.executable, "-m", "cubefs_tpu_torch.cmd", "-c", path],
                stdout=log, stderr=subprocess.STDOUT, env=env,
            )
        self.addr: str | None = None

    def _log(self) -> str:
        with open(self.log_path) as f:
            return f.read()

    def wait_addr(self, timeout: float = 120.0) -> str:
        deadline = time.time() + timeout
        while time.time() < deadline:
            for line in self._log().splitlines():
                if "listening on" in line:
                    self.addr = line.strip().rsplit(" ", 1)[-1]
                    return self.addr
            if self.p.poll() is not None:
                raise RuntimeError(f"{self.name} exited: {self._log()[-800:]}")
            time.sleep(0.1)
        raise TimeoutError(f"{self.name} did not come up; log: {self.log_path}")


class Cluster:
    def __init__(self, topo: dict, workdir: str, timeout: float = 120.0):
        asked = [k for k in FS_ROLES if topo.get(k)]
        if asked:
            raise NotImplementedError(
                f"file-system roles {asked}: the port has no file-system "
                "plane yet (ROADMAP.md §1 item 6)")
        self.topo = topo
        self.workdir = workdir
        self.timeout = timeout
        os.makedirs(workdir, exist_ok=True)
        self.procs: list[Proc] = []
        self.state: dict = {"roles": {}}

    def _start(self, role: str, cfg: dict) -> Proc:
        cfg["role"] = role
        for key in ("device", "audit_dir"):
            if self.topo.get(key) is not None:
                cfg[key] = self.topo[key]
        p = Proc(role, cfg, self.workdir)
        self.procs.append(p)
        return p

    def _wait(self, procs: list[Proc]) -> list[str]:
        addrs = [p.wait_addr(self.timeout) for p in procs]
        for p, addr in zip(procs, addrs):
            self.state["roles"].setdefault(p.role, []).append(addr)
        return addrs

    def _spawn(self, role: str, cfg: dict) -> str:
        return self._wait([self._start(role, cfg)])[0]

    def up(self) -> dict:
        t = self.topo
        engine = {"ec_engine": t["ec_engine"]} if t.get("ec_engine") else {}
        if t.get("blobnodes"):
            cm = self._spawn("clustermgr", {
                "allow_colocated_units": t.get("blobnodes", 1) == 1,
                "data_dir": os.path.join(self.workdir, "cm")})
            azs = t.get("blob_azs")
            az_names = ([f"az{j}" for j in range(azs)]
                        if isinstance(azs, int) else list(azs or ()))
            nodes = []
            for i in range(t["blobnodes"]):
                dirs = [os.path.join(self.workdir, f"bn{i}d{d}")
                        for d in range(t.get("disks_per_blobnode", 9))]
                bn_cfg = {"name": f"blobnode{i}", "node_id": i,
                          "clustermgr_addr": cm, "data_dirs": dirs}
                if az_names:
                    # round-robin AZ assignment; each node is its own rack
                    bn_cfg["az"] = az_names[i % len(az_names)]
                    bn_cfg["rack"] = f"{bn_cfg['az']}-r{i // len(az_names)}"
                nodes.append(self._start("blobnode", bn_cfg))
            self._wait(nodes)  # started together: each opens its own card context
            proxy = (self._spawn("proxy", {"clustermgr_addr": cm})
                     if t.get("proxy") else None)
            if t.get("access", True):
                access_cfg = {"clustermgr_addr": cm,
                              "blob_size": t.get("blob_size", 8 << 20), **engine}
                if proxy:
                    access_cfg["proxy_addr"] = proxy
                if az_names:
                    access_cfg["az"] = az_names[0]
                self._spawn("access", access_cfg)
            if t.get("scheduler"):
                self._spawn("scheduler", {
                    "data_dir": os.path.join(self.workdir, "scheduler")})
        if t.get("codec"):
            self._spawn("codec", dict(engine))
        with open(os.path.join(self.workdir, "cluster.json"), "w") as f:
            json.dump(self.state, f, indent=2)
        return self.state

    def down(self) -> dict[str, int | None]:
        """Stop every role (SIGTERM, then SIGKILL after 10 s); returns
        each process's exit code by name."""
        for p in self.procs:
            if p.p.poll() is None:
                p.p.terminate()
        for p in self.procs:
            try:
                p.p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.p.kill()
                p.p.wait()
        return {p.name: p.p.returncode for p in self.procs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cubefs-tpu-torch-cluster")
    ap.add_argument("--topo", help="topology JSON file (defaults built in)")
    ap.add_argument("--workdir", required=True)
    args = ap.parse_args(argv)
    topo = {}
    if args.topo:
        with open(args.topo) as f:
            topo = json.load(f)
    c = Cluster(topo, args.workdir)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    try:
        print(json.dumps(c.up(), indent=2), flush=True)
        # a signal that lands on another thread runs its Python handler only
        # once the main thread runs again: wake it twice a second
        while not stop.wait(0.5):
            pass
    finally:
        codes = c.down()
    return 0 if all(rc == 0 for rc in codes.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
