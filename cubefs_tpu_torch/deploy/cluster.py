"""Cluster launcher: the reference's docker-compose analog.

The port's copy of ``cubefs_tpu/deploy/cluster.py``: one topology JSON
spawns every role as a local process (``python -m cubefs_tpu_torch.cmd``),
waits for each to listen, creates the file-system plane's initial volume
and writes a state file with all addresses (``<workdir>/cluster.json``).

  python -m cubefs_tpu_torch.deploy.cluster --topo topo.json --workdir /tmp/c1

Topology JSON (all keys optional), the reference's keys:
  {"metanodes": 3, "datanodes": 4, "replicas": 3,
   "volume": {"name": "vol1", "mp_count": 3, "dp_count": 4},
   "blobnodes": 6, "disks_per_blobnode": 9, "blob_azs": 3,
   "access": true, "blob_size": 8388608, "codec": false,
   "objectnode": false, "bucket": "bkt", "users": [...],
   "fsgateway": false, "console": false}

and the port's own:
  "proxy": false       a proxy role, whose address access is given
  "scheduler": false   a scheduler role with its own data directory
  "ec_engine": null    access's and codec's engine (the roles' defaults)
  "audit_dir": null    every role's audit log and slow-trace log
  "device": null       every role's card (None: the current CUDA
                       device), or "cpu" for the plain versions

The file-system plane (a master, the metanodes and datanodes, then the
volume, whose name the state file records under ``volume``) starts when
the topology gives ``metanodes`` or ``datanodes``; the reference starts
it always, with 3 and 4 by default, and so does the port with
``"metanodes": 3, "datanodes": 4``. The master's address is
``roles.master[0]``. blob_azs spreads blobnodes across failure domains
round-robin: an int yields AZ names az0..azN-1, a list supplies the
names. The objectnode (the S3 gateway) serves the volume as bucket
``bucket`` with the ``users`` of its role config, and needs the
file-system plane; it prints the reference's ``S3 on host:port``, which
the launcher takes as its address line. The fsgateway serves the volume
to the C ABI and needs the file-system plane too; the console reads the
master, and the clustermgr when there is one. The launcher starts no
flash role and no fuseclient, as the reference's does not: ``python -m
cubefs_tpu_torch.cmd`` serves them, and ``Proc`` takes a fuseclient's
``mounted at <mountpoint>`` line as its address line.
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

# the lines a role prints once it serves: every role's, the objectnode's,
# and the fsgateway's and a fuseclient's own (a mount's address is its
# mountpoint); the address is the line's last word
READY = ("listening on", "S3 on")
ROLE_READY = {"fsgateway": " on ", "fuseclient": " mounted at "}
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
                own = line.startswith(f"[{self.role}] ") and ROLE_READY.get(self.role)
                if any(mark in line for mark in READY) or (own and own in line):
                    self.addr = line.strip().rsplit(" ", 1)[-1]
                    return self.addr
            if self.p.poll() is not None:
                raise RuntimeError(f"{self.name} exited: {self._log()[-800:]}")
            time.sleep(0.1)
        raise TimeoutError(f"{self.name} did not come up; log: {self.log_path}")


class Cluster:
    def __init__(self, topo: dict, workdir: str, timeout: float = 120.0):
        for gw in ("objectnode", "fsgateway"):
            if topo.get(gw) and not (topo.get("metanodes") or topo.get("datanodes")):
                raise ValueError(f"the {gw} serves a volume of the file-system plane: "
                                 "give metanodes and datanodes")
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

    def _fs_up(self) -> None:
        """Master, metanodes and datanodes (the nodes started together),
        then the initial volume once the master sees every node."""
        from ..utils import rpc

        t = self.topo
        n_meta, n_data = t.get("metanodes", 0), t.get("datanodes", 0)
        replicas = t.get("replicas", 3)
        master = self._spawn("master", {
            "replicas": replicas, "allow_single_node": n_data < replicas,
            "data_dir": os.path.join(self.workdir, "master")})
        nodes = [self._start("metanode", {
            "name": f"metanode{i}", "node_id": i, "master_addr": master,
            "data_dir": os.path.join(self.workdir, f"meta{i}")}) for i in range(n_meta)]
        nodes += [self._start("datanode", {
            "name": f"datanode{i}", "node_id": i, "master_addr": master,
            "data_dir": os.path.join(self.workdir, f"data{i}")}) for i in range(n_data)]
        self._wait(nodes)
        # nodes print "listening" before their register RPC lands; wait
        # until the master sees the full topology
        deadline = time.time() + self.timeout
        while True:
            st = rpc.call(master, "stat")[0]
            if st["metanodes"] >= n_meta and st["datanodes"] >= n_data:
                break
            if time.time() > deadline:
                raise TimeoutError(f"nodes never registered: {st}")
            time.sleep(0.1)
        vol = t.get("volume", {"name": "vol1"})
        rpc.call(master, "create_volume", {
            "name": vol.get("name", "vol1"),
            "mp_count": vol.get("mp_count", 3),
            "dp_count": vol.get("dp_count", 4)})
        self.state["volume"] = vol.get("name", "vol1")

    def up(self) -> dict:
        t = self.topo
        engine = {"ec_engine": t["ec_engine"]} if t.get("ec_engine") else {}
        if t.get("metanodes") or t.get("datanodes"):
            self._fs_up()
        cm = None
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
        if t.get("objectnode"):
            self._spawn("objectnode", {
                "master_addr": self.state["roles"]["master"][0],
                "vols": {t.get("bucket", "bkt"): self.state["volume"]},
                "users": t.get("users", [])})
        if t.get("codec"):
            self._spawn("codec", dict(engine))
        if t.get("fsgateway"):
            self._spawn("fsgateway", {"master_addr": self.state["roles"]["master"][0],
                                      "vol": self.state["volume"]})
        if t.get("console"):
            console_cfg = {}
            if "master" in self.state["roles"]:
                console_cfg["master_addr"] = self.state["roles"]["master"][0]
            if cm is not None:
                console_cfg["clustermgr_addr"] = cm
            self._spawn("console", console_cfg)
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
