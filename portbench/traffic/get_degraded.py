"""Degraded GETs through the access: a closed loop of clients, each
GETting one object a call through ``AccessHandler.get`` from an
in-process blob cluster (a clustermgr, blobnodes with native chunk
stores on disk, a proxy, the access; direct-call transport), with the
disks of two data units down, so that every blob of every GET is read
from the 10 data and 4 parity shards left and decoded on the card.

Set-up writes the data set once through the access: objects of every
``step_units``-th size from ``min_units`` to ``max_units`` units of
``unit`` bytes, each size once, in an order drawn from the seed, PUT by
``clients`` threads; the proxy keeps every blob in one volume. Each
client GETs objects in an order drawn from the seed, every object once a
round. ``sample_every`` / ``samples_per_client`` as for ``put_encode``:
the kept GETs' bytes are compared with the payloads written.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch

from cubefs_tpu_torch.blob.access import AccessConfig, AccessHandler
from cubefs_tpu_torch.blob.blobnode import BlobNode
from cubefs_tpu_torch.blob.clustermgr import ClusterMgr
from cubefs_tpu_torch.blob.proxy import ProxyAllocator
from cubefs_tpu_torch.codec import codemode as cm
from cubefs_tpu_torch.utils import metrics, rpc

from portbench import harness

from . import program
from .substitute import ControlEncoder


class Cell:
    def __init__(self, cfg: dict, params: dict, seed: int, device, control: bool = False):
        self.cfg, self.p, self.seed = cfg, params, seed
        self.device = torch.device(device)
        self.control = control
        self.clients = params["clients"]
        self.n = cfg["n"]
        self.blob = cfg["blob_size"]
        self.nodes: list = []
        self.acc = None
        self.workdir = None

    def _cluster(self) -> None:
        lay = self.cfg["cluster"]
        self.workdir = tempfile.mkdtemp(prefix="portbench-blob-")
        self.cmgr = ClusterMgr()
        cmc, pool = rpc.Client(self.cmgr), rpc.NodePool()
        for i in range(lay["blobnodes"]):
            disks = [os.path.join(self.workdir, f"n{i}d{d}") for d in range(lay["disks_per_node"])]
            node = BlobNode(i, disks, cmc, addr=f"node{i}", device=self.device)
            node.register()
            node.send_heartbeat()
            pool.bind(node.addr, node)
            self.nodes.append(node)
        proxy = ProxyAllocator(cmc)
        proxy.VOLUME_REUSE = lay["blobs_per_volume"]
        self.acc = AccessHandler(cmc, pool, AccessConfig(
            blob_size=self.blob, engine=self.cfg["engine"], device=self.device),
            proxy_client=rpc.Client(proxy))

    def setup(self) -> None:
        p, unit = self.p, self.p["unit"]
        self.phases = harness.Phases()
        with self.phases("inputs"):
            sizes = [u * unit for u in range(p["min_units"], p["max_units"] + 1,
                                             p["step_units"])]
            sizes = [int(s) for s in
                     np.random.default_rng([self.seed, 1 << 20]).permutation(sizes)]
            src = harness.seeded_bytes(self.seed, 0, sum(sizes), self.device).cpu().numpy()
            offs = np.cumsum([0] + sizes)
            self.payloads = [src[offs[j]:offs[j + 1]].tobytes() for j in range(len(sizes))]
            del src
        with self.phases("cluster"):
            self._cluster()
        mode = int(cm.CodeMode[self.cfg["codemode"]])
        self.locs = [None] * len(sizes)

        def put(i):
            for j in range(1 + i, len(sizes), self.clients):
                self.locs[j] = self.acc.put(self.payloads[j], codemode=mode)

        with self.phases("write"):
            self.locs[0] = self.acc.put(self.payloads[0], codemode=mode)  # leases the volume
            harness.run_threads(self.clients, put)
        vids = {sl.vid for loc in self.locs for sl in loc.slices}
        if len(vids) != 1:
            raise RuntimeError(f"the data set spans volumes {sorted(vids)}, not one")
        vol = self.cmgr.get_volume(vids.pop())
        for u in vol.units[:p["down_data_units"]]:
            self.nodes[int(u.node_addr.removeprefix("node"))].break_disk(u.disk_id)
        self.plans = []
        for i in range(self.clients):
            rng = np.random.default_rng([self.seed, i])
            self.plans.append((rng, list(rng.permutation(len(sizes)))))
        self.sampler = harness.Sampler(self.seed, self.clients, p["sample_every"],
                                       p["samples_per_client"])
        # warm: every client GETs the largest object once; each blob decodes
        big = max(range(len(sizes)), key=lambda j: sizes[j])
        before = metrics.reconstruct_reads.value(path="global")
        with self.phases("warm"):
            harness.run_threads(self.clients, lambda i: self.acc.get(self.locs[big]))
        blobs = self.locs[big].slices[0].count
        decoded = metrics.reconstruct_reads.value(path="global") - before
        if decoded != self.clients * blobs:
            raise RuntimeError(f"{decoded:.0f} degraded decodes for {self.clients * blobs} "
                               "blobs read: the GETs are not all degraded")
        if self.control:
            self.acc._encoders[mode] = ControlEncoder(self.cfg, self.device)

    def _work(self, size: int) -> list:
        """(R, C, S, B) of a GET's decodes: each blob lacks the data units down."""
        floor = self.cfg["min_shard_size"]
        lens = [min(self.blob, size - k) for k in range(0, size, self.blob)]
        return [(self.p["down_data_units"], self.n, max(-(-b // self.n), floor), 1)
                for b in lens]

    def call(self, i: int, k: int, rec: harness.Call) -> None:
        rng, order = self.plans[i]
        j = int(order[k % len(order)])
        with rec.span("pb.get"):
            data = self.acc.get(self.locs[j])
        rec.end = time.perf_counter()
        rec.nbytes = len(data)
        rec.work = self._work(len(self.payloads[j]))
        if self.sampler.keep(i, k, rec):
            rec.sample = (j, data)

    def counters(self):
        return program.counters()

    def release(self) -> None:
        if self.acc is not None:  # hedged reads outlive a GET: drain them first
            self.acc._pool.shutdown(wait=True)
            self.acc = None
        for node in self.nodes:
            node.stop()
        self.nodes = []
        if self.workdir:
            shutil.rmtree(self.workdir, ignore_errors=True)
            self.workdir = None

    def check(self, window: harness.Window) -> list[tuple]:
        """Every kept GET's bytes against the payload written."""
        bad, checked = 0, 0
        for c in window.calls:
            if not (c.ok and c.sample is not None):
                continue
            j, data = c.sample
            want = np.frombuffer(self.payloads[j], dtype=np.uint8)
            got = np.frombuffer(data, dtype=np.uint8)
            bad += (int(np.count_nonzero(got != want)) if got.size == want.size
                    else max(got.size, want.size))
            checked += 1
        return [("mismatched_bytes", bad, 0, "max"),
                ("failed_calls", sum(not c.ok for c in window.calls), 0, "max"),
                ("checked_calls", checked, 1, "min")]

    def close(self) -> None:
        self.release()
