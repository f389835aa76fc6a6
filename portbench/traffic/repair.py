"""Disk repair at the repair worker's decode: a closed loop of workers,
each rebuilding one lost unit of a batch of stripes a call through
``RepairWorker._decode_groups``, the worker's own path from the
survivors it downloaded (``bytes``, one per shard) to the shards it
writes back: the survivors stacked on the host, staged to the card,
kernel A for the lost unit and one extra survivor, the extra compared
with its download, the lost unit's bytes kept for writeback (``writes``,
a list in memory: no disk and no network).

Parameters: ``clients`` workers, ``batch_stripes`` stripes a call (the
worker's default), drawn from a pool of ``pool`` stripes; each call's
lost unit is drawn from the seed, every unit once a round per worker.
The pool is made from the seed on the card: random data rows, parity by
the reference. ``sample_every`` / ``samples_per_client`` as for
``put_encode``: the kept calls' writes are compared with the pool.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from cubefs_tpu_torch.blob.worker import RepairWorker
from cubefs_tpu_torch.codec import codemode as cm

from portbench import harness
from portbench.reference.codes import Code

from . import program
from .substitute import ControlEngine


class Cell:
    def __init__(self, cfg: dict, params: dict, seed: int, device, control: bool = False):
        self.cfg, self.p, self.seed = cfg, params, seed
        self.device = torch.device(device)
        self.control = control
        self.clients = params["clients"]
        self.code = Code.of(cfg)
        self.s = -(-cfg["blob_size"] // self.code.n)
        self.t = cm.tactic(cfg["codemode"])

    def setup(self) -> None:
        code, pool, s = self.code, self.p["pool"], self.s
        glob = code.n + code.m
        self.phases = harness.Phases()
        with self.phases("inputs"):
            data = harness.seeded_bytes(self.seed, 0, pool * code.n * s, self.device)
            data = data.view(pool, code.n, s)
            self.stripes = torch.cat([data, code.parity(data)], dim=1).cpu().numpy()
            del data
            self.shards = [[self.stripes[b, u].tobytes() for u in range(glob)]
                           for b in range(pool)]
            self.plans = []
            for i in range(self.clients):
                rng = np.random.default_rng([self.seed, i])
                self.plans.append((rng, list(rng.permutation(glob))))
            self.sampler = harness.Sampler(self.seed, self.clients, self.p["sample_every"],
                                           self.p["samples_per_client"])
        with self.phases("program"):
            self.workers = [RepairWorker(None, None, None, engine=self.cfg["engine"],
                                         device=self.device,
                                         batch_stripes=self.p["batch_stripes"])
                            for _ in range(self.clients)]
        # warm: one call a worker, all at once (the shape of every call)
        with self.phases("warm"):
            harness.run_threads(self.clients, lambda i: self._decode(
                i, i, np.arange(self.p["batch_stripes"])))
        if self.control:
            for wk in self.workers:
                wk.codec = ControlEngine(self.device)

    def _decode(self, i: int, bad: int, bids) -> list:
        glob = self.code.n + self.code.m
        subs = [u for u in range(glob) if u != bad][:self.code.n + 1]
        group = [(int(b), [self.shards[b][u] for u in subs]) for b in bids]
        writes: list = []
        self.workers[i]._decode_groups(self.t, {(self.s, tuple(subs)): group}, self.code.n,
                                       glob, bad, writes)
        return writes

    def call(self, i: int, k: int, rec: harness.Call) -> None:
        rng, units = self.plans[i]
        bad = int(units[k % len(units)])
        bids = rng.choice(self.p["pool"], self.p["batch_stripes"], replace=False)
        rec.start = time.perf_counter()
        with rec.span("pb.decode"):
            writes = self._decode(i, bad, bids)
        rec.end = time.perf_counter()
        rec.nbytes = sum(len(w) for _, w in writes)
        rec.work = [(2, self.code.n, self.s, len(bids))]
        if self.sampler.keep(i, k, rec):
            rec.sample = (bad, writes)

    def counters(self):
        return program.counters()

    def release(self) -> None:
        self.workers = None
        self.shards = None

    def check(self, window: harness.Window) -> list[tuple]:
        """Every kept call's rebuilt shards against the pool's unit."""
        bad_bytes, checked = 0, 0
        for c in window.calls:
            if not (c.ok and c.sample is not None):
                continue
            bad, writes = c.sample
            for bid, shard in writes:
                got = np.frombuffer(shard, dtype=np.uint8)
                want = self.stripes[bid, bad]
                bad_bytes += (int(np.count_nonzero(got != want)) if got.size == want.size
                              else want.size)
            bad_bytes += (self.p["batch_stripes"] - len(writes)) * self.s
            checked += 1
        return [("mismatched_shard_bytes", bad_bytes, 0, "max"),
                ("failed_calls", sum(not c.ok for c in window.calls), 0, "max"),
                ("checked_calls", checked, 1, "min")]

    def close(self) -> None:
        self.release()
