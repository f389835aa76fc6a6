"""The blob plane's main path on the card: PUT, GET, GET with disks down,
a disk's repair through the scheduler and the worker, and an MSR unit's
sub-shard repair, under ``auto`` and ``cuda``. Every shard the card's
cluster stores equals the one the same script stores on a CPU cluster
(the plain versions), every read equals what was written, and kernel A
launches where the path puts it: once per PUT stack, once per degraded
blob under ``cuda``, once per repair batch.

Every test needs a CUDA device (``cuda`` marker; the fixture skips
without one). The file imports no jax:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_blob_card.py

Tolerance: exact equality.
"""

import os

import numpy as np
import pytest
import torch

from cubefs_tpu_torch.blob.access import AccessConfig, AccessHandler
from cubefs_tpu_torch.blob.blobnode import BlobNode
from cubefs_tpu_torch.blob.clustermgr import ClusterMgr
from cubefs_tpu_torch.blob.mq import MessageQueue
from cubefs_tpu_torch.blob.scheduler import Scheduler
from cubefs_tpu_torch.blob.worker import RepairWorker
from cubefs_tpu_torch.codec import codemode as tcm
from cubefs_tpu_torch.codec import engine as engines
from cubefs_tpu_torch.ops import _build
from cubefs_tpu_torch.utils import metrics, rpc

BLOB = 1 << 20  # 1 MiB blobs: an EC12P4 stack of 5 is beyond auto's 1 MiB split


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def static_split(monkeypatch, tmp_path):
    """``auto`` on its static table (``cpp`` to 1 MiB, ``cuda`` beyond)."""
    monkeypatch.setattr(engines, "_policy_path", lambda: str(tmp_path / "CROSSOVER.json"))
    monkeypatch.setattr(engines, "_policy", None)
    monkeypatch.delenv("CUBEFS_CODEC_DEAD", raising=False)


class Cluster:
    def __init__(self, root, device, engine, nodes=6, disks=3):
        os.makedirs(root, exist_ok=True)
        self.cm = ClusterMgr()
        cmc, self.pool = rpc.Client(self.cm), rpc.NodePool()
        self.nodes = []
        for i in range(nodes):
            node = BlobNode(i, [os.path.join(str(root), f"n{i}d{d}") for d in range(disks)],
                            cmc, addr=f"node{i}", device=device, engine=engine)
            node.register()
            node.send_heartbeat()
            self.pool.bind(node.addr, node)
            self.nodes.append(node)
        q = MessageQueue()
        self.access = AccessHandler(cmc, self.pool, AccessConfig(
            blob_size=BLOB, engine=engine, device=device), repair_queue=q)
        self.sched = Scheduler(self.cm, repair_queue=q, node_pool=self.pool, device=device,
                               engine=engine)
        self.worker = RepairWorker(rpc.Client(self.sched), cmc, self.pool, engine=engine,
                                   device=device)

    def node(self, unit):
        return self.nodes[int(unit.node_addr.removeprefix("node"))]

    def shards(self) -> dict:
        out = {}
        for vid in sorted(self.cm.volumes):
            for u in self.cm.get_volume(vid).units:
                if self.node(u)._disk_down(u.disk_id):
                    continue
                for bid, _, _ in self.node(u).list_chunk(u.disk_id, u.chunk_id):
                    out[(vid, u.index, bid)] = self.node(u).get_shard(u.disk_id, u.chunk_id,
                                                                      bid)[0]
        return out

    def stop(self):
        for node in self.nodes:
            node.stop()


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["auto", "cuda"])
def test_main_path_on_card_equals_the_plain_cluster(cuda_device, static_split, tmp_path,
                                                   engine):
    card = Cluster(tmp_path / "card", None, engine)
    plain = Cluster(tmp_path / "cpu", "cpu", engine)
    try:
        rng = np.random.default_rng(7)
        data = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                for n in (5 * BLOB + 3, 4 * BLOB + 1)]
        a0 = _build.LAUNCHES["gf_apply"]
        locs = [card.access.put(d) for d in data]
        assert _build.LAUNCHES["gf_apply"] - a0 == len(data)  # one A step per PUT stack
        assert [plain.access.put(d).to_dict() for d in data] == [x.to_dict() for x in locs]
        assert card.shards() == plain.shards()
        assert [card.access.get(x) for x in locs] == data

        vol = card.cm.get_volume(locs[0].slices[0].vid)
        for c in (card, plain):
            for u in vol.units[:2]:
                c.node(u).break_disk(u.disk_id)
        g0 = metrics.reconstruct_reads.value(path="global")
        a0 = _build.LAUNCHES["gf_apply"]
        assert [card.access.get(x) for x in locs] == data
        decoded = metrics.reconstruct_reads.value(path="global") - g0
        launched = _build.LAUNCHES["gf_apply"] - a0
        if engine == "cuda":
            assert decoded > 0 and launched == decoded  # one per degraded blob
        else:  # a stripe of a tail blob is below auto's split: cpp decodes it
            assert 0 < launched <= decoded
        for c in (card, plain):
            for node in c.nodes:
                node._broken.clear()

        victim = vol.units[2]
        a0 = _build.LAUNCHES["gf_apply"]
        for c in (card, plain):
            c.node(victim).break_disk(victim.disk_id)
            assert c.sched.mark_disk_broken(victim.disk_id) >= 1
            while c.worker.run_once():
                pass
            assert c.worker.failed == 0
        assert _build.LAUNCHES["gf_apply"] > a0  # the repair batches ran A
        assert card.shards() == plain.shards()
        assert [card.access.get(x) for x in locs] == data
    finally:
        card.stop()
        plain.stop()


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["auto", "cuda"])
def test_msr_unit_repair_on_card(cuda_device, static_split, tmp_path, engine):
    c = Cluster(tmp_path, None, engine)
    try:
        data = np.random.default_rng(8).integers(0, 256, 3 * BLOB + 5,
                                                 dtype=np.uint8).tobytes()
        loc = c.access.put(data, codemode=tcm.CodeMode.EC6P6MSR)
        vol = c.cm.get_volume(loc.slices[0].vid)
        u = vol.units[0]
        orig = {b: c.node(u).get_shard(u.disk_id, u.chunk_id, b)[0]
                for b, _, _ in c.node(u).list_chunk(u.disk_id, u.chunk_id)}
        sub0 = metrics.repair_subshard_reads.value()
        c.node(u).break_disk(u.disk_id)
        c.sched.manual_migrate(vol.vid, 0)
        while c.worker.run_once():
            pass
        assert metrics.repair_subshard_reads.value() - sub0 >= vol.tactic.d * len(orig)
        n = c.cm.get_volume(vol.vid).units[0]
        assert n.disk_id != u.disk_id
        assert {b: c.node(n).get_shard(n.disk_id, n.chunk_id, b)[0] for b in orig} == orig
        assert c.access.get(loc) == data
    finally:
        c.stop()
