"""The replicated blob control plane on the card: a clustermgr raft group
of 3 over HTTP on 127.0.0.1, in this process, with 6 blobnodes x 3 disks
and access under ``cuda`` pointed at a follower. After the group loses
its leader, a PUT still goes through the new leader: kernel A launches
for its stack, the parity the blobnodes store equals ``rs_kernel``'s
plain version on the CPU, and the read equals what was written.

Every test needs a CUDA device (``cuda`` marker; the fixture skips
without one). The file imports no jax:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_raft_card.py

Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

from cubefs_tpu_torch.blob.access import AccessConfig, AccessHandler
from cubefs_tpu_torch.blob.blobnode import BlobNode
from cubefs_tpu_torch.blob.clustermgr import ClusterMgr
from cubefs_tpu_torch.codec import codemode as tcm
from cubefs_tpu_torch.ops import _build, rs_kernel
from cubefs_tpu_torch.utils import rpc
from test_torch_raft import free_ports, wait_for

BLOB = 1 << 20


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_put_after_a_leader_loss_launches_a_and_stores_plain_parity(cuda_device, tmp_path):
    addrs = [f"127.0.0.1:{p}" for p in free_ports(3)]
    group = {}
    for i, a in enumerate(addrs):
        cm = ClusterMgr(data_dir=str(tmp_path / f"cm{i}"), me=a, peers=addrs,
                        node_pool=rpc.NodePool())
        group[a] = (cm, rpc.RpcServer(cm, port=int(a.rsplit(":", 1)[1])).start())
    nodes = []
    try:
        leader = wait_for(lambda: next((a for a, (c, _) in group.items() if c.is_leader()),
                                       None), what="a leader")
        follower = next(a for a in addrs if a != leader)
        pool = rpc.NodePool()
        for i in range(6):
            node = BlobNode(i, [str(tmp_path / f"n{i}d{d}") for d in range(3)],
                            rpc.Client(follower), addr=f"node{i}", device=cuda_device,
                            engine="cuda")
            node.register()
            pool.bind(node.addr, node)
            nodes.append(node)
        acc = AccessHandler(rpc.Client(follower), pool,
                            AccessConfig(blob_size=BLOB, engine="cuda", device=cuda_device))

        cm, srv = group.pop(leader)  # the leader is lost
        cm.fsm_stop()
        srv.stop()
        new = wait_for(lambda: next((a for a, (c, _) in group.items() if c.is_leader()), None),
                       what="a new leader")

        data = np.random.default_rng(12).integers(0, 256, 3 * BLOB + 5, np.uint8).tobytes()
        a0 = _build.LAUNCHES["gf_apply"]
        loc = acc.put(data, codemode=tcm.CodeMode.EC12P4)
        assert _build.LAUNCHES["gf_apply"] - a0 >= 1  # the PUT's stack went through A
        assert acc.get(loc) == data

        t = tcm.tactic(tcm.CodeMode.EC12P4)
        vol = group[new][0].get_volume(loc.slices[0].vid)
        by_addr = {n.addr: n for n in nodes}
        for bid in range(loc.slices[0].min_bid, loc.slices[0].min_bid + loc.slices[0].count):
            stripe = np.stack([np.frombuffer(
                by_addr[u.node_addr].get_shard(u.disk_id, u.chunk_id, bid)[0], np.uint8)
                for u in vol.units])
            plain = rs_kernel.encode_parity(torch.from_numpy(stripe[None, :t.n].copy()), t.m)
            assert np.array_equal(plain[0].numpy(), stripe[t.n:])
    finally:
        for node in nodes:
            node.stop()
        for cm, srv in group.values():
            cm.fsm_stop()
            srv.stop()
