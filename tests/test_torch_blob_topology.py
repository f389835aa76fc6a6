"""The port's failure-domain topology (``cubefs_tpu_torch/blob/topology.py``
with the clustermgr, access, scheduler and repair worker that use it)
held against the reference's on the CPU: every scenario of the
reference's ``tests/test_blob_topology.py`` runs on the port
(``port_copy``), its ``AZCluster`` built from the port's blob plane on
``device="cpu"`` (kernel A's plain version). The port's encoder takes
uint8 tensors (ROADMAP.md §3); the LRC algebra scenario hands it its
numpy stripe through ``torch.from_numpy``, which shares the array, so the
parity lands in the scenario's rows as the reference's does.
``tests/test_torch_chaos.py`` runs the reference's single-AZ blackout
drill on this ``AZCluster``.

Tolerance: exact equality.
"""

import functools
import types

import pytest
import torch

from cubefs_tpu_torch.blob import access, blobnode, scheduler, worker
from cubefs_tpu_torch.codec import encoder
from test_torch_raft import cases, port_copy, run_scenario



def _numpy_encoder(cfg):
    enc = encoder.new_encoder(cfg)
    return types.SimpleNamespace(t=enc.t, encode=lambda st: enc.encode(torch.from_numpy(st)))


BLOB_TOPOLOGY = port_copy(
    "test_blob_topology",
    AccessConfig=functools.partial(access.AccessConfig, device="cpu"),
    AccessHandler=access.AccessHandler, NodePool=access.NodePool,
    BlobNode=functools.partial(blobnode.BlobNode, device="cpu"),
    Scheduler=functools.partial(scheduler.Scheduler, device="cpu"),
    RepairWorker=functools.partial(worker.RepairWorker, device="cpu"),
    CodecConfig=functools.partial(encoder.CodecConfig, device="cpu"),
    new_encoder=_numpy_encoder)


@pytest.mark.parametrize("name,params", cases(BLOB_TOPOLOGY))
def test_reference_blob_topology_scenario_on_the_port(name, params, request):
    run_scenario(BLOB_TOPOLOGY, name, request, params)
