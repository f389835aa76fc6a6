"""The S3 gateway's cold tier on the card: the port's in-process gateway
stack (``test_torch_s3_mixed.TierStack``) with its ``BlobClient``'s
``AccessHandler`` on engine ``cuda`` on the card, held against the same
stack on ``device="cpu"`` (kernel A's plain version). A lifecycle
``Transition`` rule PUT through the gateway and adopted by ``LcNode``
tiers the objects in one scan, launching A for each tier PUT; a cold GET
through the gateway with a blobnode's disks broken launches A for each
blob that lost a data unit. Locations, every shard of every stripe and
every answer equal the plain stack's, and each stripe's parity equals
the plain ``encode_parity`` of its data rows.

Every test needs a CUDA device (``cuda`` marker; the fixture skips
without one). The file imports no jax:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_s3_card.py

Tolerance: exact bytes.
"""

import numpy as np
import pytest
import torch

from cubefs_tpu_torch.codec import codemode as cm
from cubefs_tpu_torch.ops import rs_kernel
from test_torch_fs import _port_qos_still  # noqa: F401  (autouse fixture)
from test_torch_s3_mixed import PORT_S3, TierStack, payloads, tier_pkg, tier_through_gateway


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_gateway_transition_and_degraded_get_on_card_equal_the_plain_version(
        cuda_device, tmp_path, monkeypatch):
    sizes = {"cold/a.bin": 5 * (64 << 10) + 99, "cold/b.bin": 3 * (64 << 10), "hot/c.bin": 4321}
    objects = dict(zip(sizes, payloads(43, list(sizes.values()))))
    out = {}
    for name, device in (("card", None), ("plain", "cpu")):
        st = TierStack(tier_pkg("port", device), PORT_S3, tmp_path / name, monkeypatch)
        try:
            assert st.blob._h.device.type == ("cpu" if device == "cpu" else "cuda")
            out[name] = tier_through_gateway(st, objects)
        finally:
            st.stop()
    card, plain = out["card"], out["plain"]
    launches = ("migrate_launches", "degraded_launches")
    assert {k: v for k, v in card.items() if k not in launches} == \
        {k: v for k, v in plain.items() if k not in launches}
    assert card["transitioned"] == 2 and plain["migrate_launches"] == 0
    assert card["migrate_launches"] >= 2  # a tier PUT stack per object
    assert card["lost_data_units"] > 0 and card["degraded_launches"] >= card["lost_data_units"]
    assert card["degraded"] == card["healthy"]
    assert card["degraded"]["cold/a.bin"] == (200, objects["cold/a.bin"])
    for key, shards in card["shards"].items():
        n = cm.tactic(cm.CodeMode(card["locations"][key]["codemode"])).n
        for vid, bid in sorted({(v, b) for v, b, _ in shards}):
            rows = np.stack([np.frombuffer(shards[(vid, bid, i)], np.uint8)
                             for i in range(1 + max(i for v, b, i in shards
                                                    if (v, b) == (vid, bid)))])
            parity = rs_kernel.encode_parity(torch.from_numpy(rows[None, :n].copy()),
                                             len(rows) - n)
            assert np.array_equal(parity[0].numpy(), rows[n:])
