"""The cold tier on the card: the port's tiering cluster (``fs/tiering.py``
driving a ``TieringEngine`` into the blob plane) with its
``AccessHandler`` on engine ``cuda`` on the card, held against the same
cluster on ``device="cpu"`` (kernel A's plain version): a lifecycle scan
tiers the same aged file in both, A launches for the tier PUT, every
shard of every stripe is equal in the two, each stripe's parity equals
the plain ``encode_parity`` of its data rows, and a cold read with a data
unit of every stripe deleted (A rebuilds each blob) is byte-identical.

Every test needs a CUDA device (``cuda`` marker; the fixture skips
without one). The file imports no jax:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_fs_card.py

Tolerance: exact equality.
"""

import functools
import json

import numpy as np
import pytest
import torch

from cubefs_tpu_torch.blob import access
from cubefs_tpu_torch.ops import _build, rs_kernel
from cubefs_tpu_torch.utils import qos
from test_torch_tiering import TIERING, stripes


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def quiet_qos(monkeypatch):
    """The QoS gate's burn signal pinned quiet: a browned-out SCRUB class
    defers every migrate."""
    class Quiet:
        def snapshot(self):
            return {}

    monkeypatch.setattr(qos.DEFAULT, "_tracker", Quiet())
    monkeypatch.setattr(qos.DEFAULT, "_levels", {})
    monkeypatch.setattr(qos.DEFAULT, "_last_refresh", float("-inf"))


def _tier(tmp_path, name, device, data) -> dict:
    fs, view, pool, engine, blob, metas, datas = TIERING._build_cluster(tmp_path, name)
    try:
        assert blob.inner._h.device.type == ("cpu" if device == "cpu" else "cuda")
        fs.mkdir("/cold")
        ino = TIERING._write_aged(fs, "/cold/x", data)
        a0 = _build.LAUNCHES["gf_apply"]
        rep = TIERING._lc(fs, engine).scan_once()
        put_launches = _build.LAUNCHES["gf_apply"] - a0
        inode = fs.meta.inode_get(ino)
        loc = json.loads(inode["xattr"]["cold.location"])
        shards = stripes(blob, loc)
        h = blob.inner._h
        for sl in loc["slices"]:
            vol = h.cm.call("get_volume", {"vid": sl["vid"]})[0]["volume"]
            u = vol["units"][0]
            node = h.nodes.get(u["node_addr"])._target
            for bid in range(sl["min_bid"], sl["min_bid"] + sl["count"]):
                node.delete_shard(u["disk_id"], u["chunk_id"], bid)
        a1 = _build.LAUNCHES["gf_apply"]
        degraded = engine.read_cold(inode, 0, len(data))
        return {"transitioned": rep.transitioned, "location": loc, "shards": shards,
                "degraded": degraded, "put_launches": put_launches,
                "degraded_launches": _build.LAUNCHES["gf_apply"] - a1,
                "codemode": loc["codemode"]}
    finally:
        for n in (*metas, *datas):
            n.stop()


@pytest.mark.cuda
def test_tier_path_on_card_equals_the_plain_version(cuda_device, quiet_qos, tmp_path,
                                                    monkeypatch):
    data = np.random.default_rng(41).integers(0, 256, 5 * (64 << 10) + 99,
                                              dtype=np.uint8).tobytes()
    out = {}
    for name, device in (("card", None), ("plain", "cpu")):
        monkeypatch.setattr(TIERING, "AccessConfig", functools.partial(
            access.AccessConfig, device=device, engine="cuda"))
        out[name] = _tier(tmp_path, name, device, data)
    card, plain = out["card"], out["plain"]
    assert card["transitioned"] == plain["transitioned"] == 1
    assert card["location"] == plain["location"]
    assert card["shards"] == plain["shards"]
    assert card["degraded"] == plain["degraded"] == data
    blobs = sorted({(vid, bid) for vid, bid, _ in card["shards"]})
    assert card["put_launches"] >= 1 and card["degraded_launches"] >= len(blobs)
    n_units = 1 + max(i for _, _, i in card["shards"])
    from cubefs_tpu_torch.codec import codemode as cm

    n = cm.tactic(cm.CodeMode(card["codemode"])).n
    for vid, bid in blobs:
        rows = np.stack([np.frombuffer(card["shards"][(vid, bid, i)], np.uint8)
                         for i in range(n_units)])
        plain_parity = rs_kernel.encode_parity(torch.from_numpy(rows[None, :n].copy()),
                                               n_units - n)
        assert np.array_equal(plain_parity[0].numpy(), rows[n:])
