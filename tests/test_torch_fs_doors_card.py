"""Phase ``fs_doors``'s split case on the card, in process: a file tiered
into the blob plane (``AccessHandler`` on engine ``cuda`` on the card)
and then moved by a live metapartition split keeps its ``cold.location``,
and its cold read with a data unit of every stripe deleted (kernel A
rebuilds each blob) is byte-identical, held against the same cluster on
``device="cpu"`` (A's plain version): the same split, the same location,
the same shards on every unit, the same bytes.

Every test needs a CUDA device (``cuda`` marker; the fixture skips
without one). The file imports no jax:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_fs_doors_card.py

Tolerance: exact equality.
"""

import functools
import json

import numpy as np
import pytest

from cubefs_tpu_torch.blob import access
from cubefs_tpu_torch.fs.client import FileSystem
from cubefs_tpu_torch.ops import _build
from test_torch_fs_card import cuda_device, quiet_qos  # noqa: F401  (fixtures)
from test_torch_tiering import TIERING, stripes


def split_tiered(tmp_path, name: str, data: bytes) -> dict:
    """Tier ``/cold/x`` behind 8 smaller inodes, split the partition at
    its inode (the split moves it), then read it cold with a data unit of
    every stripe deleted."""
    fs, view, pool, engine, blob, metas, datas = TIERING._build_cluster(tmp_path, name)
    try:
        fs.mkdir("/cold")
        for i in range(8):
            fs.create(f"/cold/pad{i}")
        ino = TIERING._write_aged(fs, "/cold/x", data)
        a0 = _build.LAUNCHES["gf_apply"]
        rep = TIERING._lc(fs, engine).scan_once()
        put_launches = _build.LAUNCHES["gf_apply"] - a0
        before = fs.meta.inode_get(ino)["xattr"]["cold.location"]
        master = pool.get("master")._target
        vol = view["name"]
        mp = master.client_view(vol)["mps"][0]
        res = master.split_engine().split(vol, pid=mp["pid"], split_ino=ino)
        fresh = FileSystem(master.client_view(vol), pool, master_addr="master")
        owner = next(m["pid"] for m in fresh.meta.mps if m["start"] <= ino < m["end"])
        inode = fresh.meta.inode_get(ino)
        loc = json.loads(inode["xattr"]["cold.location"])
        shards = stripes(blob, loc)
        h = blob.inner._h
        for sl in loc["slices"]:
            vol_rec = h.cm.call("get_volume", {"vid": sl["vid"]})[0]["volume"]
            u = vol_rec["units"][0]
            node = h.nodes.get(u["node_addr"])._target
            for bid in range(sl["min_bid"], sl["min_bid"] + sl["count"]):
                node.delete_shard(u["disk_id"], u["chunk_id"], bid)
        a1 = _build.LAUNCHES["gf_apply"]
        degraded = engine.read_cold(inode, 0, len(data))
        return {"transitioned": rep.transitioned, "copied": res["copied_inodes"],
                "moved_to_target": owner == res["target_pid"],
                "location_kept": inode["xattr"]["cold.location"] == before,
                "location": loc, "shards": shards, "degraded": degraded,
                "put_launches": put_launches,
                "degraded_launches": _build.LAUNCHES["gf_apply"] - a1}
    finally:
        for n in (*metas, *datas):
            n.stop()


@pytest.mark.cuda
def test_tiered_file_held_across_a_split_reads_cold_through_a(cuda_device, quiet_qos,
                                                               tmp_path, monkeypatch):
    data = np.random.default_rng(43).integers(0, 256, 5 * (64 << 10) + 99,
                                              dtype=np.uint8).tobytes()
    out = {}
    for name, device in (("card", None), ("plain", "cpu")):
        monkeypatch.setattr(TIERING, "AccessConfig", functools.partial(
            access.AccessConfig, device=device, engine="cuda"))
        out[name] = split_tiered(tmp_path, name, data)
    card, plain = out["card"], out["plain"]
    assert card["transitioned"] == plain["transitioned"] == 1
    assert card["moved_to_target"] and plain["moved_to_target"]
    assert card["location_kept"] and plain["location_kept"]
    assert card["copied"] == plain["copied"] > 0
    assert card["location"] == plain["location"]
    assert card["shards"] == plain["shards"]
    assert card["degraded"] == plain["degraded"] == data
    blobs = {(vid, bid) for vid, bid, _ in card["shards"]}
    assert card["put_launches"] >= 1 and card["degraded_launches"] >= len(blobs)
