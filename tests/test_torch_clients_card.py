"""Phase ``clients``' C ABI cases on the card, in process:

- ``cfs_codec_encode``, ``cfs_codec_encode_shm`` and ``cfs_codec_crc32``
  of the port's library against a codec service on the card: the same
  parity and CRCs as the service on ``device="cpu"`` (the plain
  versions) and zlib, with kernels A and B launched;
- a file tiered into the blob plane (``AccessHandler`` on engine
  ``cuda`` on the card) read through an ``FsGateway`` by ``cfs_pread``,
  healthy and with a data unit of every stripe deleted (A rebuilds each
  blob): the same bytes as the same cluster on ``device="cpu"``.

Every test needs a CUDA device (``cuda`` marker; the fixture skips
without one). The file imports no jax:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_clients_card.py

Tolerance: exact equality.
"""

import ctypes
import functools
import json
import zlib

import numpy as np
import pytest

from cubefs_tpu_torch.blob import access
from cubefs_tpu_torch.codec.service import CodecService
from cubefs_tpu_torch.fs.fsgateway import FsGateway
from cubefs_tpu_torch.ops import _build
from cubefs_tpu_torch.runtime import nativeclient
from cubefs_tpu_torch.utils import rpc
from test_torch_fs_card import cuda_device, quiet_qos  # noqa: F401  (fixtures)
from test_torch_tiering import TIERING


def _hp(addr):
    host, p = addr.rsplit(":", 1)
    return host.encode(), int(p)


def _codec_calls(lib, addr, data, m):
    b, n, s = data.shape
    out = {}
    for fn in ("cfs_codec_encode", "cfs_codec_encode_shm"):
        parity = np.zeros((b, m, s), np.uint8)
        src = data.tobytes() if fn == "cfs_codec_encode" else data.ctypes.data_as(ctypes.c_void_p)
        assert getattr(lib, fn)(*_hp(addr), n, m, s, b, src,
                                parity.ctypes.data_as(ctypes.c_void_p)) == 0, lib.cfs_last_error()
        out[fn] = parity
    crcs = np.zeros(b * n, np.uint32)
    assert lib.cfs_codec_crc32(*_hp(addr), s, data.tobytes(), data.size,
                               crcs.ctypes.data_as(ctypes.c_void_p)) == b * n
    out["cfs_codec_crc32"] = crcs
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("s", [4099, 1 << 20], ids=["ragged", "1MiB"])
def test_c_abi_codec_calls_on_the_card(cuda_device, s):
    lib = nativeclient.load()
    data = np.random.default_rng(s).integers(0, 256, (3, 12, s), dtype=np.uint8)
    got = {}
    launches = {}
    for name, device in (("card", cuda_device), ("plain", "cpu")):
        srv = rpc.RpcServer(rpc.expose(CodecService(device=device)), service="codec").start()
        try:
            _build.reset_launches()
            got[name] = _codec_calls(lib, srv.addr, data, 4)
            launches[name] = dict(_build.LAUNCHES)
        finally:
            srv.stop()
    for fn in got["card"]:
        assert np.array_equal(got["card"][fn], got["plain"][fn]), fn
    assert got["card"]["cfs_codec_crc32"].tolist() == [zlib.crc32(r) for r in
                                                        data.reshape(-1, s)]
    assert launches["card"]["gf_apply"] >= 2 and launches["card"]["crc32_blocks"] >= 1
    assert launches["plain"]["gf_apply"] == launches["plain"]["crc32_blocks"] == 0


def _tiered_through_the_gateway(tmp_path, name, data):
    fs, view, pool, engine, blob, metas, datas = TIERING._build_cluster(tmp_path, name)
    srv = None
    try:
        fs.mkdir("/cold")
        ino = TIERING._write_aged(fs, "/cold/x", data)
        assert TIERING._lc(fs, engine).scan_once().transitioned == 1
        fs.tiering = engine  # the client's cold tier, as CUBEFS_TIERING=1 builds it
        srv = rpc.RpcServer(rpc.expose(FsGateway(fs)), service="fsgateway").start()
        lib = nativeclient.load()

        def pread():
            h = lib.cfs_mount(*_hp(srv.addr))
            try:
                fd = lib.cfs_open(h, b"/cold/x", 0, 0)
                buf = ctypes.create_string_buffer(len(data) + 1)
                n = lib.cfs_pread(h, fd, buf, len(data) + 1, 0)
                lib.cfs_close(h, fd)
                return buf.raw[:n]
            finally:
                lib.cfs_unmount(h)

        healthy = pread()
        loc = json.loads(fs.meta.inode_get(ino)["xattr"]["cold.location"])
        h = blob.inner._h
        blobs = 0
        for sl in loc["slices"]:
            vol = h.cm.call("get_volume", {"vid": sl["vid"]})[0]["volume"]
            u = vol["units"][0]
            node = h.nodes.get(u["node_addr"])._target
            for bid in range(sl["min_bid"], sl["min_bid"] + sl["count"]):
                node.delete_shard(u["disk_id"], u["chunk_id"], bid)
                blobs += 1
        a0 = _build.LAUNCHES["gf_apply"]
        degraded = pread()
        return {"healthy": healthy, "degraded": degraded, "location": loc, "blobs": blobs,
                "launches": _build.LAUNCHES["gf_apply"] - a0}
    finally:
        if srv is not None:
            srv.stop()
        for n in (*metas, *datas):
            n.stop()


@pytest.mark.cuda
def test_tiered_file_through_the_gateway_on_the_card(cuda_device, quiet_qos, tmp_path,
                                                     monkeypatch):
    data = np.random.default_rng(47).integers(0, 256, 5 * (64 << 10) + 321,
                                              dtype=np.uint8).tobytes()
    out = {}
    for name, device in (("card", None), ("plain", "cpu")):
        monkeypatch.setattr(TIERING, "AccessConfig", functools.partial(
            access.AccessConfig, device=device, engine="cuda"))
        out[name] = _tiered_through_the_gateway(tmp_path, name, data)
    card, plain = out["card"], out["plain"]
    assert card["location"] == plain["location"]
    assert card["healthy"] == card["degraded"] == plain["degraded"] == data
    assert card["launches"] >= card["blobs"] > 0
