"""The port's native client library (``cubefs_tpu_torch/csrc/host/
native_client.cc``, built and bound by ``runtime/nativeclient.py``) held
against the reference's (``cubefs_tpu/runtime/src/native_client.cc`` in
``libcubefs_rt.so``) on the CPU:

- every scenario of ``tests/test_native_client.py`` runs on the port
  (``port_copy``): the port's library against the port's codec service
  (plain versions on the CPU) and access handler;
- the ABI checks of ``tests/test_java_sdk.py`` hold
  ``java/.../CfsLibrary.java`` against the port's source and its built
  library, by name and parameter count;
- each package's library against each package's codec server: the same
  parity and CRCs from ``cfs_codec_encode``, ``cfs_codec_encode_shm`` and
  ``cfs_codec_crc32``, equal to the plain version and ``zlib``;
- each package's library against each package's access server: the same
  bytes back from ``cfs_blob_get``, and the same failure after
  ``cfs_blob_delete``.

Tolerance: exact bytes.
"""

import ctypes
import functools
import json
import os
import types
import zlib

import numpy as np
import pytest

from cubefs_tpu_torch.blob.access import AccessConfig, AccessHandler
from cubefs_tpu_torch.blob.blobnode import BlobNode
from cubefs_tpu_torch.codec.service import CodecService
from cubefs_tpu_torch.ops import gf256
from cubefs_tpu_torch.runtime import nativeclient
from cubefs_tpu_torch.utils import rpc
from test_torch_fs import run_in
from test_torch_raft import port_copy, scenarios

RT = types.SimpleNamespace(load=nativeclient.load, build=nativeclient.build)
NATIVE = port_copy("test_native_client", rt=RT,
                   CodecService=functools.partial(CodecService, device="cpu"),
                   BlobNode=functools.partial(BlobNode, device="cpu"),
                   AccessHandler=AccessHandler,
                   AccessConfig=functools.partial(AccessConfig, engine="numpy", device="cpu"))
JAVA = port_copy("test_java_sdk", rt=RT)
JAVA.NATIVE_SRC = nativeclient.SOURCES[0]


@pytest.mark.parametrize("name", scenarios(NATIVE))
def test_reference_native_client_scenario_on_the_port(name, request):
    run_in(NATIVE, name, request)


@pytest.mark.parametrize("name", [n for n in scenarios(JAVA) if n != "test_java_sources_compile"])
def test_java_abi_check_on_the_port(name, request):
    run_in(JAVA, name, request)


def test_every_scenario_runs():
    assert len(scenarios(NATIVE)) == 6
    assert JAVA.NATIVE_SRC.endswith(os.path.join("csrc", "host", "native_client.cc"))
    assert set(JAVA._c_exports()) == set(JAVA._java_methods()) | {"cfs_last_meta",
                                                                  "cfs_codec_encode_shm"}


# ---------------- each library against each package's servers ----------------

@pytest.fixture(scope="module")
def libs():
    from cubefs_tpu.runtime import build as ref_build

    return {"port": nativeclient.load(), "ref": ref_build.load()}


@pytest.fixture(scope="module")
def codec_servers():
    from cubefs_tpu.codec.service import CodecService as RefCodecService
    from cubefs_tpu.utils import rpc as ref_rpc

    port = rpc.RpcServer(rpc.expose(CodecService(device="cpu")), service="codec").start()
    ref = ref_rpc.RpcServer(ref_rpc.expose(RefCodecService(engine="numpy")),
                            service="codec").start()
    yield {"port": port.addr, "ref": ref.addr}
    port.stop()
    ref.stop()


def _hp(addr):
    host, p = addr.rsplit(":", 1)
    return host.encode(), int(p)


def _codec_replies(lib, addr, n, m, s, b, seed):
    data = np.random.default_rng(seed).integers(0, 256, (b, n, s), dtype=np.uint8)
    out = {}
    for fn in ("cfs_codec_encode", "cfs_codec_encode_shm"):
        parity = np.zeros((b, m, s), dtype=np.uint8)
        src = data.tobytes() if fn == "cfs_codec_encode" else data.ctypes.data_as(ctypes.c_void_p)
        rc = getattr(lib, fn)(*_hp(addr), n, m, s, b, src, parity.ctypes.data_as(ctypes.c_void_p))
        assert rc == 0, lib.cfs_last_error()
        out[fn] = parity
    crcs = np.zeros(b * n, dtype=np.uint32)
    cnt = lib.cfs_codec_crc32(*_hp(addr), s, data.tobytes(), data.size,
                              crcs.ctypes.data_as(ctypes.c_void_p))
    assert cnt == b * n, lib.cfs_last_error()
    out["cfs_codec_crc32"] = crcs
    return data, out


@pytest.mark.parametrize("n,m,s,b", [(6, 3, 4099, 2), (12, 4, 8192, 3)], ids=["ec6p3", "ec12p4"])
def test_each_library_against_each_codec_server(libs, codec_servers, n, m, s, b):
    """Four pairs, one answer: parity equal to the plain GF apply, CRCs
    equal to zlib."""
    answers = {}
    for lname, lib in libs.items():
        for sname, addr in codec_servers.items():
            data, answers[lname, sname] = _codec_replies(lib, addr, n, m, s, b, seed=n + s)
    want_parity = np.stack([gf256.gf_matmul(gf256.parity_matrix(n, m), d) for d in data])
    want_crc = [zlib.crc32(r.tobytes()) for r in data.reshape(-1, s)]
    for key, got in answers.items():
        assert np.array_equal(got["cfs_codec_encode"], want_parity), key
        assert np.array_equal(got["cfs_codec_encode_shm"], want_parity), key
        assert got["cfs_codec_crc32"].tolist() == want_crc, key


@pytest.fixture
def access_servers(tmp_path):
    """An access server of each package over its own in-process blob
    plane (one blobnode of 9 disks, colocated units)."""
    from cubefs_tpu.blob import access as ref_access
    from cubefs_tpu.blob.blobnode import BlobNode as RefBlobNode
    from cubefs_tpu.blob.clustermgr import ClusterMgr as RefClusterMgr
    from cubefs_tpu.utils import rpc as ref_rpc

    from cubefs_tpu_torch.blob.clustermgr import ClusterMgr

    servers = {}
    for name, r, cm_cls, bn, handler, config, dev in (
            ("port", rpc, ClusterMgr, BlobNode, AccessHandler,
             functools.partial(AccessConfig, engine="numpy", device="cpu"), {"device": "cpu"}),
            ("ref", ref_rpc, RefClusterMgr, RefBlobNode, ref_access.AccessHandler,
             functools.partial(ref_access.AccessConfig, engine="numpy"), {})):
        cm = cm_cls(allow_colocated_units=True)
        pool = r.NodePool()
        node = bn(0, [str(tmp_path / f"{name}d{i}") for i in range(9)], r.Client(cm),
                  addr="n0", **dev)
        node.register()
        node.send_heartbeat()
        pool.bind("n0", node)
        acc = handler(r.Client(cm), pool, config(blob_size=32 << 10))
        servers[name] = r.RpcServer(r.expose(acc), service="access").start()
    yield {k: v.addr for k, v in servers.items()}
    for srv in servers.values():
        srv.stop()


def test_each_library_against_each_access_server(libs, access_servers):
    payload = np.random.default_rng(11).integers(0, 256, 90_001, dtype=np.uint8).tobytes()
    outcomes = {}
    for lname, lib in libs.items():
        for sname, addr in access_servers.items():
            loc_buf = ctypes.create_string_buffer(8192)
            assert lib.cfs_blob_put(*_hp(addr), payload, len(payload), loc_buf, 8192) == 0, \
                lib.cfs_last_error()
            loc = json.loads(loc_buf.value)["location"]
            args = json.dumps({"location": loc}).encode()
            out = ctypes.create_string_buffer(len(payload) + 16)
            got = lib.cfs_blob_get(*_hp(addr), args, out, len(out))
            small = ctypes.create_string_buffer(16)
            too_small = lib.cfs_blob_get(*_hp(addr), args, small, 16)
            deleted = lib.cfs_blob_delete(*_hp(addr), args)
            after = lib.cfs_blob_get(*_hp(addr), args, out, len(out))
            outcomes[lname, sname] = (got, out.raw[:max(got, 0)] == payload, loc["size"],
                                      too_small, deleted, after)
    assert len(set(outcomes.values())) == 1, outcomes
    assert outcomes["port", "port"] == (len(payload), True, len(payload), -2, 0, -1)
