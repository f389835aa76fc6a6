"""The port's codec service (``cubefs_tpu_torch/codec/service.py``), its
RPC transport (``utils/rpc.py``), host adaptor (``codec/hostio.py``),
metrics (``utils/metrics.py``) and ``codec`` role (``cmd.py``), held
against the reference's: the same calls, numpy-seeded, go to the port's
``CodecService(device="cpu")`` and to ``cubefs_tpu``'s
``CodecService(engine="tpu")`` (JAX on the CPU) and ``("numpy")``; reply
meta and bytes, error codes and messages, and the metrics' families and
counts must be identical. The wire is crossed both ways, and the
reference's native C client drives the port's server.

Tolerance: exact equality everywhere. The ``cuda`` tests run the service
on the card and skip here; the reference is imported only by the tests
that use it (the ``ref`` fixture), so on a machine without jax

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_service.py

runs them.
"""

import ctypes
import json
import os
import re
import signal
import subprocess
import sys
import threading
import types
import zlib

import numpy as np
import pytest
import torch

from cubefs_tpu_torch import cmd
from cubefs_tpu_torch.codec import batcher as tb
from cubefs_tpu_torch.codec import hostio
from cubefs_tpu_torch.codec.service import SHM_PREFIX, CodecService
from cubefs_tpu_torch.ops import gf256, msr
from cubefs_tpu_torch.utils import metrics, rpc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOMETRIES = [(6, 3), (12, 4)]  # RS(6+3), EC12P4
SIZES = [4096, 4099]
B = 3
OPS = ["encode", "reconstruct", "crc32", "verify", "encode_shm", "reconstruct_shm"]
FAMILIES = [
    "cubefs_rpc_requests_total", "cubefs_rpc_latency_seconds", "cubefs_codec_bytes_total",
    "cubefs_codec_batch_submissions_total", "cubefs_codec_batch_steps_total",
    "cubefs_codec_batch_stripes_per_step", "cubefs_codec_batch_wait_seconds",
    "cubefs_codec_batch_backpressure_total", "cubefs_codec_batch_errors_total",
    "cubefs_codec_program_cache_total", "cubefs_codec_program_cache_entries",
]


@pytest.fixture(scope="module")
def ref():
    """The reference's modules (they import jax)."""
    from cubefs_tpu.codec import batcher, service
    from cubefs_tpu.ops import msr as ref_msr
    from cubefs_tpu.utils import metrics as ref_metrics
    from cubefs_tpu.utils import rpc as ref_rpc

    return types.SimpleNamespace(batcher=batcher, service=service, msr=ref_msr,
                                 metrics=ref_metrics, rpc=ref_rpc)


@pytest.fixture(scope="module")
def port():
    return CodecService(device="cpu")


@pytest.fixture(scope="module")
def refs(ref):
    return {"tpu": ref.service.CodecService(engine="tpu"),
            "numpy": ref.service.CodecService(engine="numpy")}


@pytest.fixture(scope="module")
def port_addr(port):
    srv = rpc.RpcServer(rpc.expose(port)).start()
    yield srv.addr
    srv.stop()


@pytest.fixture(scope="module")
def ref_addr(ref, refs):
    srv = ref.rpc.RpcServer(ref.rpc.expose(refs["numpy"]), service="codec").start()
    yield srv.addr
    srv.stop()


@pytest.fixture
def shm_file():
    """Make /dev/shm/cubefs-codec-* files holding given bytes; unlinked after."""
    paths = []

    def make(data: bytes) -> str:
        fd, path = _mkstemp()
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        paths.append(path)
        return path

    yield make
    for p in paths:
        if os.path.lexists(p):
            os.unlink(p)


def _mkstemp():
    import tempfile

    return tempfile.mkstemp(prefix=os.path.basename(SHM_PREFIX), dir=os.path.dirname(SHM_PREFIX))


def _stripes(seed, n, m, s, b=B):
    data = np.random.default_rng(seed).integers(0, 256, (b, n, s), dtype=np.uint8)
    parity = np.stack([gf256.gf_matmul(gf256.parity_matrix(n, m), d) for d in data])
    return np.concatenate([data, parity], axis=1)


def _request(op, n, m, s, seed):
    """(args, body, shm input bytes, shm size) of one call of ``op``."""
    full = _stripes(seed, n, m, s)
    bad = [1, n + 1]  # a data shard and a parity shard
    present = [i for i in range(n + m) if i not in bad]
    geo = {"n": n, "m": m, "shard_size": s, "batch": B}
    rec = {"n": n, "total": n + m, "present": present, "wanted": bad, "shard_size": s,
           "batch": B}
    if op in ("encode", "encode_shm"):
        data = full[:, :n].tobytes()
        return (geo, b"", data, B * m * s) if op == "encode_shm" else (geo, data, None, 0)
    if op in ("reconstruct", "reconstruct_shm"):
        surv = np.ascontiguousarray(full[:, present[:n]]).tobytes()
        return (rec, b"", surv, B * 2 * s) if op == "reconstruct_shm" else (rec, surv, None, 0)
    if op == "verify":
        full[1, n, s // 2] ^= 0x5A  # stripe 1's first parity byte flipped
        return geo, full.tobytes(), None, 0
    return {"block_len": s}, full.tobytes(), None, 0


def _serve(svc, op, args, body, shm_in, shm_out, shm_file):
    """One direct call of the handler: (meta, payload bytes), the shm
    file's bytes standing for the payload of the shm ops."""
    if shm_in is None:
        meta, payload = rpc._normalize(getattr(svc, f"rpc_{op}")(dict(args), body))
        return meta, bytes(payload)
    path = shm_file(shm_in + bytes(shm_out))
    meta = getattr(svc, f"rpc_{op}")(dict(args, shm=path), b"")
    with open(path, "rb") as f:
        return meta, f.read()


# ---------------- every endpoint against the reference ----------------

@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("s", SIZES)
@pytest.mark.parametrize("n,m", GEOMETRIES)
def test_replies_equal_the_reference(port, refs, shm_file, op, n, m, s):
    args, body, shm_in, shm_out = _request(op, n, m, s, seed=n * 10007 + s)
    got = _serve(port, op, args, body, shm_in, shm_out, shm_file)
    for name, ref in refs.items():
        assert got == _serve(ref, op, args, body, shm_in, shm_out, shm_file), name
    meta, payload = got
    if op == "verify":
        assert meta == {"ok": [True, False, True]}
    if op == "crc32":
        crcs = np.frombuffer(payload, "<u4")
        assert crcs.tolist() == [zlib.crc32(r.tobytes()) for r in
                                 np.frombuffer(body, np.uint8).reshape(-1, s)]
        assert crcs.max() >= 1 << 31  # the unsigned top half survives the wire
    if op.startswith("reconstruct"):
        full = _stripes(n * 10007 + s, n, m, s)
        assert payload[-B * 2 * s:] == np.ascontiguousarray(full[:, [1, n + 1]]).tobytes()


# ---------------- host engines and auto ----------------

@pytest.fixture
def routing(monkeypatch, tmp_path):
    """Both packages' routing pinned: the port's table at a private path,
    the reference's to a table of its host legs; no drill, the door open."""
    from cubefs_tpu.codec import engine as ref_engine
    from cubefs_tpu_torch.codec import engine as E

    monkeypatch.setattr(E, "_policy_path", lambda: str(tmp_path / "CROSSOVER.json"))
    monkeypatch.setattr(E, "_policy", None)
    monkeypatch.setattr(ref_engine, "_policy", [[1 << 62, "cpp"]])
    monkeypatch.setattr(ref_engine, "_dead_engines", set())
    monkeypatch.delenv("CUBEFS_CODEC_DEAD", raising=False)
    monkeypatch.delenv("CUBEFS_CODEC_XOR", raising=False)
    return E


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("engine", ["auto", "numpy"])
def test_host_engine_replies_equal_the_reference(ref, routing, shm_file, monkeypatch, engine,
                                                op):
    """The service with ``ec_engine`` auto or numpy answers as the
    reference's service with the same engine: the same meta and bytes,
    CRCs through zlib under numpy (B's plain version under auto)."""
    routing._policy = [[4096, "cpp-xor"], [1 << 62, "cuda"]]  # both sides of the table
    port_svc = CodecService(engine=engine, device="cpu")
    ref_svc = ref.service.CodecService(engine=engine)
    assert port_svc.rpc_engine({}, b"") == ref_svc.rpc_engine({}, b"") == {"engine": engine,
                                                                           "shm": True}
    for n, m, s in ((12, 4, 4099), (6, 3, 64)):
        args, body, shm_in, shm_out = _request(op, n, m, s, seed=n * 31 + s)
        got = _serve(port_svc, op, args, body, shm_in, shm_out, shm_file)
        assert got == _serve(ref_svc, op, args, body, shm_in, shm_out, shm_file), (n, m, s)
    if op == "crc32" and engine == "numpy":  # zlib on the host: nothing goes to the device
        monkeypatch.setattr(hostio, "to_device", None)
        assert _serve(port_svc, op, args, body, None, 0, shm_file) == got


def test_auto_service_raises_a_failing_cuda_leg_as_500(routing, monkeypatch):
    """No leg stands in for a failing one: the reply is a 500 with the
    leg's error, and the next call goes to ``cuda`` again."""
    routing._policy = [[1 << 62, "cuda"]]
    svc = CodecService(engine="auto", device="cpu")
    srv = rpc.RpcServer(rpc.expose(svc)).start()
    args, body, _, _ = _request("encode", 6, 3, 4096, seed=3)
    real = routing.CudaEngine.encode_parity

    def lost(self, data, n_parity, out=None):
        raise RuntimeError("CUDA error: device lost")

    try:
        monkeypatch.setattr(routing.CudaEngine, "encode_parity", lost)
        with pytest.raises(rpc.RpcError) as err:
            rpc.call(srv.addr, "encode", args, body)
        assert err.value.code == 500 and "device lost" in str(err.value)
        monkeypatch.setattr(routing.CudaEngine, "encode_parity", real)
        meta, payload = rpc.call(srv.addr, "encode", args, body)
        assert payload == _stripes(3, 6, 3, 4096)[:, 6:].tobytes()
        assert routing.last_dispatch["served"] == "cuda"
    finally:
        srv.stop()


def test_auto_role_loads_the_persisted_table(routing):
    table = [[1 << 20, "cpp"], [4 << 20, "cpp-xor"], [16 << 20, "cuda"]]
    with open(routing._policy_path(), "w") as f:
        json.dump({"table": table, "platform": "cpu", "timings_s": {}}, f)
    srv, svc = cmd.run_role({"role": "codec", "ec_engine": "auto", "device": "cpu"})
    try:
        assert svc.engine.name == "auto" and routing._policy == table
        assert rpc.call(srv.addr, "engine", {}, b"")[0] == {"engine": "auto", "shm": True}
    finally:
        srv.stop()


# ---------------- validation: codes and messages ----------------

_GEO = {"n": 4, "m": 2, "shard_size": 8}
_REC = {"n": 4, "total": 6, "shard_size": 8}
_BAD = [  # (method, args, body) the reference refuses
    *[("encode", a, bytes(6 * 8)) for a in (
        {"n": 0, "m": 3, "shard_size": 8}, {"n": 6, "m": -1, "shard_size": 8},
        {"n": 6, "m": 3, "shard_size": 0}, {"n": 6, "m": 3, "shard_size": 8, "batch": 0},
        {"n": "six", "m": 3, "shard_size": 8}, {"m": 3, "shard_size": 8})],
    *[("reconstruct", dict(_REC, present=p, wanted=w), bytes(4 * 8)) for p, w in (
        ([0, 1, 2, 9], [4]), ([0, 1, 2, -1], [4]), ([0, 1, 2, 2], [4]),
        ([0, 1, 2, 3], [6]), ([3, 2, 1, 0], [4]))],
    ("reconstruct", dict(_REC, present=[0, 1], wanted=[4]), bytes(2 * 8)),
    ("reconstruct", dict(_REC, total=3, present=[0, 1, 2], wanted=[1]), bytes(3 * 8)),
    ("reconstruct", dict(_REC, present=[0, 1, 2, 3], wanted=[4]), bytes(3 * 8)),
    ("reconstruct", dict(_REC, present=[0, 1, 2, 3], wanted=[]), bytes(4 * 8)),
    ("reconstruct", dict(_REC, present=None, wanted=[4]), bytes(4 * 8)),
    ("encode", _GEO, bytes(4 * 8 + 1)),
    ("verify", _GEO, bytes(5 * 8)),
    ("verify", dict(_GEO, batch="x"), bytes(6 * 8)),
    ("crc32", {"block_len": 0}, bytes(8)),
    ("crc32", {"block_len": 3}, bytes(8)),
    ("crc32", {}, bytes(8)),
    ("reconstruct_shm", dict(_REC, present=[3, 2, 1, 0], wanted=[4]), b""),
    ("reconstruct_shm", dict(_REC, present=[0, 1], wanted=[4]), b""),
    ("encode_shm", dict(_GEO, shm="/etc/passwd"), b""),
    ("encode_shm", dict(_GEO, shm="/dev/shm/cubefs-codec-x/../../etc/passwd"), b""),
    ("encode_shm", dict(_GEO, shm=SHM_PREFIX + "no-such-file"), b""),
    ("encode_shm", _GEO, b""),
    ("no_such_method", {}, b""),
]


def _refusal(call, addr, method, args, body):
    with pytest.raises(Exception) as ei:
        call(addr, method, args, body)
    return type(ei.value).__name__, ei.value.code, ei.value.message


@pytest.mark.parametrize("method,args,body", _BAD)
def test_refusals_equal_the_reference(port_addr, ref_addr, method, args, body):
    got = _refusal(rpc.call, port_addr, method, args, body)
    assert got == _refusal(rpc.call, ref_addr, method, args, body)
    assert got[1] in (400, 404, 500)


@pytest.mark.parametrize("case", ["symlink", "short", "empty", "directory_entry"])
def test_hostile_or_short_shm_files_are_refused(port_addr, ref_addr, shm_file, tmp_path, case):
    """A symlink planted at a cubefs-codec-* name (O_NOFOLLOW), a file
    shorter than the shapes need, an empty one and a path through a
    directory under the prefix: 400 with the reference's message, and the
    target is not touched."""
    target = tmp_path / "target"
    target.write_bytes(bytes(64))
    if case == "symlink":
        path = shm_file(b"")
        os.unlink(path)
        os.symlink(target, path)
    elif case == "directory_entry":
        path = SHM_PREFIX + "dir/../" + os.path.basename(shm_file(bytes(64)))
    else:
        path = shm_file(bytes(0 if case == "empty" else 4 * 8))
    args = dict(_GEO, shm=path)
    got = _refusal(rpc.call, port_addr, "encode_shm", args, b"")
    assert got == _refusal(rpc.call, ref_addr, "encode_shm", args, b"")
    assert got[1] == 400
    assert target.read_bytes() == bytes(64)


# ---------------- the wire, both ways ----------------

def test_reference_client_against_port_server_and_back(ref, port_addr, ref_addr):
    args, body, _, _ = _request("encode", 6, 3, 4099, seed=5)
    want = ref.rpc.call(ref_addr, "encode", args, body)
    assert ref.rpc.call(port_addr, "encode", args, body) == want  # reference client, port server
    assert rpc.call(ref_addr, "encode", args, body) == want  # port client, reference server
    assert rpc.call(port_addr, "engine") == ({"engine": "cuda", "shm": True}, b"")
    with pytest.raises(ref.rpc.RpcError) as ei:
        ref.rpc.call(port_addr, "encode", dict(args, n=0), body)
    assert (ei.value.code, ei.value.message) == (400, "n=0 must be >= 1")


@pytest.mark.parametrize("headers,status,error", [
    ({"X-Rpc-Crc": "1"}, 400, "request body crc mismatch"),
    ({"X-Rpc-Crc": "x"}, 400, "malformed X-Rpc-Crc"),
    ({"X-Trace": "5f2a:1c:1:/codec"}, 200, None),
    ({"X-Rpc-Args": "{"}, 500, None),
])
def test_raw_wire_headers(port_addr, ref_addr, headers, status, error):
    """The body CRC door, an X-Trace header (accepted, ignored) and
    malformed args answer as the reference's server does."""
    import http.client

    args, body, _, _ = _request("crc32", 6, 3, 4096, seed=6)
    replies = []
    for addr in (port_addr, ref_addr):
        host, p = addr.rsplit(":", 1)
        conn = http.client.HTTPConnection(host, int(p), timeout=30)
        conn.request("POST", "/crc32", body=body,
                     headers={"X-Rpc-Args": json.dumps(args), **headers})
        resp = conn.getresponse()
        replies.append((resp.status, resp.headers.get("X-Rpc-Resp"), resp.read()))
        conn.close()
    assert replies[0] == replies[1]
    assert replies[0][0] == status
    if error:
        assert json.loads(replies[0][1]) == {"error": error}


@pytest.fixture(scope="module")
def native():
    from cubefs_tpu.runtime import build

    return build.load()


@pytest.mark.parametrize("fn", ["cfs_codec_encode", "cfs_codec_encode_shm", "cfs_codec_crc32"])
def test_native_client_against_port_server(native, port_addr, fn):
    host, p = port_addr.rsplit(":", 1)
    n, m, s, b = 6, 3, 4099, 2
    data = np.ascontiguousarray(_stripes(7, n, m, s, b)[:, :n])
    if fn == "cfs_codec_crc32":
        out = np.zeros(b * n, dtype=np.uint32)
        cnt = native.cfs_codec_crc32(host.encode(), int(p), s, data.tobytes(), data.size,
                                     out.ctypes.data_as(ctypes.c_void_p))
        assert cnt == b * n, native.cfs_last_error()
        assert out.tolist() == [zlib.crc32(r.tobytes()) for r in data.reshape(-1, s)]
        return
    parity = np.zeros((b, m, s), dtype=np.uint8)
    src = data.tobytes() if fn == "cfs_codec_encode" else data.ctypes.data_as(ctypes.c_void_p)
    rc = getattr(native, fn)(host.encode(), int(p), n, m, s, b, src,
                             parity.ctypes.data_as(ctypes.c_void_p))
    assert rc == 0, native.cfs_last_error()
    assert np.array_equal(parity, _stripes(7, n, m, s, b)[:, n:])


# ---------------- concurrency and the metrics ----------------

def _scrape(addr) -> dict[str, float]:
    """``GET /metrics`` as {series: value} (series = name plus labels)."""
    import http.client

    host, p = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(p), timeout=30)
    conn.request("GET", "/metrics")
    resp = conn.getresponse()
    text = resp.read().decode()
    conn.close()
    assert resp.status == 200
    return {ln.rsplit(" ", 1)[0]: float(ln.rsplit(" ", 1)[1])
            for ln in text.splitlines() if ln and not ln.startswith("#")}


def test_concurrent_encodes_coalesce_and_count_their_bytes(port_addr):
    """16 threads encode EC12P4 stripes over HTTP at once: every reply is
    exact, and the server's /metrics show fewer device steps than
    submissions, every submission and exactly the body bytes sent (a
    lost counter update would break the last two)."""
    n, m, s, threads, per = 12, 4, 1 << 16, 16, 3
    full = [_stripes(100 + i, n, m, s, 1) for i in range(threads * per)]
    replies = [None] * len(full)
    start = threading.Barrier(threads)

    def worker(i):
        start.wait(30.0)
        for j in range(per):
            k = i * per + j
            replies[k] = rpc.call(port_addr, "encode", {"n": n, "m": m, "shard_size": s},
                                  full[k][:, :n].tobytes())

    steps = 'cubefs_codec_batch_steps_total{op="encode",engine="cuda"}'
    subs = 'cubefs_codec_batch_submissions_total{op="encode"}'
    nbytes = 'cubefs_codec_bytes_total{op="encode",engine="cuda"}'
    before = _scrape(port_addr)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # thread switches inside the counters' updates
    try:
        pool = [threading.Thread(target=worker, args=(i,)) for i in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(120.0)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in pool)
    after = _scrape(port_addr)
    for k, (meta, payload) in enumerate(replies):
        assert meta == {"shape": [1, m, s]} and payload == full[k][:, n:].tobytes()
    d = {k: after.get(k, 0.0) - before.get(k, 0.0) for k in (steps, subs, nbytes)}
    assert d[subs] == len(full)
    assert 0 < d[steps] < d[subs]
    assert d[nbytes] == len(full) * n * s


@pytest.mark.parametrize("name", FAMILIES)
def test_metric_families_equal_the_reference(ref, name):
    mine, theirs = metrics.DEFAULT._metrics[name], ref.metrics.DEFAULT._metrics[name]
    assert ((mine.TYPE, mine.help, mine.label_names)
            == (theirs.TYPE, theirs.help, theirs.label_names))
    assert getattr(mine, "BUCKETS", None) == getattr(theirs, "BUCKETS", None)
    assert f"# TYPE {name} {theirs.TYPE}\n" in metrics.render_text()
    assert f"# TYPE {name} {theirs.TYPE}\n" in ref.metrics.DEFAULT.render_text()


def _counts(mod, op) -> dict:
    """The batcher families' totals for ``op``, engine labels summed (a
    histogram's as its count and sum)."""
    def total(metric, field="count", **want):
        out = 0.0
        for k, v in metric.samples():
            if all(k[metric.label_names.index(a)] == b for a, b in dict(op=op, **want).items()):
                out += v[field] if isinstance(v, dict) else v
        return out

    return {"submissions": total(mod.codec_batch_submissions),
            "steps": total(mod.codec_batch_steps),
            "steps_of_stripes": total(mod.codec_batch_stripes),
            "stripes_in_steps": total(mod.codec_batch_stripes, "sum"),
            "waits": total(mod.codec_batch_wait),
            "backpressure": total(mod.codec_batch_backpressure),
            "dtype_errors": total(mod.codec_batch_errors, kind="dtype")}


class _Gate:
    """Holds a device step until released, to keep a drain in flight."""

    def __init__(self):
        self.entered, self.release = threading.Event(), threading.Event()

    def wrap(self, cls):
        gate = self

        class Held(cls):
            def _engine_call(self, *a, **kw):
                gate.entered.set()
                assert gate.release.wait(30.0)
                return super()._engine_call(*a, **kw)

        return Held


def _drive_batcher(bc_cls, make, submit_async, collect, bad_dtype):
    """One script of submissions: 3 parked then collected (one step of 3),
    one alone, a malformed one beside a good one, the door closed, and a
    submitter that meets backpressure behind a held drain."""
    bc = bc_cls(enabled=True)
    futs = [submit_async(bc, make(i, 2)) for i in range(3)]
    for f in futs:
        collect(f)
    collect(submit_async(bc, make(3, 1)))
    futs = [submit_async(bc, bad_dtype(make(4, 1))), submit_async(bc, make(5, 1))]
    with pytest.raises(Exception):
        collect(futs[0])
    collect(futs[1])
    collect(submit_async(bc_cls(enabled=False), make(6, 2)))
    gate = _Gate()
    held = gate.wrap(bc_cls)(enabled=True, max_pending=2)
    first = submit_async(held, make(7, 2))
    t = threading.Thread(target=collect, args=(first,))
    t.start()
    assert gate.entered.wait(30.0)
    with pytest.raises(Exception, match="pending"):
        submit_async(held, make(8, 1), timeout=0.05)
    gate.release.set()
    t.join(30.0)
    assert not t.is_alive()


def test_batcher_counters_move_as_the_reference(ref, rng):
    n, m, s = 6, 3, 64
    data = [rng.integers(0, 256, (2, n, s), dtype=np.uint8) for _ in range(9)]

    def ref_run():
        _drive_batcher(
            ref.batcher.BatchCodec, lambda i, b: data[i][:b],
            lambda bc, x, timeout=30.0: bc.submit_encode_async("numpy", x, m, timeout=timeout),
            lambda f: f.result(30.0), lambda x: x.astype(np.uint16))

    def port_run():
        _drive_batcher(
            tb.BatchCodec, lambda i, b: torch.from_numpy(data[i][:b]),
            lambda bc, x, timeout=30.0: bc.submit_encode_async("cpu", x, m, timeout=timeout),
            lambda f: f.result(30.0), lambda x: x.to(torch.int16))

    deltas = []
    for mod, run in ((ref.metrics, ref_run), (metrics, port_run)):
        before = _counts(mod, "encode")
        run()
        after = _counts(mod, "encode")
        deltas.append({k: after[k] - before[k] for k in after})
    assert deltas[0] == deltas[1]
    assert deltas[1] == {"submissions": 11, "steps": 5, "steps_of_stripes": 4,
                         "stripes_in_steps": 10, "waits": 6, "backpressure": 1,
                         "dtype_errors": 1}


def test_rows_cache_counters_move_as_the_reference(ref):
    """The same MSR rows, built cold then warm, count the same hits,
    misses and resident entries in both packages' rows caches."""
    def calls(mod):
        mod.encode_rows.cache_clear()
        mod.helper_rows.cache_clear()
        for _ in range(2):
            mod.encode_rows(6, 12, 11)
            for f in (0, 5):
                mod.helper_rows(6, 12, 11, f)

    def read(mod):
        c = mod.codec_program_cache
        return {e: c.value(family="msr", event=e) for e in ("hit", "miss", "evict")}

    deltas = []
    for mod, rows in ((ref.metrics, ref.msr), (metrics, msr)):
        before = read(mod)
        calls(rows)
        after = read(mod)
        deltas.append({e: after[e] - before[e] for e in after})
    assert deltas[0] == deltas[1]
    assert deltas[1]["miss"] > 0 and deltas[1]["hit"] > 0
    assert metrics.codec_program_cache_entries.value() == len(msr.progcache.SHARED)


# ---------------- the host adaptor ----------------

@pytest.mark.parametrize("src", ["bytes", "memoryview", "memmap"])
def test_hostio_copies_never_alias_and_stage_per_thread(tmp_path, src):
    x = np.random.default_rng(3).integers(0, 256, (2, 5, 7), dtype=np.uint8)
    mm = None
    if src == "memmap":
        path = tmp_path / "f"
        path.write_bytes(x.tobytes() + bytes(x.size))
        mm = np.memmap(path, dtype=np.uint8, mode="r+")
        buf = mm[: x.size]
    else:
        buf = x.tobytes() if src == "bytes" else memoryview(x.tobytes())
    t = hostio.to_device(buf, x.shape, "cpu")
    t += 1  # writable, and no write reaches the source
    assert np.array_equal(np.frombuffer(buf, np.uint8).reshape(x.shape), x)
    assert np.array_equal(t.numpy(), x + 1)
    if mm is not None:
        assert hostio.to_host(t, out=mm[x.size:]) is not None
        assert np.array_equal(np.asarray(mm[x.size:]).reshape(x.shape), x + 1)
    host = hostio.to_host(t)
    assert torch.equal(host, t) and host.data_ptr() != t.data_ptr()
    assert hostio._STAGING.buf.numel() >= x.size
    with pytest.raises(ValueError, match="do not fill"):
        hostio.to_device(buf, (3, 5, 7), "cpu")
    with pytest.raises(ValueError, match="cannot take"):
        hostio.to_host(t, out=np.zeros(x.size - 1, np.uint8))


# ---------------- the codec role ----------------

def test_cmd_serves_the_codec_role_and_stops_on_sigterm(tmp_path):
    cfg = tmp_path / "codec.json"
    cfg.write_text(json.dumps({"role": "codec", "listen_port": 0, "device": "cpu"}))
    proc = subprocess.Popen([sys.executable, "-m", "cubefs_tpu_torch.cmd", "-c", str(cfg)],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        line = proc.stdout.readline()
        m = re.fullmatch(r"\[codec\] listening on (\S+)\n", line)
        assert m, (line, proc.stderr.read() if proc.poll() is not None else "")
        args, body, _, _ = _request("encode", 6, 3, 4096, seed=8)
        meta, payload = rpc.call(m.group(1), "encode", args, body)
        assert payload == _stripes(8, 6, 3, 4096)[:, 6:].tobytes()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0
        assert proc.stdout.read() == "[codec] shutting down\n"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)


def test_cmd_refuses_other_roles_and_engines():
    from cubefs_tpu import cmd as ref_cmd

    for run_role in (cmd.run_role, ref_cmd.run_role):  # a role neither package has
        with pytest.raises(SystemExit, match="^unknown role 'cfs-bogus'$"):
            run_role({"role": "cfs-bogus"})
    with pytest.raises(KeyError, match="unknown ec engine 'tpu'"):
        cmd.run_role({"role": "codec", "ec_engine": "tpu", "device": "cpu"})


# ---------------- on the card ----------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("op", OPS)
def test_service_on_card_equals_plain(cuda_device, shm_file, op):
    """The service on the card answers as on the CPU (plain versions)."""
    card, plain = CodecService(device=cuda_device), CodecService(device="cpu")
    args, body, shm_in, shm_out = _request(op, 12, 4, 4099, seed=9)
    assert (_serve(card, op, args, body, shm_in, shm_out, shm_file)
            == _serve(plain, op, args, body, shm_in, shm_out, shm_file))
