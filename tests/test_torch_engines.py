"""The port's codec engine layer (``cubefs_tpu_torch/codec/engine.py``,
``ops/xorprog.py``, ``ops/gfcpu.py``, ``ops/progcache.py``) against the
reference's (``cubefs_tpu/codec/engine.py``, ``ops/xorprog.py``).

Every engine of the port is held byte for byte against the reference's
engine of the same name (``numpy``, ``cpp``, ``numpy-xor``, ``cpp-xor``;
the port's ``cuda`` with ``device="cpu"`` against the reference's
``tpu``, JAX on the CPU) on RS, LRC and MSR encode and repair matrices,
zero rows, an empty S and the pinned goldens, and every XOR schedule has
the reference's digest and op stream. Then the routing: the platform
stamp of the crossover table and its refusal, a stale or malformed table
logged and replaced by the static split, routing by size, the
``CUBEFS_CODEC_DEAD`` drill in both positions of the XOR door with no
quarantine, and a ``cuda`` leg that raises making ``auto`` raise.

Numpy-seeded inputs; tolerance: exact equality. The host library and the
reference's native runtime are built in fixtures (g++). Every test that
measures or persists a table points the table's path at ``tmp_path``.
"""

import json
import logging
import os
import threading
import types

import numpy as np
import pytest
import torch

from cubefs_tpu_torch.codec import codemode as tcm
from cubefs_tpu_torch.codec import engine as E
from cubefs_tpu_torch.codec.encoder import CodecConfig, new_encoder
from cubefs_tpu_torch.ops import gf256, gfcpu, msr, progcache, rs_kernel, xorprog

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
HOST = ["numpy", "cpp", "numpy-xor", "cpp-xor"]


def _lrc_rows() -> np.ndarray:
    return new_encoder(CodecConfig(tcm.CodeMode.EC16P20L2, engine="numpy"))._encode_rows


MATRICES = {  # name -> (R, C) GF(2^8) coefficients
    "rs6p3_encode": lambda: gf256.parity_matrix(6, 3),
    "rs12p4_encode": lambda: gf256.parity_matrix(12, 4),
    "rs12p4_rows_1_7": lambda: rs_kernel.reconstruct_rows(
        12, 16, [i for i in range(16) if i not in (1, 7)], [1, 7]),
    "lrc_ec16p20l2_rows": _lrc_rows,
    "msr_ec6p6_encode": lambda: msr.encode_rows(6, 12, 11),
    "msr_ec6p6_repair_0": lambda: msr.repair_rows(6, 12, 11, 0, tuple(range(1, 12))),
    "zero_rows": lambda: np.array([[0, 0, 0, 0], [3, 0, 7, 0], [0, 0, 0, 0]], np.uint8),
    "identity": lambda: np.eye(5, dtype=np.uint8),
}


@pytest.fixture(scope="module")
def ref():
    """The reference's modules (they import jax) and its native runtime."""
    from cubefs_tpu.codec import engine as ref_engine
    from cubefs_tpu.ops import xorprog as ref_xorprog

    return types.SimpleNamespace(
        engine=ref_engine, xorprog=ref_xorprog,
        engines={name: ref_engine.get_engine(name) for name in ("tpu", *HOST)})


@pytest.fixture(scope="module")
def port():
    """The port's engines, the host library built first."""
    gfcpu.load()
    return {name: E.get_engine(name) for name in HOST}


@pytest.fixture(autouse=True)
def _routing_state(monkeypatch, tmp_path):
    """A private table path and policy, no drill, the XOR door open."""
    monkeypatch.setattr(E, "_policy_path", lambda: str(tmp_path / "CROSSOVER.json"))
    monkeypatch.setattr(E, "_policy", None)
    monkeypatch.setattr(E, "last_dispatch", dict.fromkeys(("method", "requested", "served")))
    monkeypatch.delenv("CUBEFS_CODEC_DEAD", raising=False)
    monkeypatch.delenv("CUBEFS_CODEC_XOR", raising=False)
    monkeypatch.delenv("CUBEFS_TPU_EC_ENGINE", raising=False)


def _shards(seed, lead, c, s):
    return np.random.default_rng(seed).integers(0, 256, (*lead, c, s), dtype=np.uint8)


# ---------------- every engine against the reference's ----------------

@pytest.mark.parametrize("s", [64, 4099])
@pytest.mark.parametrize("matrix", sorted(MATRICES))
def test_engines_equal_the_reference(ref, port, matrix, s):
    coeff = MATRICES[matrix]()
    x = _shards(s + len(matrix), (2,), coeff.shape[1], s)
    want = ref.engines["numpy"].matrix_apply(coeff, x)
    assert want.shape == (2, coeff.shape[0], s)
    for name in HOST:
        got = port[name].matrix_apply(coeff, x)
        assert got.dtype == np.uint8 and np.array_equal(got, ref.engines[name].matrix_apply(coeff, x))
        assert np.array_equal(got, want), name
        assert np.array_equal(port[name].matrix_apply(coeff, x[1]), want[1]), f"{name} 2-D"
    cuda = E.get_engine("cuda", "cpu").matrix_apply(coeff, torch.from_numpy(x))
    assert np.array_equal(cuda.numpy(), np.asarray(ref.engines["tpu"].matrix_apply(coeff, x)))


@pytest.mark.parametrize("matrix", sorted(MATRICES))
def test_schedules_equal_the_reference(ref, matrix):
    coeff = MATRICES[matrix]()
    got, want = xorprog.XorProgram(coeff), ref.xorprog.XorProgram(coeff)
    assert got.schedule_digest == want.schedule_digest
    assert np.array_equal(got.opstream(), want.opstream())
    assert got.stats() == want.stats()
    assert (got.nslots, got.n_temps, got.block_bytes) == (want.nslots, want.n_temps,
                                                          want.block_bytes)


@pytest.mark.parametrize("n,m", [(6, 3), (12, 4), (4, 1)])
def test_encode_parity_equals_the_reference(ref, port, n, m):
    x = _shards(n * m, (3,), n, 1000)
    for name in HOST:
        assert np.array_equal(port[name].encode_parity(x, m), ref.engines[name].encode_parity(x, m))
    cuda = E.get_engine("cuda", "cpu").encode_parity(torch.from_numpy(x), m).numpy()
    assert np.array_equal(cuda, np.asarray(ref.engines["tpu"].encode_parity(x, m)))


def test_empty_s(ref, port):
    """S = 0 answers empty rows. The reference's engines answer a 2-D
    empty stripe (its ``numpy-xor`` raises there, and its ``numpy`` and
    ``numpy-xor`` raise on a batch); the port answers both."""
    coeff = MATRICES["rs6p3_encode"]()
    x2, x3 = np.zeros((6, 0), np.uint8), np.zeros((3, 6, 0), np.uint8)
    for name in HOST:
        assert port[name].matrix_apply(coeff, x2).shape == (3, 0)
        assert port[name].matrix_apply(coeff, x3).shape == (3, 3, 0)
        if name != "numpy-xor":
            assert ref.engines[name].matrix_apply(coeff, x2).shape == (3, 0)
    assert E.get_engine("cuda", "cpu").matrix_apply(coeff, torch.from_numpy(x3)).shape == (3, 3, 0)


@pytest.mark.parametrize("name,n,m,rows", [("rs6p3.bin", 6, 3, 9), ("rs12p4.bin", 12, 4, 16),
                                           ("ec16p20l2.bin", 16, 20, 38)])
def test_pinned_goldens(port, name, n, m, rows):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        golden = np.frombuffer(f.read(), dtype=np.uint8).reshape(rows, 512)
    coeff = gf256.parity_matrix(n, m) if rows == n + m else _lrc_rows()
    for eng in [*port.values(), E.AutoEngine("cpu")]:
        assert np.array_equal(eng.matrix_apply(coeff, golden[:n]), golden[n:]), eng.name
    cuda = E.get_engine("cuda", "cpu").matrix_apply(coeff, torch.from_numpy(golden[:n].copy()))
    assert np.array_equal(cuda.numpy(), golden[n:])


def test_host_engines_take_cpu_tensors_and_refuse_others(port):
    coeff = MATRICES["rs6p3_encode"]()
    x = _shards(3, (2,), 6, 128)
    for name in HOST:
        assert np.array_equal(port[name].matrix_apply(coeff, torch.from_numpy(x)),
                              port["numpy"].matrix_apply(coeff, x))
        with pytest.raises(ValueError, match="host engines take"):
            port[name].matrix_apply(coeff, torch.from_numpy(x).to("meta"))


# ---------------- the registry, the host build, the cache ----------------

def test_registry(monkeypatch):
    for name in HOST:
        assert E.get_engine(name).name == name and E.get_engine(name) is E.get_engine(name)
    assert E.get_engine("cuda", "cpu").name == "cuda"
    assert E.get_engine("auto", "cpu").name == "auto"
    with pytest.raises(KeyError, match="unknown ec engine 'tpu'"):
        E.get_engine("tpu", "cpu")
    monkeypatch.setenv("CUBEFS_TPU_EC_ENGINE", "cpp-xor")
    assert E.get_engine().name == "cpp-xor"
    # a name asked for is never routed, the drill notwithstanding
    monkeypatch.setenv("CUBEFS_CODEC_DEAD", "cuda,cpp")
    assert isinstance(E.get_engine("cuda", "cpu"), E.CudaEngine)
    assert E.get_engine("cpp").name == "cpp"


def test_host_build_is_atomic_under_concurrent_builds(monkeypatch, tmp_path):
    monkeypatch.setattr(gfcpu, "BUILD_DIR", str(tmp_path))
    paths, errors = [], []

    def build_once():
        try:
            paths.append(gfcpu.build())
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=build_once) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120.0)
    assert not errors and len(set(paths)) == 1
    assert os.listdir(tmp_path) == [os.path.basename(paths[0])]  # no temporary left
    assert paths[0].startswith(str(tmp_path)) and os.path.getsize(paths[0]) > 0


def test_failed_host_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(gfcpu, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="host GF library build failed"):
        gfcpu.build()
    assert os.listdir(tmp_path) == []


def test_program_cache_get_or_build_and_clear():
    cache = progcache.ProgramCache(capacity=8)
    built = []
    assert cache.get_or_build("xorprog", "k", lambda: built.append(1) or "v") == "v"
    assert cache.get_or_build("xorprog", "k", lambda: built.append(1) or "w") == "v"
    assert built == [1] and len(cache) == 1
    cache.clear()
    assert len(cache) == 0 and cache.get("xorprog", "k") == (False, None)
    coeff = MATRICES["rs6p3_encode"]()
    assert xorprog.program_for(coeff) is xorprog.program_for(coeff)


# ---------------- the crossover table ----------------

def _write_table(monkeypatch_path, table, platform):
    with open(monkeypatch_path, "w") as f:
        json.dump({"table": table, "platform": platform}, f)


def test_table_of_another_platform_is_refused_and_remeasured(monkeypatch, caplog):
    """A table measured where the device leg is the plain version must
    not route a process with a card, nor a TPU-era table any process:
    it is logged and re-measured once, and the new table cached."""
    path = E._policy_path()
    remeasured = [[1 << 62, "cuda"]]
    calls = []

    def fake_measure(*a, **kw):
        calls.append(kw.get("device"))
        E._policy = remeasured
        return remeasured

    monkeypatch.setattr(E, "measure_crossover", fake_measure)
    monkeypatch.setattr(E, "_platform", lambda device=None: "cuda")
    for stamped in ("cpu", "tpu"):
        _write_table(path, [[1 << 62, "cpp"]], stamped)
        monkeypatch.setattr(E, "_policy", None)
        with caplog.at_level(logging.WARNING, logger="cubefs.codec"):
            assert E._load_policy() == remeasured
        assert E._load_policy() == remeasured  # cached: no second measurement
        assert any("stale crossover policy" in r.message and repr(stamped) in r.message
                   for r in caplog.records)
    assert len(calls) == 2
    # stamped with this process's platform: trusted as it is
    _write_table(path, [[1 << 20, "cpp-xor"], [1 << 62, "cuda"]], "cuda")
    monkeypatch.setattr(E, "_policy", None)
    assert E._load_policy() == [[1 << 20, "cpp-xor"], [1 << 62, "cuda"]]
    assert len(calls) == 2


def test_platform_follows_the_device_leg(monkeypatch):
    assert E._platform("cpu") == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert E._platform() == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert E._platform() == "cuda" and E._platform("cpu") == "cpu"


@pytest.mark.parametrize("content", ['{"table": "x", "platform": "cpu"}',
                                     '{"table": [[1024, "tpu"]], "platform": "cpu"}',
                                     '{"platform": "cpu"}', "not json {", "[1, 2]"])
def test_malformed_or_unreadable_table_is_logged_then_static(caplog, content):
    with open(E._policy_path(), "w") as f:
        f.write(content)
    with caplog.at_level(logging.WARNING, logger="cubefs.codec"):
        assert E._load_policy("cpu") == E._static_policy() == [[1 << 20, "cpp"], [1 << 62, "cuda"]]
    assert any("crossover policy" in r.message for r in caplog.records)


def test_no_table_is_the_static_split(caplog):
    with caplog.at_level(logging.WARNING, logger="cubefs.codec"):
        assert E._load_policy("cpu") == E._static_policy()
    assert not caplog.records


def test_measure_crossover_times_every_leg_stamps_and_persists():
    table = E.measure_crossover(sizes=(4096, 8192), repeats=1, device="cpu")
    with open(E._policy_path()) as f:
        saved = json.load(f)
    assert saved["table"] == table and saved["platform"] == "cpu"
    assert [row[0] for row in table] == [4096, 8192]
    assert all(row[1] in E._CANDIDATES for row in table)
    assert sorted(saved["timings_s"]) == ["4096", "8192"]
    for per in saved["timings_s"].values():
        assert sorted(per) == sorted(E._CANDIDATES) and all(v > 0 for v in per.values())
    crossover = saved["device_crossover_bytes"]
    assert crossover is None or crossover in (4096, 8192)
    E._policy = None
    assert E._load_policy("cpu") == table  # what a later process loads


# ---------------- routing ----------------

def test_routing_by_size(monkeypatch):
    """The table's size classes bound inclusively; sizes beyond it go to
    ``cuda``; ``auto`` is byte-equal to the golden either side, and
    ``last_dispatch`` names the leg each time."""
    monkeypatch.setattr(E, "_policy", [[1024, "numpy"], [4096, "cpp"]])
    assert E.policy_leg(1024) == "numpy" and E.policy_leg(1025) == "cpp"
    assert E.policy_leg(4097) == "cuda"
    assert E.engine_for(1024).name == "numpy-xor"  # the XOR door, open by default
    monkeypatch.setenv("CUBEFS_CODEC_XOR", "0")
    assert E.engine_for(1024).name == "numpy"
    monkeypatch.delenv("CUBEFS_CODEC_XOR")
    auto = E.AutoEngine("cpu")
    golden = E.get_engine("numpy")
    for (b, s), served in (((1, 256), "numpy-xor"), ((2, 512), "cpp"), ((4, 2048), "cuda")):
        x = _shards(s, (b,), 4, s)
        assert np.array_equal(auto.encode_parity(x, 2), golden.encode_parity(x, 2))
        assert E.last_dispatch == {"method": "encode_parity", "requested": E.policy_leg(x.nbytes),
                                   "served": served}
        got = auto.matrix_apply(MATRICES["zero_rows"](), torch.from_numpy(x))
        assert isinstance(got, np.ndarray)
        assert np.array_equal(got, golden.matrix_apply(MATRICES["zero_rows"](), x))


@pytest.mark.parametrize("door", ["open", "closed"])
def test_drill_walks_the_chain_logs_and_quarantines_nothing(monkeypatch, caplog, door):
    """With every leg above the host's numpy legs drilled dead, a routed
    ``cuda`` call lands on the leg the XOR door picks, byte-equal, one
    WARNING per (requested, served) pair; cleared, ``cuda`` serves again."""
    coeff = MATRICES["msr_ec6p6_repair_0"]()
    recv = _shards(0xD12, (), coeff.shape[1], 3 * 64)
    gold = gf256.gf_matmul(coeff, recv)
    monkeypatch.setattr(E, "_policy", [[1 << 62, "cuda"]])
    if door == "closed":
        monkeypatch.setenv("CUBEFS_CODEC_XOR", "0")
    served = "numpy-xor" if door == "open" else "numpy"
    digest = xorprog.program_for(coeff).schedule_digest
    monkeypatch.setenv("CUBEFS_CODEC_DEAD", "cuda, cpp,cpp-xor")
    auto = E.AutoEngine("cpu")
    with caplog.at_level(logging.WARNING, logger="cubefs.codec"):
        for _ in range(3):
            assert np.array_equal(auto.matrix_apply(coeff, recv), gold)
            assert E.last_dispatch == {"method": "matrix_apply", "requested": "cuda",
                                       "served": served}
    warned = [r.message for r in caplog.records if "CUBEFS_CODEC_DEAD" in r.message]
    assert warned == [f"CUBEFS_CODEC_DEAD=cpp,cpp-xor,cuda: 'cuda' served by {served!r}"]
    assert xorprog.program_for(coeff).schedule_digest == digest
    monkeypatch.setenv("CUBEFS_CODEC_DEAD", "cuda")
    assert E.route("cuda") == "cpp"
    monkeypatch.delenv("CUBEFS_CODEC_DEAD")
    assert np.array_equal(auto.matrix_apply(coeff, recv), gold)
    assert E.last_dispatch["served"] == "cuda"
    monkeypatch.setenv("CUBEFS_CODEC_DEAD", ",".join(E._FALLBACK_CHAIN))
    with pytest.raises(RuntimeError, match="drilled dead"):
        auto.matrix_apply(coeff, recv)


def test_raising_cuda_leg_raises_through_auto_and_quarantines_nothing(monkeypatch):
    """The opposite of the reference's device-loss test: an error of the
    ``cuda`` leg is the caller's, and the next call tries ``cuda`` again."""
    monkeypatch.setattr(E, "_policy", [[1 << 62, "cuda"]])
    auto = E.AutoEngine("cpu")
    x = _shards(5, (2,), 6, 256)
    real = E.CudaEngine.encode_parity

    def lost(self, data, n_parity, out=None):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(E.CudaEngine, "encode_parity", lost)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="illegal memory access"):
            auto.encode_parity(x, 3)
        assert E.last_dispatch["served"] is None
    monkeypatch.setattr(E.CudaEngine, "encode_parity", real)
    assert np.array_equal(auto.encode_parity(x, 3), E.get_engine("numpy").encode_parity(x, 3))
    assert E.last_dispatch["served"] == "cuda"


def test_auto_refuses_device_tensors():
    with pytest.raises(ValueError, match="host engines take"):
        E.AutoEngine("cpu").encode_parity(torch.zeros((6, 64), dtype=torch.uint8, device="meta"), 3)
