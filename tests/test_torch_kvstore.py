"""The port's ordered KV store (``cubefs_tpu_torch/runtime/kvstore.py`` over
its copy of ``kvstore.cc``) held against the reference's
(``cubefs_tpu/runtime/kvstore.py``) on the CPU.

- every scenario of ``tests/test_kvstore.py`` runs on the port
  (``port_copy``);
- one seeded sequence of puts, deletes, batches and compactions goes
  through a store of each package: every answer (``get``, ``scan``,
  ``median_key``, ``count``, ``wal_bytes``, ``snap_bytes``) is equal
  after each step, and the two directories hold the same bytes;
- a directory written by either package opens in the other with the
  same contents, also after a torn WAL tail, which both truncate.
"""

import os
import types

import numpy as np
import pytest

from cubefs_tpu_torch.runtime import kvstore
from test_torch_raft import port_copy, run_scenario, scenarios

SEED = 20260417
KV = port_copy("test_kvstore")


@pytest.mark.parametrize("name", scenarios(KV))
def test_reference_kvstore_scenario_on_the_port(name, request):
    run_scenario(KV, name, request)


@pytest.fixture(scope="module")
def ref():
    from cubefs_tpu.runtime import kvstore as ref_kv

    return types.SimpleNamespace(kvstore=ref_kv)


PORT = types.SimpleNamespace(kvstore=kvstore)


def ops(seed=SEED, n=600):
    """A seeded mix of puts (keys from a small alphabet, so rewrites and
    deletes hit), deletes, batches and compactions."""
    rng = np.random.default_rng(seed)
    keys = [f"k{int(i):03d}".encode() for i in rng.integers(0, 120, n)]
    out = []
    for i, k in enumerate(keys):
        r = rng.random()
        if r < 0.6:
            out.append(("put", k, rng.integers(0, 256, int(rng.integers(0, 300)),
                                               dtype=np.uint8).tobytes()))
        elif r < 0.8:
            out.append(("delete", k, None))
        elif r < 0.97:
            batch = [("put", f"b{i}-{j}".encode(), bytes([j]) * j) for j in range(5)]
            out.append(("batch", batch + [("delete", keys[i - 1], None)], None))
        else:
            out.append(("compact", None, None))
    return out


def apply(store, op):
    kind, key, value = op
    try:
        if kind == "put":
            store.put(key, value)
        elif kind == "delete":
            store.delete(key)
        elif kind == "batch":
            store.apply_batch(key)
        else:
            store.compact()
    except KeyError:
        return "KeyError"
    return None


def answers(store) -> tuple:
    keys = [b"k000", b"k050", b"k119", b"b3-2", b"nope"]
    got = []
    for k in keys:
        try:
            got.append(store.get(k))
        except KeyError:
            got.append(None)
    return (got, list(store.scan()), list(store.scan(b"k010", b"k090", max_items=17)),
            store.median_key(), store.median_key(b"k050", b"k060"), store.count(),
            store.wal_bytes(), store.snap_bytes())


def files(d) -> dict:
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))}


def test_seeded_sequence_gives_equal_answers_and_bytes(ref, tmp_path):
    a = ref.kvstore.KvStore(str(tmp_path / "ref"))
    b = kvstore.KvStore(str(tmp_path / "port"))
    try:
        for i, op in enumerate(ops()):
            assert apply(b, op) == apply(a, op), (i, op[0])
            if i % 50 == 0 or op[0] == "compact":
                assert answers(b) == answers(a), i
        assert answers(b) == answers(a)
        assert files(tmp_path / "port") == files(tmp_path / "ref")
        a.compact()
        b.compact()
        assert answers(b) == answers(a)
    finally:
        a.close()
        b.close()
    assert files(tmp_path / "port") == files(tmp_path / "ref")
    assert set(files(tmp_path / "port")) == {"kv.snap", "kv.wal"}


@pytest.mark.parametrize("torn", [False, True])
@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_directory_opens_in_both_packages(ref, tmp_path, direction, torn):
    writer, reader = (ref, PORT) if direction == "ref_to_port" else (PORT, ref)
    d = str(tmp_path / "kv")
    w = writer.kvstore.KvStore(d)
    seq = ops(SEED + 1, 300)
    for op in seq[:200]:
        apply(w, op)
    w.compact()
    for op in seq[200:]:
        apply(w, op)  # these live in the WAL only
    want = answers(w)
    w.close()
    if torn:  # an unacknowledged tail write: a frame cut short
        with open(os.path.join(d, "kv.wal"), "ab") as f:
            f.write(b"\x12\x34\x56\x78\x40\x00\x00\x00\x01torn")
    r = reader.kvstore.KvStore(d)
    try:
        assert answers(r) == want  # the torn tail is gone: wal_bytes as written
        r.put(b"after", b"reopen")
    finally:
        r.close()
    again = writer.kvstore.KvStore(d)
    try:
        assert again.get(b"after") == b"reopen"
        assert again.count() == want[5] + 1
    finally:
        again.close()
