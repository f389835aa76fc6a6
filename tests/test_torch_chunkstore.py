"""The port's chunk store (``cubefs_tpu_torch/blob/chunkstore.py`` over its
copies of the native sources) held against the reference's
(``cubefs_tpu/blob/chunkstore.py``): one seeded operation script on both
gives equal results, errors and directory bytes; a directory written by
either opens in the other; CRCs equal zlib's; bit-rot is refused and
counted; a failed build raises."""

import os
import threading
import zlib

import numpy as np
import pytest

from cubefs_tpu_torch.blob import chunkstore as port
from cubefs_tpu_torch.utils import metrics


@pytest.fixture(scope="module")
def ref():
    from cubefs_tpu.blob import chunkstore

    return chunkstore


def _script(seed: int) -> list[tuple]:
    """A seeded sequence of store operations over three chunks: puts
    (some overwrites, some empty), deletes (some of missing shards),
    gets, listings, counts, syncs, compactions and reopens."""
    rng = np.random.default_rng(seed)
    ops = [("create_chunk", c) for c in (1, 2, 3)]
    for _ in range(60):
        chunk, bid = int(rng.integers(1, 4)), int(rng.integers(0, 12))
        kind = rng.choice(["put", "put", "put", "delete", "get", "list", "count",
                           "compact", "sync", "reopen"], p=[.2, .15, .15, .12, .12, .06, .05,
                                                            .06, .04, .05])
        if kind == "put":
            n = int(rng.choice([0, 1, 7, 4096, 65_537]))
            ops.append(("put_shard", chunk, bid, rng.integers(0, 256, n, dtype=np.uint8)
                        .tobytes()))
        elif kind == "delete":
            ops.append(("delete_shard", chunk, bid))
        elif kind == "get":
            ops.append(("get_shard", chunk, bid))
        elif kind == "list":
            ops.append(("list_shards", chunk))
        elif kind == "count":
            ops.append(("shard_count", chunk))
        elif kind == "compact":
            ops.append(("compact", chunk))
        elif kind == "sync":
            ops.append(("sync", chunk))
        else:
            ops.append(("reopen",))
    return ops + [("list_shards", c) for c in (1, 2, 3)]


def _run(mod, directory: str, ops: list[tuple]) -> list:
    """Apply the script; each result, or the error's class name."""
    store, out = mod.ChunkStore(directory), []
    for op in ops:
        if op[0] == "reopen":
            store.close()
            store = mod.ChunkStore(directory)
            out.append("reopened")
            continue
        try:
            got = getattr(store, op[0])(*op[1:])
            out.append([tuple(r) for r in got] if op[0] == "list_shards" else got)
        except Exception as e:  # the error is part of the result
            out.append(type(e).__name__)
    store.close()
    return out


def _files(directory: str) -> dict[str, bytes]:
    return {f: open(os.path.join(directory, f), "rb").read()
            for f in sorted(os.listdir(directory))}


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_operation_script_equals_the_reference(ref, tmp_path, seed):
    ops = _script(seed)
    want = _run(ref, str(tmp_path / "ref"), ops)
    got = _run(port, str(tmp_path / "port"), ops)
    assert got == want
    assert "ShardNotFoundError" in got  # the script reaches the error paths
    assert _files(str(tmp_path / "port")) == _files(str(tmp_path / "ref"))


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_a_directory_written_by_one_store_opens_in_the_other(ref, tmp_path, writer, reader):
    mods = {"ref": ref, "port": port}
    ops = _script(9)
    d = str(tmp_path / "disk")
    _run(mods[writer], d, ops)
    listings = _run(mods[writer], d, [("list_shards", c) for c in (1, 2, 3)])
    reads = [("get_shard", c, b) for c in (1, 2, 3) for b, _, _ in listings[c - 1]]
    assert reads
    want = _run(mods[writer], d, reads)
    assert _run(mods[reader], d, [("list_shards", c) for c in (1, 2, 3)] + reads) == \
        listings + want
    # the reader appends; the writer reads that back too
    _run(mods[reader], d, [("put_shard", 2, 77, b"from the reader")])
    assert _run(mods[writer], d, [("get_shard", 2, 77)]) == \
        [(b"from the reader", zlib.crc32(b"from the reader"))]


@pytest.mark.parametrize("n", [0, 1, 7, 8, 63, 1024, 100_001, (1 << 20) + 3])
def test_crcs_equal_zlib(tmp_path, rng, n):
    buf = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    assert port.cpu_crc32(buf) == zlib.crc32(buf)
    with port.ChunkStore(str(tmp_path / "d")) as cs:
        assert cs.put_shard(1, 1, buf) == zlib.crc32(buf)
        assert cs.get_shard(1, 1) == (buf, zlib.crc32(buf))
        assert cs.list_shards(1) == [(1, n, zlib.crc32(buf))]


def test_bitrot_is_refused_and_counted(tmp_path):
    d = str(tmp_path / "disk")
    with port.ChunkStore(d) as cs:
        cs.put_shard(1, 1, b"A" * 1024)
    data_file = next(os.path.join(d, f) for f in os.listdir(d) if f.endswith(".data"))
    with open(data_file, "r+b") as f:
        f.seek(100)
        f.write(b"\x00")
    before = metrics.integrity_corruptions_detected.value(plane="blob", source="repair")
    with port.ChunkStore(d) as cs:
        with pytest.raises(port.CrcMismatchError):
            cs.get_shard(1, 1)
        with pytest.raises(port.CrcMismatchError):
            port.verified_get_shard(cs, 1, 1, node_addr="n0", disk_id=1, source="repair")
    assert metrics.integrity_corruptions_detected.value(plane="blob", source="repair") == \
        before + 1


def test_builds_are_atomic_and_a_failed_build_raises(monkeypatch, tmp_path):
    from cubefs_tpu_torch.ops import _build

    out = str(tmp_path / "ok" / "libchunkstore.so")
    paths, errors = [], []

    def build_once():
        try:
            paths.append(_build.build_host(out, port.SOURCES, "chunk store library"))
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=build_once) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120.0)
    assert not errors and paths == [out] * 3
    assert os.listdir(tmp_path / "ok") == ["libchunkstore.so"]  # no temporary left
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="chunk store library build failed"):
        _build.build_host(str(tmp_path / "bad" / "lib.so"), port.SOURCES,
                          "chunk store library")
    assert os.listdir(tmp_path / "bad") == []
