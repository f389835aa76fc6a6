"""The port's LRC and MSR codec families (plain PyTorch path on CPU)
against the JAX package: its encoders with engines ``numpy`` and
``tpu`` (jnp on the CPU), A's Pallas kernel in interpret mode,
``cubefs_tpu/ops/msr.py``'s rows and repair, the pinned
``ec16p20l2.bin`` fixture, the codemode policy and the rows cache.
Numpy-seeded inputs; tolerance: exact equality."""

import os
from dataclasses import astuple

import numpy as np
import pytest
import torch

from cubefs_tpu.codec import codemode as ref_cm
from cubefs_tpu.codec import encoder as ref_encoder
from cubefs_tpu.ops import msr as ref_msr
from cubefs_tpu.ops import pallas_gf
from cubefs_tpu.ops import rs_kernel as ref_rs
from cubefs_tpu_torch.codec import codemode as tcm
from cubefs_tpu_torch.codec import encoder as tencoder
from cubefs_tpu_torch.ops import msr, progcache, rs_kernel

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
LRC_MODES = ["EC16P20L2", "EC6P10L2", "EC6P3L3", "EC4P4L2", "EC6P6L9", "EC6P8L10"]
MSR_MODES = ["EC6P6MSR", "EC6P6MSROneAZ", "EC4P4MSR"]
# (k, total, d) of every registered MSR mode
MSR_GEOMETRIES = [(6, 12, 11), (6, 12, 10), (4, 8, 6)]


def _pair(mode: str, engine: str):
    ref = ref_encoder.new_encoder(ref_encoder.CodecConfig(ref_cm.CodeMode[mode], engine=engine))
    enc = tencoder.new_encoder(tencoder.CodecConfig(tcm.CodeMode[mode], device="cpu"))
    return ref, enc


def _payload(mode: str, size: int = 5000) -> bytes:
    return np.random.default_rng(len(mode) * 1000 + size).integers(
        0, 256, size, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("engine", ["numpy", "tpu"])
@pytest.mark.parametrize("mode", LRC_MODES + MSR_MODES)
def test_codec_family_matches_jax(mode, engine):
    ref, enc = _pair(mode, engine)
    assert type(enc).__name__ == type(ref).__name__
    payload = _payload(mode)
    assert enc.shard_size(len(payload)) == ref.shard_size(len(payload))
    ref_stripe = ref.encode(ref.split(payload))
    stripe = enc.encode(enc.split(payload))
    assert np.array_equal(stripe.numpy(), ref_stripe)
    assert enc.verify(stripe) and ref.verify(ref_stripe)
    golden = stripe.clone()
    t = enc.t
    # a data shard, a global parity and, for LRC, a local parity
    bad = [1, t.n + 1] + ([t.n + t.m] if t.l else [])
    stripe[bad] = 0
    assert not enc.verify(stripe)
    enc.reconstruct_data(stripe, bad)
    assert torch.equal(stripe[: t.n], golden[: t.n]) and not torch.equal(stripe, golden)
    crippled = golden.clone()
    crippled[bad] = 0
    ref_rec = ref.reconstruct(crippled.numpy().copy(), bad)
    assert enc.reconstruct(stripe, bad) is stripe
    assert torch.equal(stripe, golden)
    assert np.array_equal(stripe.numpy(), ref_rec)
    assert enc.join(stripe, len(payload)) == ref.join(ref_stripe, len(payload)) == payload
    for get in ("get_data_shards", "get_parity_shards", "get_local_shards"):
        assert np.array_equal(getattr(enc, get)(stripe).numpy(), getattr(ref, get)(ref_stripe))
    for az in range(t.az_count):
        assert np.array_equal(enc.get_shards_in_idc(stripe, az).numpy(),
                              ref.get_shards_in_idc(ref_stripe, az))


@pytest.mark.parametrize("mode", LRC_MODES + MSR_MODES)
def test_batched_stripes_and_async_encode_match_jax(mode):
    ref, enc = _pair(mode, "numpy")
    rng = np.random.default_rng(len(mode))
    s = enc.shard_size(3000)
    stripes = np.zeros((3, enc.t.total, s), dtype=np.uint8)
    stripes[:, : enc.t.n] = rng.integers(0, 256, (3, enc.t.n, s), dtype=np.uint8)
    want = ref.encode(stripes.copy())
    got = enc.encode(torch.from_numpy(stripes.copy()))
    assert np.array_equal(got.numpy(), want)
    batch = torch.from_numpy(stripes.copy())
    pending = enc.encode_async(batch)
    assert pending.wait() is batch
    assert np.array_equal(batch.numpy(), want) and enc.verify(batch)


@pytest.mark.parametrize("mode", LRC_MODES + MSR_MODES)
def test_encode_rows_match_pallas_interpret(mode):
    """The rows each encoder hands kernel A, applied by the reference's
    Pallas kernel in interpret mode, give the port's parity."""
    enc = tencoder.new_encoder(tencoder.CodecConfig(tcm.CodeMode[mode], device="cpu"))
    t = enc.t
    stripe = enc.encode(enc.split(_payload(mode, 4000)))
    if t.is_msr():
        coeff = ref_msr.encode_rows(t.n, t.n + t.m, t.d)
        data = rs_kernel.msr_subshards(stripe[: t.n], t.alpha).numpy()
        want = rs_kernel.msr_subshards(stripe[t.n:], t.alpha).numpy()
    else:
        coeff = enc._encode_rows
        data, want = stripe[: t.n].numpy(), stripe[t.n:].numpy()
    got = pallas_gf.gf_matrix_apply_pallas(coeff, data[None], tile=256, interpret=True)
    assert np.array_equal(np.asarray(got)[0], want)


@pytest.mark.parametrize("mode", LRC_MODES)
def test_lrc_local_stripe_repair_matches_jax(mode):
    ref, enc = _pair(mode, "numpy")
    t = enc.t
    ln, lm = enc._local_nm
    stripe = enc.encode(enc.split(_payload(mode)))
    for az in range(t.az_count):
        idx, _, _ = t.local_stripe_in_az(az)
        local = stripe[idx].clone()
        assert enc.verify(local) and ref.verify(local.numpy())
        bad = [0, ln] if lm > 1 else [ln - 1]
        crippled = local.clone()
        crippled[bad] = 0
        assert not enc.verify(crippled)
        ref_rec = ref.reconstruct(crippled.numpy().copy(), bad)
        assert torch.equal(enc.reconstruct(crippled, bad), local)
        assert np.array_equal(crippled.numpy(), ref_rec)
    # the composed encode rows are the reference's lrc_reconstruct_rows
    stripes, ln2, _ = t.all_local_stripes()
    want = ref_rs.lrc_reconstruct_rows(t.n, t.n + t.m, stripes, ln2, list(range(t.n)),
                                       list(range(t.n, t.total)))
    assert np.array_equal(enc._encode_rows, want)
    # and for a dark AZ: every shard of AZ 0, local parity included
    idx, _, _ = t.local_stripe_in_az(0)
    present = [i for i in range(t.n + t.m) if i not in idx]
    if len(present) >= t.n:
        args = (t.n, t.n + t.m, stripes, ln2, present, idx)
        assert np.array_equal(rs_kernel.lrc_reconstruct_rows(*args),
                              ref_rs.lrc_reconstruct_rows(*args))


@pytest.mark.parametrize("mode", LRC_MODES)
def test_lrc_reconstruct_data_on_global_rows(mode):
    ref, enc = _pair(mode, "numpy")
    t = enc.t
    stripe = enc.encode(enc.split(_payload(mode)))
    rows = stripe[: t.n + t.m].clone()
    bad = [0, t.n - 1]
    rows[bad] = 0
    ref_rows = rows.numpy().copy()
    assert enc.reconstruct_data(rows, bad) is rows
    ref.reconstruct_data(ref_rows, bad)
    assert torch.equal(rows, stripe[: t.n + t.m])
    assert np.array_equal(rows.numpy(), ref_rows)


def test_lrc_matches_pinned_fixture():
    n, m, l = 16, 20, 2
    with open(os.path.join(FIXTURES, "ec16p20l2.bin"), "rb") as f:
        golden = np.frombuffer(f.read(), dtype=np.uint8).reshape(n + m + l, 512)
    enc = tencoder.new_encoder(tencoder.CodecConfig(tcm.CodeMode.EC16P20L2, device="cpu"))
    stripe = torch.zeros((n + m + l, 512), dtype=torch.uint8)
    stripe[:n] = torch.from_numpy(golden[:n].copy())
    enc.encode(stripe)
    assert np.array_equal(stripe[n:n + m].numpy(), golden[n:n + m]), "global parity"
    assert np.array_equal(stripe[n + m:].numpy(), golden[n + m:]), "local parity"
    assert enc.verify(torch.from_numpy(golden.copy()))
    bad = [3, 20, 37]
    stripe[bad] = 0
    enc.reconstruct(stripe, bad)
    assert np.array_equal(stripe.numpy(), golden)


@pytest.mark.parametrize("k,total,d", MSR_GEOMETRIES)
def test_msr_rows_match_reference(k, total, d):
    assert astuple(msr.params(k, total, d)) == astuple(ref_msr.params(k, total, d))
    assert np.array_equal(rs_kernel.msr_encode_rows(k, total, d), ref_msr.encode_rows(k, total, d))
    present = tuple(range(1, k + 1))
    wanted = (0, total - 1)
    assert np.array_equal(rs_kernel.msr_reconstruct_rows(k, total, d, present, wanted),
                          ref_msr.reconstruct_rows(k, total, d, present, wanted))
    for failed in range(total):
        helpers = tuple(i for i in range(total) if i != failed)[:d]
        assert np.array_equal(rs_kernel.msr_helper_rows(k, total, d, failed),
                              ref_msr.helper_rows(k, total, d, failed))
        assert np.array_equal(rs_kernel.msr_repair_rows(k, total, d, failed, helpers),
                              ref_msr.repair_rows(k, total, d, failed, helpers))
        if d < total - 1:
            extra = next(i for i in range(total) if i != failed and i not in helpers)
            assert np.array_equal(rs_kernel.msr_verify_rows(k, total, d, failed, helpers, extra),
                                  ref_msr.verify_rows(k, total, d, failed, helpers, extra))


@pytest.mark.parametrize("k,total,d", MSR_GEOMETRIES)
def test_msr_repair_shard_every_slot_matches_jax(k, total, d):
    alpha = d - k + 1
    beta = 48
    rng = np.random.default_rng(k * 100 + d)
    data = rng.integers(0, 256, (2, k, alpha * beta), dtype=np.uint8)
    parity = rs_kernel.msr_encode_parity(torch.from_numpy(data), k, total, d)
    assert np.array_equal(parity.numpy(), np.asarray(ref_rs.msr_encode_parity(data, k, total, d)))
    shards = torch.cat([torch.from_numpy(data), parity], dim=1)  # (2, total, S)
    for failed in range(total):
        helpers = tuple(i for i in range(total) if i != failed)[:d]
        row = rs_kernel.msr_helper_rows(k, total, d, failed)
        # every node's helper symbol in one apply: (2, total, 1, beta)
        syms = rs_kernel.gf_matrix_apply(row, shards.view(2, total, alpha, beta))[:, :, 0]
        payloads = syms[:, list(helpers)]
        rebuilt = rs_kernel.msr_repair_shard(payloads, k, total, d, failed, helpers)
        assert torch.equal(rebuilt, shards[:, failed])
        if failed in (0, total - 1):  # the JAX path compiles once per matrix
            ref_rebuilt = ref_rs.msr_repair_shard(payloads.numpy(), k, total, d, failed, helpers)
            assert np.array_equal(rebuilt.numpy(), np.asarray(ref_rebuilt))
        if d < total - 1:  # an extra survivor's symbol checks the helpers'
            extra = next(i for i in range(total) if i != failed and i not in helpers)
            vrow = rs_kernel.msr_verify_rows(k, total, d, failed, helpers, extra)
            assert torch.equal(rs_kernel.gf_matrix_apply(vrow, payloads)[:, 0], syms[:, extra])
            payloads[1, 0, 5] ^= 0x5A
            pred = rs_kernel.gf_matrix_apply(vrow, payloads)[:, 0]
            assert torch.equal(pred[0], syms[0, extra])
            assert not torch.equal(pred[1], syms[1, extra])


def test_msr_subshards_are_views():
    stripes = torch.zeros((3, 12, 6 * 10), dtype=torch.uint8)
    data = rs_kernel.msr_subshards(stripes[:, :6], 6)
    parity = rs_kernel.msr_subshards(stripes[:, 6:], 6)
    assert data.shape == parity.shape == (3, 36, 10)
    assert data.data_ptr() == stripes.data_ptr()
    assert parity.data_ptr() == stripes[:, 6].data_ptr()
    parity.fill_(7)
    assert bool((stripes[:, 6:] == 7).all()) and bool((stripes[:, :6] == 0).all())
    assert rs_kernel.msr_join_subshards(parity, 6).data_ptr() == parity.data_ptr()
    with pytest.raises(ValueError, match="alpha"):
        rs_kernel.msr_subshards(stripes[:, :6, :59], 6)
    with pytest.raises(RuntimeError):  # a view cannot gather rows apart
        rs_kernel.msr_subshards(stripes[:, :6, :30], 6)


@pytest.mark.parametrize("mode", MSR_MODES)
def test_msr_encoder_shard_size_and_errors(mode):
    ref, enc = _pair(mode, "numpy")
    for blob in (1, 100, 64 << 10, (64 << 10) + 1, 24 << 20):
        assert enc.shard_size(blob) == ref.shard_size(blob)
        assert enc.shard_size(blob) % enc.t.alpha == 0
    with pytest.raises(ValueError, match="alpha"):
        enc.encode(torch.zeros((enc.t.total, enc.t.alpha * 10 + 1), dtype=torch.uint8))
    with pytest.raises(tencoder.ECError, match="unrecoverable"):
        enc.reconstruct(torch.zeros((enc.t.total, enc.t.alpha * 4), dtype=torch.uint8),
                        list(range(enc.t.m + 1)))


def test_lrc_typed_errors():
    enc = tencoder.new_encoder(tencoder.CodecConfig(tcm.CodeMode.EC4P4L2, device="cpu"))
    ln, lm = enc._local_nm
    with pytest.raises(tencoder.ECError, match="unrecoverable local stripe"):
        enc.reconstruct(torch.zeros((ln + lm, 64), dtype=torch.uint8), [0, 1])
    with pytest.raises(tencoder.ECError, match="torch.Tensor"):
        enc.reconstruct_data(np.zeros((10, 64), np.uint8), [0])
    with pytest.raises(tencoder.ECError, match="shards"):
        enc.encode(torch.zeros((9, 64), dtype=torch.uint8))
    verifying = tencoder.new_encoder(
        tencoder.CodecConfig(tcm.CodeMode.EC4P4L2, enable_verify=True, device="cpu"))
    assert verifying.verify(verifying.encode(verifying.split(b"y" * 300)))


def test_select_codemode_matches_reference():
    spec = [("EC6P6", 0, 1 << 20, 0.0, False), ("EC12P4", 0, 1 << 20, 0.5, True),
            ("EC16P20L2", (1 << 20) + 1, 1 << 40, 0.5, True)]
    ours = [tcm.Policy(*p) for p in spec]
    refs = [ref_cm.Policy(*p) for p in spec]
    for size in (0, 1 << 20, (1 << 20) + 1, 1 << 40):
        assert tcm.select_codemode(ours, size).name == ref_cm.select_codemode(refs, size).name
    assert tcm.select_codemode(ours, 10) == tcm.CodeMode.EC12P4
    with pytest.raises(ValueError, match="no enabled codemode"):
        tcm.select_codemode(ours, (1 << 40) + 1)
    assert tcm.Policy("EC6P3") == tcm.Policy("EC6P3", 0, 1 << 62, 0.0, True)


def test_msr_rows_ride_the_capped_cache():
    msr.repair_rows.cache_clear()
    helpers = tuple(range(1, 12))
    a = msr.repair_rows(6, 12, 11, 0, helpers)
    info = msr.repair_rows.cache_info()
    assert (info.hits, info.misses) == (0, 1)
    assert msr.repair_rows(6, 12, 11, 0, helpers) is a
    assert not a.flags.writeable
    info = msr.repair_rows.cache_info()
    assert (info.hits, info.misses) == (1, 1)
    assert info.maxsize == progcache.SHARED.capacity and info.currsize == len(progcache.SHARED)
    assert msr.repair_rows.cache_family == "msr"
    msr.repair_rows.cache_clear()
    assert msr.repair_rows.cache_info()[:2] == (0, 0)
    assert msr.repair_rows(6, 12, 11, 0, helpers) is not a


def test_program_cache_evicts_least_recently_used(monkeypatch):
    cache = progcache.ProgramCache(capacity=2)
    cache.put("f", 1, "a")
    cache.put("f", 2, "b")
    assert cache.get("f", 1) == (True, "a")  # 1 is now the most recent
    cache.put("g", 3, "c")
    assert cache.get("f", 2) == (False, None) and len(cache) == 2
    monkeypatch.setenv("CUBEFS_CODEC_PROGCACHE_CAP", "3")
    assert progcache.ProgramCache().capacity == 8  # at least 8
    monkeypatch.setenv("CUBEFS_CODEC_PROGCACHE_CAP", "100")
    assert progcache.ProgramCache().capacity == 100
    monkeypatch.setenv("CUBEFS_CODEC_PROGCACHE_CAP", "many")
    assert progcache.ProgramCache().capacity == 256
