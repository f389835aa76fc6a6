"""The port's repair step and Encoder (plain PyTorch path on CPU) against
the JAX package's ``models.repair.repair_step`` and ``codec.encoder``
(engines ``numpy`` and ``tpu``), on the same numpy-seeded stripes.
Tolerance: exact equality."""

import numpy as np
import pytest
import torch

from cubefs_tpu.codec import codemode as ref_cm
from cubefs_tpu.codec import encoder as ref_encoder
from cubefs_tpu.models import repair as ref_repair
from cubefs_tpu.ops import gf256 as ref_gf256
from cubefs_tpu_torch import convert
from cubefs_tpu_torch.codec import codemode as tcm
from cubefs_tpu_torch.codec import encoder as tencoder
from cubefs_tpu_torch.codec import engine as engine_mod
from cubefs_tpu_torch.models import repair


def _stripes(n: int, m: int, b: int, s: int, seed: int) -> np.ndarray:
    enc = ref_gf256.encode_matrix(n, n + m)
    data = np.random.default_rng(seed).integers(0, 256, (b, n, s), dtype=np.uint8)
    return np.stack([ref_gf256.gf_matmul(enc, d) for d in data])


@pytest.mark.parametrize("n,m,bad,s", [
    (12, 4, [1, 7], 512),
    (12, 4, [2, 13], 2048),
    (6, 3, [0, 4, 8], 300),   # no extra survivors: ok is vacuously true
    (6, 3, [5], 1000),
])
def test_repair_step_matches_jax(n, m, bad, s):
    shards = _stripes(n, m, 3, s, seed=s)
    surviving, plan = convert.from_reference(shards, n, m, bad, device="cpu")
    ref_plan = ref_repair.make_plan(n, m, bad)
    assert (plan.present, plan.wanted) == (ref_plan.present, ref_plan.wanted)
    rec, crcs, ok = repair.repair_step(plan, surviving)
    ref_rec, ref_crcs, ref_ok = map(
        np.asarray, ref_repair.repair_step(ref_plan, shards[:, list(ref_plan.present)]))
    assert np.array_equal(rec.numpy(), ref_rec)
    assert np.array_equal(rec.numpy(), shards[:, list(plan.wanted)])
    assert np.array_equal(crcs.numpy(), ref_crcs.astype(np.int64))
    assert np.array_equal(ok.numpy(), ref_ok)
    assert ok.all()


@pytest.mark.parametrize("row", [0, 6])  # in the solving set / an extra survivor
def test_repair_step_detects_corrupt_survivor(row):
    n, m = 6, 3
    shards = _stripes(n, m, 2, 64, seed=72)
    surviving, plan = convert.from_reference(shards, n, m, [0], device="cpu")
    ref_surv = shards[:, list(plan.present)].copy()
    surviving[1, row, 0] ^= 0x5A
    ref_surv[1, row, 0] ^= 0x5A
    _, _, ok = repair.repair_step(plan, surviving)
    _, _, ref_ok = ref_repair.repair_step(ref_repair.make_plan(n, m, [0]), ref_surv)
    assert ok.tolist() == [True, False] == np.asarray(ref_ok).tolist()


@pytest.mark.parametrize("mode", ["EC6P3", "EC12P4"])
@pytest.mark.parametrize("engine", ["numpy", "tpu"])
def test_encoder_matches_jax(mode, engine):
    rng = np.random.default_rng(len(mode))
    payload = rng.integers(0, 256, 12345, dtype=np.uint8).tobytes()
    ref = ref_encoder.new_encoder(ref_encoder.CodecConfig(ref_cm.CodeMode[mode], engine=engine))
    enc = tencoder.new_encoder(tencoder.CodecConfig(tcm.CodeMode[mode], device="cpu"))
    ref_stripe = ref.encode(ref.split(payload))
    stripe = enc.encode(enc.split(payload))
    assert np.array_equal(stripe.numpy(), ref_stripe)
    assert enc.verify(stripe)
    n = enc.t.n
    bad = [1, n + 1]
    golden = stripe.clone()
    stripe[bad] = 0
    enc.reconstruct_data(stripe, bad)
    assert torch.equal(stripe[:n], golden[:n]) and not torch.equal(stripe, golden)
    enc.reconstruct(stripe, bad)
    assert torch.equal(stripe, golden)
    assert enc.join(stripe, len(payload)) == ref.join(ref_stripe, len(payload)) == payload
    assert np.array_equal(enc.get_parity_shards(stripe).numpy(), ref.get_parity_shards(ref_stripe))
    assert np.array_equal(enc.get_data_shards(stripe).numpy(), ref.get_data_shards(ref_stripe))
    assert enc.get_local_shards(stripe).shape[-2] == 0
    assert np.array_equal(enc.get_shards_in_idc(stripe, 0).numpy(),
                          ref.get_shards_in_idc(ref_stripe, 0))
    assert enc.shard_size(len(payload)) == ref.shard_size(len(payload))


def test_encoder_batched_stripes():
    enc = tencoder.new_encoder(tencoder.CodecConfig(tcm.CodeMode.EC6P3, device="cpu"))
    rng = np.random.default_rng(4)
    batch = torch.zeros((3, 9, 128), dtype=torch.uint8)
    batch[:, :6] = torch.from_numpy(rng.integers(0, 256, (3, 6, 128), dtype=np.uint8))
    enc.encode(batch)
    golden = batch.clone()
    batch[:, [2, 7]] = 0
    enc.reconstruct(batch, [2, 7])
    assert torch.equal(batch, golden)


def test_typed_errors():
    enc = tencoder.new_encoder(tencoder.CodecConfig(tcm.CodeMode.EC6P3, device="cpu"))
    with pytest.raises(tencoder.ShortDataError):
        enc.split(b"")
    with pytest.raises(tencoder.ECError, match="shards"):
        enc.encode(torch.zeros((8, 16), dtype=torch.uint8))
    with pytest.raises(tencoder.ECError, match="uint8"):
        enc.encode(torch.zeros((9, 16), dtype=torch.int32))
    with pytest.raises(tencoder.ECError, match="torch.Tensor"):
        enc.encode(np.zeros((9, 16), dtype=np.uint8))
    with pytest.raises(tencoder.ECError, match="unrecoverable"):
        enc.reconstruct(torch.zeros((9, 16), dtype=torch.uint8), [0, 1, 2, 3])
    with pytest.raises(tencoder.ECError, match="exceeds"):
        enc.join(torch.zeros((9, 16), dtype=torch.uint8), 1000)
    with pytest.raises(tencoder.ECError, match="batch"):
        enc.join(torch.zeros((2, 9, 16), dtype=torch.uint8), 10)
    with pytest.raises(KeyError):
        engine_mod.get_engine("tpu", device="cpu")
    verifying = tencoder.new_encoder(
        tencoder.CodecConfig(tcm.CodeMode.EC6P3, enable_verify=True, device="cpu"))
    assert verifying.encode(verifying.split(b"x" * 100)).shape == (9, 2048)


def test_codemode_tactics_match_reference():
    from dataclasses import astuple

    assert [m.name for m in tcm.CodeMode] == [m.name for m in ref_cm.CodeMode]
    for mode in tcm.CodeMode:
        ours, ref = tcm.tactic(mode.name), ref_cm.tactic(mode.name)
        assert int(mode) == int(ref_cm.CodeMode[mode.name])
        assert astuple(ours) == astuple(ref)
        assert ours.ec_layout_by_az() == ref.ec_layout_by_az()
        assert (ours.total, ours.alpha) == (ref.total, ref.alpha)
