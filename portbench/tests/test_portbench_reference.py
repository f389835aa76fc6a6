"""The reference against the program's CPU output, on both codemodes."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.reference import gf256
from portbench.reference.codes import Code

MODES = {"EC12P4": {"n": 12, "m": 4}, "EC16P20L2": {"n": 16, "m": 20, "l": 2, "az_count": 2}}


def test_the_field_and_the_systematic_matrix():
    t = gf256.mul_table()
    assert all(gf256.mul(a, 1) == a for a in range(256))
    a = np.random.default_rng(0).integers(0, 256, (6, 6), dtype=np.uint8)
    a[np.arange(6), np.arange(6)] |= 1  # keep it likely invertible
    assert np.array_equal(gf256.matmul(a, gf256.inverse(a)), np.eye(6, dtype=np.uint8))
    enc = gf256.rs_matrix(12, 16)
    assert np.array_equal(enc[:12], np.eye(12, dtype=np.uint8))
    assert t[2, 128] == 0x1D  # x^8 = x^4 + x^3 + x^2 + 1


@pytest.mark.parametrize("mode", MODES)
def test_the_reference_encodes_as_the_program_does(mode):
    from cubefs_tpu_torch.blob import codecio
    from cubefs_tpu_torch.codec import codemode as cm

    code = Code.of(MODES[mode])
    rng = np.random.default_rng(5)
    st = np.zeros((3, code.total, 4099), dtype=np.uint8)
    st[:, :code.n] = rng.integers(0, 256, (3, code.n, 4099), dtype=np.uint8)
    codecio.encoder(cm.CodeMode[mode], "cpu", "cuda").encode_async(st).wait()
    ref = code.parity(torch.from_numpy(st[:, :code.n].copy())).numpy()
    assert np.array_equal(ref, st[:, code.n:])
    assert not np.array_equal(Code.of(MODES[mode], xor=True).parity(
        torch.from_numpy(st[:, :code.n].copy())).numpy(), ref)


@pytest.mark.parametrize("mode", MODES)
def test_the_reference_rebuilds_as_the_program_does(mode):
    from cubefs_tpu_torch.blob import codecio
    from cubefs_tpu_torch.codec import codemode as cm

    code = Code.of(MODES[mode])
    enc = codecio.encoder(cm.CodeMode[mode], "cpu", "cuda")
    rng = np.random.default_rng(6)
    st = np.zeros((code.total, 2051), dtype=np.uint8)
    st[:code.n] = rng.integers(0, 256, (code.n, 2051), dtype=np.uint8)
    enc.encode_async(st).wait()
    glob = code.n + code.m
    lost = sorted(rng.choice(glob, code.m, replace=False).tolist())
    solve = [i for i in range(glob) if i not in lost][:code.n]
    ref = code.rebuild(torch.from_numpy(st[None, solve].copy()), solve, lost)[0].numpy()
    assert np.array_equal(ref, st[lost])
    broken = st[:glob].copy()
    broken[lost] = 0
    enc.reconstruct_data(broken, lost)
    data_lost = [i for i in lost if i < code.n]
    assert np.array_equal(broken[data_lost], st[data_lost])
