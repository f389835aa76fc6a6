"""The LRC and MSR codec families on the card: the composed LRC encode
is one launch of kernel A, the MSR encode writes its parity sub-shards
into the stripe itself (no copy), and every family's results equal the
plain PyTorch path's on the same inputs.

Every test needs a CUDA device (``cuda`` marker; the fixture skips
without one). The file imports no jax:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_codec_card.py

Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

from cubefs_tpu_torch.codec import codemode as tcm
from cubefs_tpu_torch.codec.encoder import CodecConfig, new_encoder
from cubefs_tpu_torch.ops import _build, rs_kernel


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _stripes(mode: str, b: int, payload: int, device):
    enc = new_encoder(CodecConfig(tcm.CodeMode[mode], device=device))
    s = enc.shard_size(payload)
    rng = np.random.default_rng(payload + b)
    st = torch.zeros((b, enc.t.total, s), dtype=torch.uint8)
    st[:, : enc.t.n] = torch.from_numpy(rng.integers(0, 256, (b, enc.t.n, s), dtype=np.uint8))
    return enc, st.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["EC16P20L2", "EC6P10L2", "EC6P3L3", "EC4P4L2", "EC6P6L9",
                                  "EC6P8L10", "EC6P6MSR", "EC6P6MSROneAZ", "EC4P4MSR"])
def test_family_encode_is_one_launch_in_place(cuda_device, mode):
    enc, st = _stripes(mode, 2, 6 * 5000 + 7, cuda_device)
    cpu_enc = new_encoder(CodecConfig(tcm.CodeMode[mode], device="cpu"))
    want = cpu_enc.encode(st.cpu())
    data = st[:, : enc.t.n].clone()
    ptr = st.data_ptr()
    enc.verify(st)  # puts the rows' product table on the card before the count
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda_device)
    base = torch.cuda.memory_allocated(cuda_device)
    before = _build.LAUNCHES["gf_apply"]
    assert enc.encode(st) is st
    assert _build.LAUNCHES["gf_apply"] == before + 1
    # written through views of the stripe: no copy of the data or parity
    assert torch.cuda.max_memory_allocated(cuda_device) - base < data.numel() // 2
    assert st.data_ptr() == ptr and torch.equal(st[:, : enc.t.n], data)
    assert torch.equal(st.cpu(), want)
    assert enc.verify(st)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["EC16P20L2", "EC6P8L10"])
def test_lrc_repairs_on_card(cuda_device, mode):
    enc, st = _stripes(mode, 2, 16 * 4099, cuda_device)
    enc.encode(st)
    golden = st.clone()
    t = enc.t
    bad = [0, 5, t.n + t.m]  # two data shards and a local parity
    st[:, bad] = 0
    enc.reconstruct(st, bad)
    assert torch.equal(st, golden)
    ln, lm = enc._local_nm
    idx, _, _ = t.local_stripe_in_az(1)
    local = golden[:, idx].clone()
    local[:, [2]] = 0
    assert torch.equal(enc.reconstruct(local, [2]), golden[:, idx]) and enc.verify(local)
    rows = golden[:, : t.n + t.m].clone()
    rows[:, [1, 3]] = 0
    assert torch.equal(enc.reconstruct_data(rows, [1, 3]), golden[:, : t.n + t.m])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["EC6P6MSR", "EC6P6MSROneAZ"])
def test_msr_reconstruct_and_repair_shard_on_card(cuda_device, mode):
    enc, st = _stripes(mode, 2, 6 * 6000 + 5, cuda_device)
    enc.encode(st)
    golden = st.clone()
    t = enc.t
    bad = [0, 2, 7, 11, 4, 9][: t.m]
    st[:, bad] = 0
    enc.reconstruct(st, bad)
    assert torch.equal(st, golden)
    beta = st.shape[-1] // t.alpha
    for failed in (0, t.n, t.total - 1):
        helpers = tuple(i for i in range(t.total) if i != failed)[: t.d]
        row = rs_kernel.msr_helper_rows(t.n, t.total, t.d, failed)
        syms = rs_kernel.gf_matrix_apply(row, golden.view(2, t.total, t.alpha, beta))[:, :, 0]
        assert torch.equal(syms.cpu(), rs_kernel.gf_matrix_apply(
            row, golden.cpu().view(2, t.total, t.alpha, beta))[:, :, 0])
        payloads = syms[:, list(helpers)].contiguous()
        rebuilt = rs_kernel.msr_repair_shard(payloads, t.n, t.total, t.d, failed, helpers)
        assert torch.equal(rebuilt, golden[:, failed])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["encode_EC12P4", "recover_2x12", "lrc_22x16", "msr_repair_6x11",
                                  "empty_s"])
def test_five_legs_agree_on_card(cuda_device, case):
    """The engine layer's legs (``cuda`` on the card through hostio, and
    the host legs ``cpp``, ``cpp-xor``, ``numpy-xor``, ``numpy``) give the
    same bytes, ragged S and batches included; ``auto`` beyond its table
    is one launch of A."""
    from cubefs_tpu_torch.codec import engine as E
    from cubefs_tpu_torch.ops import gf256, msr

    coeff, c = {
        "encode_EC12P4": (gf256.parity_matrix(12, 4), 12),
        "recover_2x12": (rs_kernel.reconstruct_rows(12, 16, [0, *range(2, 7), *range(8, 16)],
                                                    [1, 7]), 12),
        "lrc_22x16": (new_encoder(CodecConfig(tcm.CodeMode.EC16P20L2, engine="numpy"))
                      ._encode_rows, 16),
        "msr_repair_6x11": (msr.repair_rows(6, 12, 11, 0, tuple(range(1, 12))), 11),
        "empty_s": (gf256.parity_matrix(6, 3), 6),
    }[case]
    s = 0 if case == "empty_s" else 699_051
    x = np.random.default_rng(len(case)).integers(0, 256, (2, c, s), dtype=np.uint8)
    outs = {leg: E.host_call(leg, "matrix_apply", cuda_device, coeff, x)
            for leg in ("cuda", "cpp", "cpp-xor", "numpy-xor", "numpy")}
    for leg, y in outs.items():
        assert y.shape == (2, coeff.shape[0], s) and np.array_equal(y, outs["numpy"]), leg
    auto = E.AutoEngine(cuda_device)
    before = _build.LAUNCHES["gf_apply"]
    assert np.array_equal(auto.matrix_apply(coeff, np.tile(x, (16, 1, 1)))[:2], outs["numpy"])
    if s:
        assert E.last_dispatch["served"] == "cuda"  # 16 * 2 stripes beyond any table's 16 MiB
        assert _build.LAUNCHES["gf_apply"] == before + 1
