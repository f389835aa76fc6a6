"""The port's GF(2^8) apply (plain PyTorch path on CPU) against the JAX
package: the jnp bit-matmul, the Pallas kernel in interpret mode, the
numpy golden and the pinned fixtures. Tolerance: exact equality (integer
math end to end)."""

import os

import numpy as np
import pytest
import torch

from cubefs_tpu.ops import bitlin as ref_bitlin
from cubefs_tpu.ops import gf256 as ref_gf256
from cubefs_tpu.ops import pallas_gf
from cubefs_tpu.ops import rs_kernel as ref_rs
from cubefs_tpu_torch import convert
from cubefs_tpu_torch.codec import codemode as tcm
from cubefs_tpu_torch.codec.encoder import CodecConfig, new_encoder
from cubefs_tpu_torch.ops import bitlin, gf256, rs_kernel

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


@pytest.mark.parametrize("n,m,s", [(6, 3, 512), (12, 4, 512), (12, 4, 777), (6, 3, 4096)])
def test_encode_parity_matches_jax_and_pallas(n, m, s):
    rng = np.random.default_rng(n * 100 + s)
    data = rng.integers(0, 256, (2, n, s), dtype=np.uint8)
    got = rs_kernel.encode_parity(torch.from_numpy(data), m).numpy()
    assert np.array_equal(got, np.asarray(ref_rs.encode_parity(data, m)))
    pm = ref_gf256.parity_matrix(n, m)
    pallas = np.asarray(pallas_gf.gf_matrix_apply_pallas(pm, data, tile=256, interpret=True))
    assert np.array_equal(got, pallas)


def test_square_36x36_matrix_matches_jax():
    rng = np.random.default_rng(36)
    coeff = rng.integers(0, 256, (36, 36), dtype=np.uint8)
    shards = rng.integers(0, 256, (36, 300), dtype=np.uint8)
    got = rs_kernel.gf_matrix_apply(coeff, torch.from_numpy(shards)).numpy()
    assert np.array_equal(got, np.asarray(ref_rs.gf_matrix_apply(coeff, shards)))
    assert np.array_equal(got, ref_gf256.gf_matmul(coeff, shards))


@pytest.mark.parametrize("bad", [[1, 7], [0, 13, 15], [14]])
def test_batched_reconstruct_matches_jax(bad):
    n, total = 12, 16
    rng = np.random.default_rng(len(bad))
    enc = ref_gf256.encode_matrix(n, total)
    shards = np.stack([ref_gf256.gf_matmul(enc, d)
                       for d in rng.integers(0, 256, (3, n, 256), dtype=np.uint8)])
    present = [i for i in range(total) if i not in bad]
    rows = rs_kernel.reconstruct_rows(n, total, present, bad)
    assert np.array_equal(rows, ref_rs.reconstruct_rows(n, total, present, bad))
    got = rs_kernel.reconstruct_stripes(
        torch.from_numpy(shards[:, present[:n]].copy()), present, bad, n, total).numpy()
    assert np.array_equal(got, shards[:, bad])


def test_strided_survivor_view_is_applied_in_place():
    """repair_step hands the first n_data rows of a (B, P, S) batch as a
    view; the apply must read the view, not the whole batch."""
    rng = np.random.default_rng(5)
    batch = torch.from_numpy(rng.integers(0, 256, (3, 9, 64), dtype=np.uint8))
    pm = gf256.parity_matrix(6, 3)
    got = rs_kernel.gf_matrix_apply(pm, batch[:, :6, :])
    want = rs_kernel.gf_matrix_apply(pm, batch[:, :6, :].contiguous())
    assert torch.equal(got, want)


@pytest.mark.parametrize("name,mode,n,m", [
    ("rs6p3.bin", tcm.CodeMode.EC6P3, 6, 3),
    ("rs12p4.bin", tcm.CodeMode.EC12P4, 12, 4),
])
def test_parity_matches_pinned_fixture(name, mode, n, m):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        golden = np.frombuffer(f.read(), dtype=np.uint8).reshape(n + m, 512)
    enc = new_encoder(CodecConfig(mode, device="cpu"))
    stripe = torch.zeros((n + m, 512), dtype=torch.uint8)
    stripe[:n] = torch.from_numpy(golden[:n].copy())
    assert np.array_equal(enc.encode(stripe).numpy(), golden)
    assert enc.verify(torch.from_numpy(golden.copy()))


@pytest.mark.parametrize("n,m", [(6, 3), (12, 4), (3, 3), (24, 8)])
def test_host_matrices_match_reference(n, m):
    assert np.array_equal(gf256.encode_matrix(n, n + m), ref_gf256.encode_matrix(n, n + m))
    present = list(range(1, n + 1))
    assert np.array_equal(gf256.decode_matrix(n, n + m, present),
                          ref_gf256.decode_matrix(n, n + m, present))
    assert np.array_equal(bitlin.gf_matrix_to_bits(gf256.parity_matrix(n, m)),
                          ref_bitlin.gf_matrix_to_bits(ref_gf256.parity_matrix(n, m)))


@pytest.mark.parametrize("r,c", [(4, 12), (2, 12), (36, 36)])
def test_convert_bit_matrices_match_reference(r, c):
    from cubefs_tpu.ops import crc32_kernel as ref_crc

    rng = np.random.default_rng(r * c)
    coeff = rng.integers(0, 256, (r, c), dtype=np.uint8)
    w, wt, shifts = convert.bit_matrices(coeff, block_len=8192, chunk_len=1024)
    assert np.array_equal(w, ref_bitlin.w_to_bitmajor(ref_bitlin.gf_matrix_to_bits(coeff), r, c))
    ref_w = ref_crc.chunk_matrix(1024).astype(np.int8)
    ref_pm = np.zeros_like(ref_w)
    ref_pm[:, ref_bitlin.bitmajor_perm(1024)] = ref_w
    assert np.array_equal(wt, ref_pm.T)
    assert np.array_equal(shifts, np.stack([ref_crc.zeros_matrix((7 - k) * 1024)
                                            for k in range(8)]))


def test_unpack_pack_are_plane_major_inverses():
    rng = np.random.default_rng(9)
    x = rng.integers(0, 256, (2, 5, 33), dtype=np.uint8)
    bits = rs_kernel.unpack_bits(torch.from_numpy(x)).numpy()
    byte_major = ref_bitlin.unpack_bits_np(x)  # row b*8+k
    perm = ref_bitlin.bitmajor_perm(5)
    plane_major = np.zeros_like(byte_major)
    plane_major[:, perm] = byte_major
    assert np.array_equal(bits, plane_major)
    assert np.array_equal(rs_kernel.pack_bits(torch.from_numpy(bits)).numpy(), x)
