"""Phase ``operators``' kernel-A steps on the card, at a small size:

- ``bench_codec.run_ab`` and ``run_repair_ab`` on the card: batched and
  unbatched outputs bit-identical, equal to the host tables and to the
  same legs on ``device="cpu"`` (the plain version of A), with A launched;
- ``tier_ab``'s tiered and door-off legs on the card: the ratios and the
  FSM digest of the CPU legs, A launched once a tier PUT at least;
- the phase itself (``chip_smoke.operators_phase``) at a small size: every
  check true but the EC12P4 codemode, which needs the phase's 64 MiB
  objects.

Every test needs a CUDA device (``cuda`` marker; the fixture skips
without one). The file imports no jax:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_operators_card.py

Tolerance: exact equality.
"""

import os
import sys

import numpy as np
import pytest

from cubefs_tpu_torch.ops import _build
from cubefs_tpu_torch.tool import bench_codec, tier_ab
from test_torch_fs_card import cuda_device, quiet_qos  # noqa: F401  (fixtures)

MIB = 1 << 20


@pytest.mark.cuda
def test_run_ab_on_the_card_equals_the_cpu_leg(cuda_device):
    a0 = _build.LAUNCHES["gf_apply"]
    card = bench_codec.run_ab(submitters=8, iters=10, rounds=1, device=cuda_device)
    assert card["bit_identical"] and card["equals_plain"]
    assert _build.LAUNCHES["gf_apply"] > a0
    for batched in (True, False):
        on = bench_codec._run_leg(batched, 6, 4, 6, 3, 4099, "cuda", 7, 0.25, 2,
                                  device=cuda_device)["outputs"]
        off = bench_codec._run_leg(batched, 6, 4, 6, 3, 4099, "cuda", 7, 0.25, 2,
                                   device="cpu")["outputs"]
        assert all(np.array_equal(on[t], off[t]) for t in off)


@pytest.mark.cuda
def test_run_repair_ab_on_the_card(cuda_device):
    a0 = _build.LAUNCHES["gf_apply"]
    card = bench_codec.run_repair_ab(stripes=8, rounds=1, device=cuda_device)
    cpu = bench_codec.run_repair_ab(stripes=8, rounds=1, device="cpu")
    assert card["bit_identical"] and cpu["bit_identical"]
    assert card["bytes_pulled_per_stripe"] == cpu["bytes_pulled_per_stripe"]
    assert _build.LAUNCHES["gf_apply"] > a0


@pytest.mark.cuda
def test_tier_ab_legs_on_the_card(cuda_device, quiet_qos, tmp_path, monkeypatch):
    monkeypatch.setattr(tier_ab, "FILES", 3)
    a0 = _build.LAUNCHES["gf_apply"]
    card = tier_ab.leg_tiered(str(tmp_path / "card"), 13, cuda_device)
    assert _build.LAUNCHES["gf_apply"] - a0 >= 3
    cpu = tier_ab.leg_tiered(str(tmp_path / "cpu"), 13, "cpu")
    assert card["transitioned"] == cpu["transitioned"] == 3
    assert card["stored_bytes_blob"] == cpu["stored_bytes_blob"]
    d_card = tier_ab.leg_digests(str(tmp_path / "dcard"), 13, cuda_device)
    d_cpu = tier_ab.leg_digests(str(tmp_path / "dcpu"), 13, "cpu")
    assert d_card["identical"] and d_card["control_digest"] == d_cpu["control_digest"]


@pytest.mark.cuda
def test_operators_phase_at_a_small_size(cuda_device, tmp_path, monkeypatch):
    from cubefs_tpu_torch.codec import engine

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke

    monkeypatch.setattr(engine, "_policy_path", lambda: str(tmp_path / "CROSSOVER.json"))
    rec = chip_smoke.operators_phase(cuda_device, "card", files=3, file_size=MIB + 5,
                                     objects=2, obj_size=4 * MIB + 3, bench_count=4,
                                     bench_size=256 << 10, bench_conc=2, submitters=4,
                                     iters=5, repair_stripes=4, tier_files=2,
                                     blob_size=MIB // 4 + 7)
    failed = [k for k, v in rec["checks"].items() if not v and k != "blob_codemode_ec12p4"]
    assert not failed, failed
    assert all(v > 0 for v in rec["launches"].values()), rec["launches"]
