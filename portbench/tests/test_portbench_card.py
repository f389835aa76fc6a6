"""The put cells' runs on the card: built, correct, and their metrics there."""

from __future__ import annotations

import pytest

from portbench.run import run_cell


@pytest.mark.cuda
def test_put_encode_on_the_card(cuda_device):
    res = run_cell("ec12p4.put_encode", 2**31 + 5, 2.0, False, device=cuda_device)
    assert res["line"]["correct"], res["checks"]
    # every call stages its whole (B, 16, S) stack in and its 4 parity rows out
    assert res["line"]["metrics"]["encode_copy_amp"]["value"] >= 20 / 12
    res = run_cell("ec16p20l2.put_encode", 2**31 + 6, 2.0, True, device=cuda_device)
    assert res["line"]["correct"], res["checks"]
    assert res["line"]["device"]["busy_s"] > 0
    assert 0 < res["line"]["metrics"]["codec_roofline.encode"]["value"] <= 100
