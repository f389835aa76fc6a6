"""Small sizes of every cell, for the CPU: the same drivers and checks at
shards of a few KiB, the plain PyTorch versions of the kernels."""

from __future__ import annotations

import pytest
import torch

CELLS = ("ec12p4.put_encode", "ec16p20l2.put_encode", "ec12p4.repair", "ec12p4.get_degraded")


def small(cell: str) -> dict:
    """``run_cell`` keyword arguments that shrink ``cell``."""
    config = {"ec12p4": {"blob_size": 12 * 4096},
              "ec16p20l2": {"blob_size": 16 * 2048}}[cell.split(".")[0]]
    if cell.endswith("repair"):
        params = {"clients": 2, "pool": 16, "batch_stripes": 8, "sample_every": 2}
    else:
        params = {"clients": 3, "unit": config["blob_size"] // 8, "sample_every": 2}
    return {"config": config, "params": params}


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when a test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
