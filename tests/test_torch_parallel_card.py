"""The sharded codec step on the card: a 2-rank gloo world whose ranks
share one CUDA device, each running kernels A and B on its own block.
Every block of every result is held exactly (in the rank) against the
single-rank path, the lost shards and zlib. Skips without a card."""

import pytest
import torch

from cubefs_tpu_torch.parallel import dryrun, launch

RUNS = [
    {"name": name, "dims": dims, "seed": i, "b": 4, "n": 12, "m": 4, "s": s, "bad": bad}
    for i, (name, dims, s, bad) in enumerate([
        ("tp", {"dp": 1, "tp": 2, "sp": 1}, 4096, [1, 7]),
        ("sp_odd_blocks", {"dp": 1, "tp": 1, "sp": 2}, 2 * 4099, [2, 13]),
        ("dp", {"dp": 2, "tp": 1, "sp": 1}, 4096 + 5, [0, 15]),
    ])
]


@pytest.fixture(scope="module")
def card_world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return launch.launch(dryrun.multichip, 2, backend="gloo", device="cuda:0", args=(RUNS,),
                         deadline=120.0, timeout=60.0)


@pytest.mark.cuda
@pytest.mark.parametrize("i", range(len(RUNS)), ids=[r["name"] for r in RUNS])
def test_sharded_step_on_card_equals_single_rank(card_world, i):
    for rank in card_world:
        summary = rank.result[i]
        assert all(summary["checks"].values()), summary["checks"]
        assert summary["launches"]["gf_apply"] > 0 and summary["launches"]["crc32_blocks"] > 0
