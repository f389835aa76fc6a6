"""The blob scrub on the card: a small in-process cluster whose scheduler
verifies every volume with kernel A (``Scheduler.make_scrubber``, engine
``cuda``) gives the verdicts, the culprits and the repair tasks that the
same cluster gives on ``device="cpu"`` (the plain versions), and the
worker's A-built repairs write the same bytes.

Every test needs a CUDA device (``cuda`` marker; the fixture skips
without one). The file imports no jax:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_integrity_card.py

Tolerance: exact equality.
"""

import numpy as np
import pytest

from cubefs_tpu_torch.codec import codemode as tcm
from cubefs_tpu_torch.ops import _build
from cubefs_tpu_torch.utils import faultinject as fi
from cubefs_tpu_torch.utils import qos
from cubefs_tpu_torch.utils.retry import FakeClock
from test_torch_blob_card import BLOB, Cluster, cuda_device, static_split  # noqa: F401


@pytest.fixture
def quiet_qos(monkeypatch):
    """The QoS gate's burn signal pinned quiet: a slow call elsewhere in
    the process would brown the gate out and shed the scrub."""
    class Quiet:
        def snapshot(self):
            return {}

    monkeypatch.setattr(qos.DEFAULT, "_tracker", Quiet())
    monkeypatch.setattr(qos.DEFAULT, "_levels", {})
    monkeypatch.setattr(qos.DEFAULT, "_last_refresh", float("-inf"))


def _faults(c, locs):
    """A planted rot in a data unit and one in a parity unit (reads
    refuse them), and a data shard rewritten with wrong bytes under a
    valid CRC (only the parity recompute sees it), each in a volume of
    its own: a repair reads its volume's other units as survivors."""
    plan = fi.FaultPlan(seed=31)
    fi.install(plan)
    for loc, idx in ((locs[0], 3), (locs[1], 13)):
        sl = loc.slices[0]
        u = c.cm.get_volume(sl.vid).units[idx]
        plan.plant_rot(u.node_addr, u.disk_id, f"c{u.chunk_id}:b{sl.min_bid}", kind="bitflip")
    sl = locs[2].slices[-1]
    u = c.cm.get_volume(sl.vid).units[5]
    bid = sl.min_bid + sl.count - 1
    good = c.node(u).get_shard(u.disk_id, u.chunk_id, bid)[0]
    c.node(u).rpc_put_shard({"disk_id": u.disk_id, "chunk_id": u.chunk_id, "bid": bid},
                            bytes(b ^ 0x3C for b in good))


def _scrub(c) -> dict:
    s = c.sched.make_scrubber(clock=FakeClock())
    verdicts = []
    unit = s.scrub_unit
    s.scrub_unit = lambda vid: verdicts.append((vid, unit(vid))) or verdicts[-1][1]
    result = s.run_full_pass()
    tasks = sorted((t["vid"], t["unit_index"], t["reason"]) for t in c.sched.tasks.values())
    return {"result": result, "verdicts": verdicts, "tasks": tasks}


@pytest.mark.cuda
def test_scrub_on_card_equals_the_plain_cluster(cuda_device, static_split, quiet_qos, tmp_path):
    card = Cluster(tmp_path / "card", None, "cuda")
    plain = Cluster(tmp_path / "cpu", "cpu", "cuda")
    try:
        rng = np.random.default_rng(9)
        data = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                for n in (5 * BLOB + 3, 4 * BLOB + 1, 3 * BLOB + 7)]
        locs = [card.access.put(d, codemode=tcm.CodeMode.EC12P4) for d in data]
        assert [plain.access.put(d, codemode=tcm.CodeMode.EC12P4).to_dict()
                for d in data] == [x.to_dict() for x in locs]
        assert len({x.slices[0].vid for x in locs}) == 3  # each PUT allocates a volume
        before = card.shards()
        out = {}
        for tag, c in (("card", card), ("cpu", plain)):
            _faults(c, locs)
            a0 = _build.LAUNCHES["gf_apply"]
            out[tag] = _scrub(c)
            out[tag]["a_launches"] = _build.LAUNCHES["gf_apply"] - a0
            while c.worker.run_once():
                pass
            assert c.worker.failed == 0
            out[tag]["second"] = _scrub(c)["result"]
            fi.uninstall()
        assert out["card"]["a_launches"] > 0 and out["cpu"]["a_launches"] == 0
        for tag in ("card", "cpu"):
            del out[tag]["a_launches"]
        assert out["card"] == out["cpu"]
        assert out["card"]["result"]["corrupt"] >= 1 and out["card"]["second"]["corrupt"] == 0
        assert {(v, i) for v, i, _ in out["card"]["tasks"]} == {
            (locs[0].slices[0].vid, 3), (locs[1].slices[0].vid, 13),
            (locs[2].slices[-1].vid, 5)}
        after = card.shards()
        assert after == plain.shards()
        assert {k: v for k, v in after.items() if k in before} == before
        assert [card.access.get(x) for x in locs] == data
    finally:
        fi.uninstall()
        card.stop()
        plain.stop()
