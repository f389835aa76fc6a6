"""Every cell's run on the CPU at a small size: a sound run is correct
and reports its metrics; the control, and each fault planted under the
timed path, reads as not correct."""

from __future__ import annotations

import pytest

from portbench import harness
from portbench.control import readings
from portbench.run import run_cell
from portbench.traffic import faults

from .conftest import CELLS, small

SEED = 2**31 + 77  # past 32 signed bits, as the driver's seeds go


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct_and_reports_its_metrics(cell):
    res = run_cell(cell, SEED, 1.0, False, device="cpu", **small(cell))
    line = res["line"]
    assert line["correct"], (res["checks"], res["errors"])
    assert line["attempted"] > 0 and line["failed"] == 0
    # no device on the CPU: an end-to-end metric of the device trace is left out
    want = {m["name"] for m in harness.cell_metrics(harness.benchmark(), cell, "end_to_end")
            if m["source"] != "device_trace"}
    assert set(line["metrics"]) == want
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_the_per_layer_metrics_it_can_read(cell):
    res = run_cell(cell, SEED + 1, 1.0, True, device="cpu", **small(cell))
    line = res["line"]
    assert line["correct"]
    assert line["device"]["window_s"] >= 1.0
    per_layer = harness.cell_metrics(harness.benchmark(), cell, "per_layer")
    assert set(line["metrics"]) <= {m["name"] for m in per_layer}
    # no device on the CPU: of the trace's metrics only the idle share reads
    # (100%); the host clock's and the counters' all read
    for m in per_layer:
        traced = m["source"] == "device_trace" and not m["name"].startswith("device_idle.")
        assert (m["name"] in line["metrics"]) != traced, m["name"]
    assert line["breakdown"]["idle_gaps"][0][0].startswith("pb.")


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_and_every_fault_read_as_not_correct(cell):
    seen = {rec["mode"]: rec for rec in readings(
        cell, [SEED + 2], 1.0, ["control", *faults.FAULTS], device="cpu", **small(cell))}
    for mode, rec in seen.items():
        assert not rec["correct"], (mode, rec)
        assert rec["checks"][next(iter(rec["checks"]))] > 0 or rec["checks"]["failed_calls"] > 0


def test_the_same_seed_gives_the_same_inputs():
    a = harness.seeded_bytes(SEED, 3, 4096, "cpu")
    assert (a == harness.seeded_bytes(SEED, 3, 4096, "cpu")).all()
    assert not (a == harness.seeded_bytes(SEED + 1, 3, 4096, "cpu")).all()
