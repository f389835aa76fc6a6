"""The roofline reader counts the documented bytes and operations."""

from __future__ import annotations

import time

import pytest

from portbench import harness, readers, roofline, tracing


def test_work_of_a_known_shape():
    # EC12P4 parity of a 64 MiB object: R=4, C=12, S=699,051, B=8
    nbytes, ops = roofline.work([(4, 12, 699_051, 8)])
    assert nbytes == 8 * 16 * 699_051
    assert ops == 2 * 4 * 12 * 699_051 * 8
    assert roofline.bound_s([(4, 12, 699_051, 8)]) == pytest.approx(nbytes / 3.35e12)


def test_codec_roofline_is_the_bound_over_the_kernels_time():
    calls = [harness.Call(client=0, start=0.0, end=1.0, ok=True, work=[(2, 12, 699_051, 64)]),
             harness.Call(client=1, start=0.0, end=1.0, ok=True, work=[(2, 12, 699_051, 64)])]
    win = harness.Window(start=0.0, seconds=1.0, calls=calls)
    trace = {"window_s": 1.0, "busy_s": 0.5, "copy_s": 0.4, "kernel_s": 0.01,
             "device_ops": [], "idle_gaps": []}
    run = readers.Run(window=win, trace=trace, counters=[], setup_s=1.0)
    want = 2 * 64 * 14 * 699_051 / 3.35e12 / 0.01 * 100
    assert readers.codec_roofline(run) == pytest.approx(want)
    assert readers.copy_share(run) == pytest.approx(80.0)
    assert readers.device_idle(run) == pytest.approx(50.0)
    untraced = readers.Run(window=win, trace=None, counters=[], setup_s=1.0)
    assert readers.codec_roofline(untraced) is None


def test_a_call_in_flight_at_the_close_is_counted_inside_the_traced_window():
    """The roofline counts the work of a call still running when the window
    closes, and the traced window lasts until that call returns, so its
    kernels are inside the kernel time the work is divided by."""

    def call(i, k, rec):
        time.sleep(0.3)
        rec.work = [(4, 12, 4096, 1)]

    prof = tracing.start()
    win = harness.closed_loop(1, call, 0.1, annotate=tracing.WINDOW)
    summary = tracing.summarize(tracing.stop(prof))
    (only,) = win.calls
    assert only.ok and only.end > win.end and not win.completed()
    assert summary["window_s"] >= only.end - win.start
    trace = {**summary, "kernel_s": 1e-6}
    run = readers.Run(window=win, trace=trace, counters=[], setup_s=1.0)
    assert readers.codec_roofline(run) == pytest.approx(
        roofline.bound_s([(4, 12, 4096, 1)]) / 1e-6 * 100)
