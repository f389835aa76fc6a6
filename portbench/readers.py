"""What a metric reader reads: a finished run (``Run``) and the arithmetic
the readers share. A reader returns None where its run holds nothing to
read (an untraced run for a trace metric, a window with no codec work),
and the harness then leaves the metric out of the line."""

from __future__ import annotations

from dataclasses import dataclass

from . import roofline
from .harness import Window


@dataclass
class Run:
    window: Window
    trace: dict | None  # tracing.summarize's record of the traced window
    counters: list  # (name, labels, change over the window) of the program's counters
    setup_s: float


def counter(run: Run, name: str, **labels) -> float:
    """The change over the window of every series of ``name`` whose
    labels include ``labels``."""
    return sum(v for n, lab, v in run.counters
               if n == name and all(lab.get(k) == x for k, x in labels.items()))


def share(part: float, whole: float) -> float | None:
    return 100.0 * part / whole if whole > 0 else None


def copy_share(run: Run) -> float | None:
    """Host-device copy time over device busy time, in %."""
    if run.trace is None:
        return None
    return share(run.trace["copy_s"], run.trace["busy_s"])


def copy_amp(run: Run) -> float | None:
    """Bytes copied between host and card per user byte of the calls in
    the window: every call started in it that returned, those in flight
    at its close included, as the traced window lasts until each has
    returned (``codec_roofline``)."""
    if run.trace is None or run.trace["copy_bytes"] <= 0:
        return None
    user = sum(c.nbytes for c in run.window.calls if c.ok)
    return run.trace["copy_bytes"] / user if user > 0 else None


def device_idle(run: Run) -> float | None:
    """The share of the traced window with nothing running on the card, in %."""
    if run.trace is None:
        return None
    return share(run.trace["window_s"] - run.trace["busy_s"], run.trace["window_s"])


def codec_roofline(run: Run) -> float | None:
    """The bound of the window's codec work over the device time of its
    kernels (every kernel that is not a copy, whatever its name), in %.
    The work is every call started in the window that returned, those in
    flight at its close included: the traced window (``pb.window``)
    lasts until every such call has returned, so each counted call's
    kernels lie inside the kernel time it is divided by."""
    if run.trace is None:
        return None
    applies = [w for c in run.window.calls if c.ok for w in c.work]
    if not applies:
        return None
    return share(roofline.bound_s(applies), run.trace["kernel_s"])


def stripes_per_step(run: Run) -> float | None:
    """Stripes the batcher admitted per device step it ran, over every
    queue in the window (a cell's queues hold its own calls alone: an
    RS encode's, an LRC encode's apply rows, a worker's decode rows)."""
    steps = counter(run, "cubefs_codec_batch_steps_total")
    if steps <= 0:
        return None
    return counter(run, "cubefs_codec_batch_submissions_total") / steps
