"""SLO tracking: sliding-window tail estimator + error-budget burn.

Role parity: the reference gates operations on proxy/allocator latency
SLAs but keeps the math server-side in monitoring; here the estimator
lives in-process so admission control (the ROADMAP QoS item) can read
its own tails without a metrics round-trip.

Two layers:

- `WindowedHistogram`: a ring of per-window bucket-count arrays over a
  fixed bound set. observe()/add_counts() land in the current window;
  expired windows age out of the ring, so quantile() — cumulative-rank
  walk with linear interpolation inside the landing bucket — reflects
  only the last `window_s * windows` seconds. Clock-injectable (the
  utils/retry.py protocol) for deterministic tests.

- `SloTracker`: feeds per-path WindowedHistograms from the shared
  `cubefs_request_stage_seconds{path,stage="total"}` histogram by
  snapshot-diffing its cumulative buckets on every refresh() (scrape-
  driven: the /metrics handler refreshes before rendering). Per-path
  SLO targets produce three exported gauge families:
  `cubefs_slo_latency_quantile_seconds{path,quantile}`,
  `cubefs_slo_burn_rate{path}` (windowed violation fraction divided by
  the budget 1-objective; 1.0 = burning exactly at the objective), and
  `cubefs_slo_error_budget_remaining{path}`.

The port's copy of ``cubefs_tpu/utils/slo.py``, with the same behaviour.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

from . import metrics
from .retry import MONOTONIC

QUANTILES = (0.5, 0.95, 0.99, 0.999)
_QLABEL = {0.5: "p50", 0.95: "p95", 0.99: "p99", 0.999: "p999"}


def quantile_label(q: float) -> str:
    return _QLABEL.get(q, f"p{q * 100:g}".replace(".", "_"))


class WindowedHistogram:
    """Ring of windowed histograms over fixed bucket bounds.

    Counts are per-bucket (NOT cumulative) plus one overflow slot.
    Samples land in the current window; windows older than
    `window_s * windows` fall off the ring, so estimates track a
    sliding interval instead of the process lifetime.
    """

    def __init__(self, buckets=None, window_s: float = 10.0,
                 windows: int = 6, clock=None):
        self.buckets = tuple(
            buckets if buckets is not None
            else metrics.request_stage_seconds.BUCKETS)
        self.window_s = float(window_s)
        self.windows = int(windows)
        self._clock = clock or MONOTONIC
        self._lock = threading.Lock()
        # each ring slot: [t0, counts(list, len=len(buckets)+1), sum]
        self._ring: list[list] = []

    def _slot(self, now: float) -> list:
        """Current window, rolling the ring under self._lock."""
        horizon = now - self.window_s * self.windows
        while self._ring and self._ring[0][0] <= horizon:
            self._ring.pop(0)
        if not self._ring or now - self._ring[-1][0] >= self.window_s:
            self._ring.append([now, [0] * (len(self.buckets) + 1), 0.0])
        return self._ring[-1]

    def observe(self, value: float) -> None:
        import bisect
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            slot = self._slot(self._clock.now())
            slot[1][i] += 1
            slot[2] += value

    def add_counts(self, per_bucket: list[int], sum_: float = 0.0) -> None:
        """Ingest a delta of per-bucket counts (len == len(buckets)+1,
        last slot = overflow) — how the tracker feeds a scrape diff."""
        with self._lock:
            slot = self._slot(self._clock.now())
            for i, c in enumerate(per_bucket):
                slot[1][i] += c
            slot[2] += sum_

    def _merged(self) -> tuple[list[int], float]:
        with self._lock:
            self._slot(self._clock.now())  # roll expired windows out
            counts = [0] * (len(self.buckets) + 1)
            total_sum = 0.0
            for _, c, s in self._ring:
                for i, v in enumerate(c):
                    counts[i] += v
                total_sum += s
        return counts, total_sum

    def count(self) -> int:
        counts, _ = self._merged()
        return sum(counts)

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile by cumulative-rank walk with linear
        interpolation inside the landing bucket. Overflow samples
        report the top bound (the estimator saturates there)."""
        counts, _ = self._merged()
        total = sum(counts)
        if total == 0:
            return 0.0
        rank = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            if c and cum + c >= rank:
                if i >= len(self.buckets):  # overflow slot
                    return float(self.buckets[-1])
                lo = float(self.buckets[i - 1]) if i > 0 else 0.0
                hi = float(self.buckets[i])
                return lo + (hi - lo) * (rank - cum) / c
            cum += c
        return float(self.buckets[-1])

    def quantiles(self, qs=QUANTILES) -> dict[float, float]:
        return {q: self.quantile(q) for q in qs}

    def fraction_over(self, threshold: float) -> float:
        """Estimated fraction of windowed samples above `threshold`
        (bucket-interpolated CDF complement) — the violation rate."""
        counts, _ = self._merged()
        total = sum(counts)
        if total == 0:
            return 0.0
        over = 0.0
        for i, c in enumerate(counts):
            if not c:
                continue
            lo = float(self.buckets[i - 1]) if i > 0 else 0.0
            hi = (float(self.buckets[i]) if i < len(self.buckets)
                  else float("inf"))
            if threshold <= lo:
                over += c
            elif threshold < hi:
                over += c * (hi - threshold) / (hi - lo)
        return over / total


class SloTarget(NamedTuple):
    target_s: float    # latency objective per request
    objective: float   # fraction of requests that must meet it


# per-path defaults for the instrumented hot paths; override via
# SloTracker(targets=...) or register().
DEFAULT_TARGETS: dict[str, SloTarget] = {
    "blob.put": SloTarget(0.5, 0.999),
    "blob.get": SloTarget(0.25, 0.999),
    "blob.repair": SloTarget(5.0, 0.99),
    "meta.write": SloTarget(0.25, 0.999),
    # geo-replication lag rides the same stage histogram: the applier
    # observes each record's ship-stamp age as a "geo.replication"
    # total-stage sample, so a lagging follower burns this budget and
    # trips the SAME brownout machinery as a burning latency SLO
    # (utils/georepl.py)
    "geo.replication": SloTarget(2.0, 0.99),
}


class SloTracker:
    """Windows the shared stage histogram's `total` pseudo-stage into
    per-path tail estimates and burn-rate gauges."""

    def __init__(self, hist=None, targets=None, window_s: float = 10.0,
                 windows: int = 6, clock=None):
        self._hist = hist or metrics.request_stage_seconds
        self.targets = dict(DEFAULT_TARGETS if targets is None else targets)
        self._window_s = window_s
        self._windows = windows
        self._clock = clock or MONOTONIC
        self._lock = threading.Lock()
        self._wh: dict[str, WindowedHistogram] = {}
        # last cumulative snapshot per path: (count, sum, buckets[])
        self._last: dict[str, tuple[int, float, list[int]]] = {}

    def register(self, path: str, target_s: float,
                 objective: float = 0.999) -> None:
        self.targets[path] = SloTarget(target_s, objective)

    def _estimator(self, path: str) -> WindowedHistogram:
        wh = self._wh.get(path)
        if wh is None:
            wh = WindowedHistogram(self._hist.BUCKETS, self._window_s,
                                   self._windows, clock=self._clock)
            self._wh[path] = wh
        return wh

    def refresh(self) -> None:
        """Diff the stage histogram since the last refresh, window the
        delta, and export quantile / burn-rate / budget gauges."""
        with self._lock:
            for key, s in self._hist.samples():
                labels = dict(zip(self._hist.label_names, key))
                if labels.get("stage") != "total":
                    continue
                path = labels.get("path", "")
                if not path:
                    continue
                last_count, last_sum, last_buckets = self._last.get(
                    path, (0, 0.0, [0] * len(self._hist.BUCKETS)))
                if s["count"] <= last_count:
                    continue
                # cumulative prom buckets -> per-bucket delta + overflow
                delta = []
                prev_new = prev_old = 0
                for new, old in zip(s["buckets"], last_buckets):
                    delta.append((new - prev_new) - (old - prev_old))
                    prev_new, prev_old = new, old
                delta.append((s["count"] - prev_new)
                             - (last_count - prev_old))
                self._estimator(path).add_counts(
                    delta, s["sum"] - last_sum)
                self._last[path] = (s["count"], s["sum"],
                                    list(s["buckets"]))
            estimators = dict(self._wh)
        for path, wh in estimators.items():
            for q, v in wh.quantiles().items():
                metrics.slo_latency_quantile.set(
                    v, path=path, quantile=quantile_label(q))
            tgt = self.targets.get(path)
            if tgt is None:
                continue
            budget = 1.0 - tgt.objective
            violated = wh.fraction_over(tgt.target_s)
            burn = violated / budget if budget > 0 else 0.0
            metrics.slo_burn_rate.set(burn, path=path)
            metrics.slo_budget_remaining.set(
                max(0.0, 1.0 - burn), path=path)

    def snapshot(self) -> dict[str, dict]:
        """Per-path view for tests and the CLI: quantiles, windowed
        sample count, target, burn rate."""
        self.refresh()
        with self._lock:
            estimators = dict(self._wh)
        out = {}
        for path, wh in estimators.items():
            tgt = self.targets.get(path)
            qd = {quantile_label(q): v for q, v in wh.quantiles().items()}
            entry = {"quantiles": qd, "count": wh.count()}
            if tgt is not None:
                budget = 1.0 - tgt.objective
                violated = wh.fraction_over(tgt.target_s)
                entry["target_s"] = tgt.target_s
                entry["objective"] = tgt.objective
                entry["burn_rate"] = (violated / budget
                                      if budget > 0 else 0.0)
            out[path] = entry
        return out


def quantiles_from_histogram(hist=None, qs=QUANTILES) -> dict:
    """Whole-lifetime per-(path, stage) tails of a cumulative prom
    histogram — the bench/artifact export shape ({path: {stage:
    {count, mean_ms, p50_ms, ...}}}). The tracker windows instead;
    this reads everything the process ever observed."""
    hist = hist or metrics.request_stage_seconds
    out: dict[str, dict] = {}
    for key, s in hist.samples():
        labels = dict(zip(hist.label_names, key))
        path, stage_name = labels.get("path", ""), labels.get("stage", "")
        if not path or not stage_name or not s["count"]:
            continue
        wh = WindowedHistogram(hist.BUCKETS, window_s=float("inf"))
        delta, prev = [], 0
        for c in s["buckets"]:
            delta.append(c - prev)
            prev = c
        delta.append(s["count"] - prev)
        wh.add_counts(delta, s["sum"])
        entry = {"count": s["count"],
                 "mean_ms": round(s["sum"] / s["count"] * 1e3, 3)}
        for q in qs:
            entry[f"{quantile_label(q)}_ms"] = round(
                wh.quantile(q) * 1e3, 3)
        out.setdefault(path, {})[stage_name] = entry
    return out


DEFAULT_TRACKER = SloTracker()


def refresh() -> None:
    """Scrape hook: the /metrics handler refreshes the default tracker
    before rendering so exported gauges are current."""
    DEFAULT_TRACKER.refresh()
