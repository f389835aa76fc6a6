"""Disk health quarantine: IO-error counts + latency-outlier EWMA.

Role parity: datanode disk health checker + blobstore broken-disk
reporting — the reference flips a disk that throws IO errors or turns
latency-pathological into a no-new-allocations state long before it
dies outright (a "limping" disk hurts tails worse than a dead one).

``DiskHealthTracker`` mirrors the ``retry.CircuitBreaker`` state
machine, per disk instead of per address:

    normal ──errors/latency──▶ quarantined ──probe due──▶ probing
       ▲                                                     │
       └────────── probe_pass ◀──────────┴── probe_fail ─────┘

* **error trips**: ``error_threshold`` IO errors inside a sliding
  ``error_window`` quarantine the disk.
* **latency trips**: each disk keeps an EWMA of IO latency; once every
  disk has ``min_samples`` the tracker compares against the *peer
  median* — a disk sitting above ``latency_factor`` × median is the
  lying/limping disk and gets quarantined.  Peer-relative (not
  absolute) so a globally slow box never mass-quarantines itself.
* **probe-based unquarantine**: callers ask ``probe_due`` on their
  heartbeat cadence, run a real probe IO (write+fsync — same probe the
  broken-disk path uses), and report ``probe_result``.  A pass returns
  the disk to normal; a fail re-arms the cooldown.

Quarantine is deliberately softer than broken: a quarantined disk
serves existing data (reads still work, repair can still pull from it)
but receives no new allocations, and the schedulers kick
``plan_disk_drain`` to migrate off it.  All transitions land in
``cubefs_disk_quarantine_*`` metrics.  Clock-injectable for chaos
drills (FakeClock).

The port's copy of ``cubefs_tpu/utils/diskhealth.py``, with the same behaviour.
"""

from __future__ import annotations

import threading
from collections import deque

from . import metrics
from .retry import MONOTONIC, Clock


class DiskHealthTracker:
    def __init__(self, node: str, disks, *, clock: Clock = MONOTONIC,
                 error_threshold: int = 3, error_window: float = 60.0,
                 latency_factor: float = 4.0, min_samples: int = 20,
                 ewma_alpha: float = 0.2, probe_cooldown: float = 30.0):
        self.node = str(node)
        self.clock = clock
        self.error_threshold = int(error_threshold)
        self.error_window = float(error_window)
        self.latency_factor = float(latency_factor)
        self.min_samples = int(min_samples)
        self.ewma_alpha = float(ewma_alpha)
        self.probe_cooldown = float(probe_cooldown)
        self._lock = threading.Lock()
        self._errors: dict[int, deque[float]] = {int(d): deque() for d in disks}
        self._ewma: dict[int, float] = {}
        self._samples: dict[int, int] = {int(d): 0 for d in disks}
        # disk_id -> (reason, next probe-eligible time)
        self._quarantined: dict[int, tuple[str, float]] = {}

    # ---- ingestion ---------------------------------------------------

    def record_io(self, disk_id: int, seconds: float, ok: bool = True) -> None:
        """Feed one IO's latency/outcome; may flip the disk quarantined."""
        disk_id = int(disk_id)
        now = self.clock.now()
        with self._lock:
            if disk_id not in self._errors:
                self._errors[disk_id] = deque()
                self._samples[disk_id] = 0
            if not ok:
                dq = self._errors[disk_id]
                dq.append(now)
                while dq and now - dq[0] > self.error_window:
                    dq.popleft()
                if (disk_id not in self._quarantined
                        and len(dq) >= self.error_threshold):
                    self._quarantine(disk_id, "io_errors", now)
                return
            prev = self._ewma.get(disk_id)
            self._ewma[disk_id] = (seconds if prev is None else
                                   (1 - self.ewma_alpha) * prev
                                   + self.ewma_alpha * seconds)
            self._samples[disk_id] += 1
            self._check_latency(disk_id, now)

    def _check_latency(self, disk_id: int, now: float) -> None:
        # caller holds self._lock
        if disk_id in self._quarantined:
            return
        peers = [self._ewma[d] for d in self._ewma
                 if d != disk_id and d not in self._quarantined
                 and self._samples.get(d, 0) >= self.min_samples]
        if len(peers) < 2 or self._samples[disk_id] < self.min_samples:
            return  # need a quorum of healthy peers to call an outlier
        peers.sort()
        median = peers[len(peers) // 2]
        if median > 0 and self._ewma[disk_id] > self.latency_factor * median:
            self._quarantine(disk_id, "latency_outlier", now)

    def _quarantine(self, disk_id: int, reason: str, now: float) -> None:
        # caller holds self._lock
        self._quarantined[disk_id] = (reason, now + self.probe_cooldown)
        metrics.disk_quarantine_transitions.inc(node=self.node,
                                                event="quarantine")
        metrics.disk_quarantined.set(len(self._quarantined), node=self.node)

    # ---- probing (half-open) -----------------------------------------

    def probe_due(self, disk_id: int) -> bool:
        """True when the quarantined disk's cooldown has elapsed and a
        real probe IO should decide its fate (heartbeat cadence)."""
        with self._lock:
            ent = self._quarantined.get(int(disk_id))
            return ent is not None and self.clock.now() >= ent[1]

    def probe_result(self, disk_id: int, ok: bool) -> None:
        disk_id = int(disk_id)
        with self._lock:
            if disk_id not in self._quarantined:
                return
            if ok:
                del self._quarantined[disk_id]
                self._errors[disk_id].clear()
                # forget the pathological EWMA so it re-learns clean
                self._ewma.pop(disk_id, None)
                self._samples[disk_id] = 0
                metrics.disk_quarantine_transitions.inc(node=self.node,
                                                        event="probe_pass")
            else:
                reason, _ = self._quarantined[disk_id]
                self._quarantined[disk_id] = (
                    reason, self.clock.now() + self.probe_cooldown)
                metrics.disk_quarantine_transitions.inc(node=self.node,
                                                        event="probe_fail")
            metrics.disk_quarantined.set(len(self._quarantined),
                                         node=self.node)

    # ---- queries ------------------------------------------------------

    def quarantined(self) -> list[int]:
        with self._lock:
            return sorted(self._quarantined)

    def is_quarantined(self, disk_id: int) -> bool:
        with self._lock:
            return int(disk_id) in self._quarantined

    def status(self) -> dict:
        with self._lock:
            return {
                "node": self.node,
                "quarantined": {
                    str(d): {"reason": r, "probe_at": t}
                    for d, (r, t) in sorted(self._quarantined.items())
                },
                "ewma_ms": {str(d): round(v * 1000.0, 3)
                            for d, v in sorted(self._ewma.items())},
            }
