"""Continuous self-healing scrubber: the one sweep discipline.

Role parity: blobstore's volume inspect service and datanode's CRC
scrub loop — the reference continuously re-reads every byte at rest and
compares checksums, because bit-rot that is only discovered at client
read time has already been undetected for months.  Both planes drive
the same generic ``Scrubber`` here with plane-specific callables:

* ``list_units()`` → ordered list of opaque unit keys (extents for the
  fs plane, volumes for the blob plane).
* ``scrub_unit(unit)`` → outcome string: ``"clean"``, ``"corrupt"``
  (found AND queued/performed a heal), or ``"skipped"``.

Discipline shared across planes:

* **QoS-subordinate** — each run first consults
  ``qos.scrub_suppressed()``; under brownout the whole slice is shed
  (SCRUB-class work would be rejected at admission anyway, so the
  scrubber doesn't even burn the list walk).
* **rate-limited** — at most ``rate`` units per second via the
  injected clock, so a full pass trickles instead of competing with
  foreground IO.
* **resumable** — the cursor (last completed unit key) persists via
  ``cursor_save``/``cursor_load`` (file or KV); a restarted process
  resumes mid-pass instead of rescanning from zero.
* **clock-injectable** — FakeClock makes a "continuous" scrub run to
  completion inside a deterministic test.
* **door** — ``CUBEFS_SCRUB=0`` disables runs entirely; the door is
  FSM-digest-identical off because scrubbing never writes FSM records
  (heals ride the existing repair paths).

Progress lands in ``cubefs_scrub_items_total{plane,outcome}``,
``cubefs_scrub_cursor_position`` and, on each completed pass,
``cubefs_scrub_last_full_pass_seconds``.

The port's copy of ``cubefs_tpu/utils/scrub.py``, with the same
behaviour; the port's blob scheduler is its one plane so far.
"""

from __future__ import annotations

import os
import threading
from typing import Callable

from . import metrics, qos
from .retry import MONOTONIC, Clock


def enabled() -> bool:
    """CUBEFS_SCRUB door (default on)."""
    return os.environ.get("CUBEFS_SCRUB", "1") != "0"


class Scrubber:
    def __init__(self, plane: str,
                 list_units: Callable[[], list],
                 scrub_unit: Callable[[object], str], *,
                 clock: Clock = MONOTONIC, rate: float = 0.0,
                 cursor_load: Callable[[], object] | None = None,
                 cursor_save: Callable[[object], None] | None = None):
        self.plane = str(plane)
        self.list_units = list_units
        self.scrub_unit = scrub_unit
        self.clock = clock
        self.rate = float(rate)  # units/sec; 0 = unthrottled
        self._cursor_load = cursor_load
        self._cursor_save = cursor_save
        self._lock = threading.Lock()
        self._cursor = None         # last COMPLETED unit key
        self._cursor_loaded = False
        self._pass_started: float | None = None
        self._last_full_pass: float | None = None
        self._full_passes = 0
        self._scanned = 0
        self._corrupt = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ---- cursor persistence -------------------------------------------

    def _load_cursor(self):
        if not self._cursor_loaded:
            self._cursor_loaded = True
            if self._cursor_load is not None:
                try:
                    self._cursor = self._cursor_load()
                except Exception:
                    self._cursor = None  # lost cursor => restart pass
        return self._cursor

    def _save_cursor(self, cursor) -> None:
        self._cursor = cursor
        if self._cursor_save is not None:
            try:
                self._cursor_save(cursor)
            except Exception:
                pass  # next run re-persists; worst case re-scrub a unit

    # ---- one slice -----------------------------------------------------

    def run_once(self, max_units: int | None = None) -> dict:
        """Scrub up to ``max_units`` from the cursor; wraps to a new
        pass when the unit list is exhausted.  Returns a summary."""
        out = {"plane": self.plane, "scanned": 0, "corrupt": 0,
               "skipped": 0, "completed_pass": False}
        if not enabled():
            out["door"] = "closed"
            return out
        if qos.scrub_suppressed():
            out["suppressed"] = True
            return out
        units = list(self.list_units())
        if not units:
            return out
        cursor = self._load_cursor()
        start = 0
        if cursor is not None:
            try:
                start = units.index(cursor) + 1
            except ValueError:
                start = 0  # unit list changed under us: restart the pass
        if start == 0 and self._pass_started is None:
            self._pass_started = self.clock.now()
        budget = len(units) if max_units is None else min(max_units,
                                                          len(units))
        i = start
        for _ in range(budget):
            if self._stop.is_set():
                break
            if i >= len(units):
                self._finish_pass(out)
                i = 0
                if self._pass_started is None:
                    self._pass_started = self.clock.now()
            unit = units[i]
            try:
                outcome = self.scrub_unit(unit)
            except Exception:
                outcome = "skipped"  # unit scrub failure must not kill the pass
            outcome = outcome or "clean"
            metrics.scrub_items.inc(plane=self.plane, outcome=outcome)
            out["scanned"] += 1
            with self._lock:
                self._scanned += 1
                if outcome == "corrupt":
                    self._corrupt += 1
            if outcome == "corrupt":
                out["corrupt"] += 1
            elif outcome == "skipped":
                out["skipped"] += 1
            self._save_cursor(unit)
            metrics.scrub_cursor.set(i, plane=self.plane)
            i += 1
            if self.rate > 0:
                self.clock.sleep(1.0 / self.rate)
        if i >= len(units):
            self._finish_pass(out)
        return out

    def _finish_pass(self, out: dict) -> None:
        now = self.clock.now()
        with self._lock:
            if self._pass_started is not None:
                self._last_full_pass = now - self._pass_started
                metrics.scrub_last_full_pass.set(self._last_full_pass,
                                                 plane=self.plane)
            self._pass_started = None
            self._full_passes += 1
        out["completed_pass"] = True
        self._save_cursor(None)

    def run_full_pass(self, limit: int = 1 << 20) -> dict:
        """Drive run_once until a pass completes (tests, cli `scrub run`)."""
        total = {"plane": self.plane, "scanned": 0, "corrupt": 0,
                 "skipped": 0, "completed_pass": False}
        for _ in range(limit):
            got = self.run_once(max_units=64)
            for k in ("scanned", "corrupt", "skipped"):
                total[k] += got[k]
            if got.get("door") == "closed" or got.get("suppressed"):
                total.update({k: got[k] for k in got
                              if k in ("door", "suppressed")})
                return total
            if got["completed_pass"] or got["scanned"] == 0:
                total["completed_pass"] = got["completed_pass"]
                return total
        return total

    # ---- background loop ----------------------------------------------

    def start(self, interval: float = 1.0,
              units_per_tick: int = 8) -> None:
        if self._thread is not None:
            return

        def _loop():
            while not self._stop.is_set():
                try:
                    self.run_once(max_units=units_per_tick)
                except Exception:
                    pass  # scrub must never take the host process down
                self.clock.sleep(interval)

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name=f"scrub-{self.plane}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)
        self._stop.clear()

    def status(self) -> dict:
        with self._lock:
            return {
                "plane": self.plane,
                "enabled": enabled(),
                "cursor": self._cursor,
                "scanned": self._scanned,
                "corrupt": self._corrupt,
                "full_passes": self._full_passes,
                "last_full_pass_seconds": self._last_full_pass,
                "running": self._thread is not None,
            }
