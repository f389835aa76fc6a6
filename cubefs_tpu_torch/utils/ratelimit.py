"""Token-bucket rate limiting (disk QoS / client shaping).

Role parity: datanode/limit.go + util/ratelimit — client-facing IO is
shaped by byte-per-second buckets so background floods cannot starve
the disk. Blocking acquire with a fairness queue (FIFO via lock order);
a zero rate means unlimited.

The bucket is clock-injectable (utils/retry.py Clock protocol) so the
QoS drills can shape traffic on FakeClock, and every shaped
reservation is exported through `cubefs_ratelimit_waits_total` /
`cubefs_ratelimit_wait_seconds`.

The port's copy of ``cubefs_tpu/utils/ratelimit.py``, with the same behaviour.
"""

from __future__ import annotations

import threading

from . import metrics
from .retry import MONOTONIC


class TokenBucket:
    """Blocking byte-rate limiter: `acquire(n)` waits until n tokens are
    available. Burst capacity defaults to one second of rate."""

    def __init__(self, rate_bytes_per_s: float, burst: float | None = None,
                 *, clock=None, name: str = ""):
        self.rate = float(rate_bytes_per_s)
        self.burst = float(burst if burst is not None else rate_bytes_per_s)
        self.name = name
        self._clock = clock or MONOTONIC
        self._tokens = self.burst
        self._last = self._clock.now()
        self._lock = threading.Lock()

    def _refill(self) -> None:
        now = self._clock.now()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._last) * self.rate)
        self._last = now

    def reserve(self, n: int, max_wait: float | None = None) -> float | None:
        """Reserve n tokens without sleeping: returns the wait the
        caller owes (0.0 when tokens were available), or None when the
        wait would exceed `max_wait` — in which case NOTHING is
        reserved. Oversized requests (n > burst) are allowed by letting
        the balance go negative, so a single large IO is shaped rather
        than deadlocked; later arrivals see the debt and queue
        virtually behind it (FIFO via lock order).

        The QoS gate uses this directly so admission delay can ride an
        injectable clock instead of parking the bucket's caller."""
        if self.rate <= 0:
            return 0.0
        with self._lock:
            self._refill()
            need = min(n, self.burst)
            if self._tokens >= need:
                self._tokens -= n  # may go negative for n > burst
                wait = 0.0
            else:
                wait = (need - self._tokens) / self.rate
                if max_wait is not None and wait > max_wait:
                    return None  # rejected WITHOUT reserving
                self._tokens -= n
        if wait > 0:
            limiter = self.name or "default"
            metrics.ratelimit_waits.inc(limiter=limiter)
            metrics.ratelimit_wait_seconds.observe(wait, limiter=limiter)
        return wait

    def time_to(self, n: int) -> float:
        """Seconds until n tokens could be reserved with zero wait —
        the Retry-After hint for a shed-over-quota reply."""
        if self.rate <= 0:
            return 0.0
        with self._lock:
            self._refill()
            need = min(n, self.burst)
            if self._tokens >= need:
                return 0.0
            return (need - self._tokens) / self.rate

    def acquire(self, n: int, timeout: float | None = None) -> bool:
        """Consume n tokens, sleeping as needed.

        The reservation happens under the lock but the SLEEP does not:
        later arrivals see the debt and queue virtually behind it, so a
        large shaped IO never parks every server thread on the lock,
        and the timeout is honored at admission time."""
        wait = self.reserve(n, max_wait=timeout)
        if wait is None:
            return False
        if wait > 0:
            self._clock.sleep(wait)
        return True


class DiskQos:
    """Per-disk read/write byte shaping (datanode/limit.go analog)."""

    def __init__(self, read_bps: float = 0, write_bps: float = 0):
        self.read = (TokenBucket(read_bps, name="disk_read")
                     if read_bps else None)
        self.write = (TokenBucket(write_bps, name="disk_write")
                      if write_bps else None)

    @classmethod
    def from_config(cls, cfg: dict | None) -> "DiskQos | None":
        if not cfg:
            return None
        return cls(read_bps=float(cfg.get("read_bps", 0)),
                   write_bps=float(cfg.get("write_bps", 0)))

    def acquire_read(self, n: int) -> None:
        if self.read is not None:
            self.read.acquire(n)

    def acquire_write(self, n: int) -> None:
        if self.write is not None:
            self.write.acquire(n)
