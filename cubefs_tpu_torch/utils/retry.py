"""One retry/backoff discipline for every RPC failover path.

Role parity: util/retry (retry.go's Timed/ExponentialBackoff) and
blobstore's hostpicker — the reference routes every client-side retry
through one policy object instead of ad-hoc ``time.sleep`` loops, and
so do we.  ``RetryPolicy`` is the *only* sanctioned way to wait out a
transient failure in this codebase: capped exponential backoff with
deterministic-seedable jitter, a per-call retry budget, and an overall
deadline.  Lint family CFB (tool/lint/checkers/retry_discipline.py)
flags sleeps in failover paths that bypass it.

``CircuitBreaker`` layers per-address closed/open/half-open state on
top so a dead replica is skipped instead of re-timed-out on every
call; state is exported through ``utils.metrics`` (``cubefs_breaker_state``,
``cubefs_breaker_skips_total``) and consulted by ``rpc.call_replicas``
and the blob access SDK.

Both take an injectable ``Clock`` so tests (tests/test_chaos.py) run
seeded fault schedules without wall-clock sleeps — see the
``FakeClock`` used together with ``faultinject.FaultPlan``.

The port's copy of ``cubefs_tpu/utils/retry.py``, with the same behaviour.
"""

from __future__ import annotations

import random
import threading
import time

from . import metrics


class Clock:
    """Monotonic wall clock; the production default."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


MONOTONIC = Clock()


class FakeClock(Clock):
    """Deterministic clock for tests: sleep() advances virtual time."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self._lock = threading.Lock()
        self.sleeps: list[float] = []

    def now(self) -> float:
        with self._lock:
            return self._now

    def sleep(self, seconds: float) -> None:
        with self._lock:
            self.sleeps.append(seconds)
            self._now += max(0.0, seconds)

    def advance(self, seconds: float) -> None:
        with self._lock:
            self._now += seconds


class RetryPolicy:
    """Capped exponential backoff + jitter + budget + deadline.

    The policy object is immutable and shareable; each logical call
    gets its own ``Retrier`` via :meth:`start`.  Backoff for retry
    ``n`` is ``min(cap, base * multiplier**n)`` shaved by up to
    ``jitter`` fraction (full-jitter style, decorrelating thundering
    herds).  With ``seed`` set the jitter sequence is reproducible,
    which tests use to assert byte-identical schedules.

    Works hand-in-hand with the rpc.call IDEMPOTENCY CONTRACT: a
    retried mutating RPC must carry an ``op_id`` so the server-side
    dedup door (see fs/metanode.py, utils/fsm.py) makes the retry
    exactly-once.  RetryPolicy makes retries *safe to take*; op_id
    makes them *safe to land twice*.
    """

    def __init__(self, base: float = 0.05, cap: float = 2.0,
                 multiplier: float = 2.0, jitter: float = 0.5,
                 max_retries: int | None = None,
                 deadline: float | None = 10.0,
                 seed: int | None = None, clock: Clock = MONOTONIC):
        self.base = base
        self.cap = cap
        self.multiplier = multiplier
        self.jitter = jitter
        self.max_retries = max_retries
        self.deadline = deadline
        self.seed = seed
        self.clock = clock

    def start(self, op: str = "", deadline: float | None = None,
              clock: Clock | None = None) -> "Retrier":
        return Retrier(self, op,
                       self.deadline if deadline is None else deadline,
                       clock or self.clock)

    def backoff(self, attempt: int, rnd: random.Random) -> float:
        raw = min(self.cap, self.base * self.multiplier ** attempt)
        if self.jitter:
            raw *= 1.0 - self.jitter * rnd.random()
        return raw


class Retrier:
    """Per-call retry state handed out by RetryPolicy.start().

    Usage::

        r = POLICY.start(op="alloc_extent")
        while True:
            try:
                return do_call()
            except ServiceUnavailable:
                if not r.tick(reason="failover"):
                    raise

    ``tick`` accounts one failed attempt, sleeps the next backoff on
    the policy clock, bumps ``cubefs_rpc_client_retries_total`` and
    returns False once the budget or deadline is exhausted (the caller
    then re-raises its last error).
    """

    def __init__(self, policy: RetryPolicy, op: str,
                 deadline: float | None, clock: Clock):
        self.policy = policy
        self.op = op
        self.clock = clock
        self.attempt = 0
        self._deadline = None if deadline is None else clock.now() + deadline
        self._rnd = random.Random(policy.seed)

    def remaining(self) -> float | None:
        if self._deadline is None:
            return None
        return max(0.0, self._deadline - self.clock.now())

    def within_deadline(self) -> bool:
        return self._deadline is None or self.clock.now() < self._deadline

    def tick(self, reason: str = "retry", sleep: bool = True) -> bool:
        p = self.policy
        if p.max_retries is not None and self.attempt >= p.max_retries:
            return False
        delay = p.backoff(self.attempt, self._rnd) if sleep else 0.0
        self.attempt += 1
        if self._deadline is not None:
            left = self._deadline - self.clock.now()
            if left <= 0:
                return False
            delay = min(delay, left)
        metrics.rpc_client_retries.inc(op=self.op, reason=reason)
        if delay > 0:
            self.clock.sleep(delay)
        return True


# breaker state codes as exported on the cubefs_breaker_state gauge
CLOSED, HALF_OPEN, OPEN = 0, 1, 2
_STATE_NAMES = {CLOSED: "closed", HALF_OPEN: "half-open", OPEN: "open"}


class CircuitBreaker:
    """Per-address closed/open/half-open breaker.

    Addresses start (and stay) untracked until a failure is recorded,
    so the success hot path is a single dict miss with no lock.  After
    ``threshold`` consecutive transport-level failures the address
    opens for ``cooldown`` seconds; the first ``allow`` after cooldown
    grants exactly one half-open probe, whose outcome closes or
    re-opens the breaker.  Only node-level failures (ServiceUnavailable,
    socket errors) should be recorded — handler-level RpcErrors mean
    the node is alive.
    """

    def __init__(self, threshold: int = 5, cooldown: float = 5.0,
                 clock: Clock = MONOTONIC):
        self.threshold = threshold
        self.cooldown = cooldown
        self.clock = clock
        self._states: dict[str, dict] = {}
        self._lock = threading.Lock()

    def state(self, addr: str) -> str:
        st = self._states.get(addr)
        return _STATE_NAMES[st["state"]] if st else "closed"

    def allow(self, addr: str) -> bool:
        if addr not in self._states:  # untracked: lock-free fast path
            return True
        with self._lock:
            st = self._states.get(addr)
            if st is None or st["state"] == CLOSED:
                return True
            if st["state"] == OPEN:
                if self.clock.now() < st["until"]:
                    metrics.breaker_skips.inc(addr=addr)
                    return False
                st["state"] = HALF_OPEN
                st["probing"] = True
                metrics.breaker_state.set(HALF_OPEN, addr=addr)
                return True  # the one half-open probe
            # HALF_OPEN: a probe is already in flight
            if st["probing"]:
                metrics.breaker_skips.inc(addr=addr)
                return False
            st["probing"] = True
            return True

    def record_success(self, addr: str) -> None:
        if addr not in self._states:  # hot path: nothing tracked
            return
        with self._lock:
            self._states.pop(addr, None)
        metrics.breaker_state.set(CLOSED, addr=addr)

    def record_failure(self, addr: str) -> None:
        with self._lock:
            st = self._states.setdefault(
                addr, {"state": CLOSED, "fails": 0, "until": 0.0,
                       "probing": False})
            st["fails"] += 1
            if st["state"] == HALF_OPEN or st["fails"] >= self.threshold:
                st["state"] = OPEN
                st["probing"] = False
                st["until"] = self.clock.now() + self.cooldown
                metrics.breaker_state.set(OPEN, addr=addr)
