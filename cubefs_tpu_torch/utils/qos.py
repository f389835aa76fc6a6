"""Per-tenant QoS: admission control at the client-facing front doors.

Role parity: the reference shapes client IO before it reaches a disk
or a raft group (datanode/limit.go + util/ratelimit token buckets;
master-side S3 QoS limits per user/op). Here the shaping is pulled
into one gate consulted by the objectnode/S3 handler and the blob
access layer, and it is *closed-loop*: the SLO tracker's
burn-rate signal drives load shedding, so overload degrades the
lowest-value work first instead of collapsing every tenant's p99.

Decision order in `admit()` (cheapest check first):

1. `CUBEFS_QOS=0` door — returns a shared no-op admission: zero
   state touched, bit-identical to the pre-QoS path.
2. Brownout priority shed: when the path's burn rate crosses
   `burn_warn`, SCRUB-class work is shed outright; past
   `burn_critical`, REPAIR-class work too. Foreground is never shed
   by burn rate alone.
3. Queue-depth bound: per-path inflight must stay under the
   priority's share of `max_inflight` (foreground 100%, repair 75%,
   scrub 50%) — a saturated path rejects instead of queueing without
   bound.
4. Tenant token bucket: configured quotas shape (wait up to
   `shaping_timeout`) under normal load and shed with zero grace
   under brownout. Tenants with no configured quota are unlimited
   while the path is healthy (work conservation); a gate constructed
   with `brownout_quota=(rate, burst)` additionally clamps them once
   the path burns budget — the "shed over-quota tenants first" lever
   for unconfigured abusers.

Shed requests raise `QosRejected` (RpcError code 429 with a
retry-after hint); the blob SDK backs off through `RetryPolicy`, the
S3 door maps it to 429 SlowDown. Degradation hooks
(`fill_suppressed`, `scrub_suppressed`, `repair_step_scale`) let the
flash tier's fills, the scrubber and the repair scheduler shed
deferrable background work while any path is browned out.

Everything rides the injectable Clock protocol (utils/retry.py), so
the million-client loadgen drills run on FakeClock, deterministically.

The port's copy of ``cubefs_tpu/utils/qos.py``, with the same behaviour.
"""

from __future__ import annotations

import os
import threading

from . import metrics, trace as tracelib
from .ratelimit import TokenBucket
from .retry import MONOTONIC
from .rpc import RpcError

# priority classes: lower value = more important, shed last
FOREGROUND = 0
REPAIR = 1
SCRUB = 2
PRIORITY_NAMES = {FOREGROUND: "foreground", REPAIR: "repair", SCRUB: "scrub"}

# share of max_inflight each class may occupy (queue-depth bound)
_DEPTH_SHARE = {FOREGROUND: 1.0, REPAIR: 0.75, SCRUB: 0.5}

# brownout level -> repair drain step scale (the scheduler's weights)
_REPAIR_SCALE = {0: 1.0, 1: 0.5, 2: 0.25}


def enabled() -> bool:
    """The CUBEFS_QOS=0 A/B door: the whole layer no-ops when off."""
    return os.environ.get("CUBEFS_QOS", "1") != "0"


class QosRejected(RpcError):
    """Request shed at admission (HTTP/RPC 429). `retry_after` is the
    backoff hint a client should honor before re-trying."""

    def __init__(self, path: str, tenant: str, reason: str,
                 retry_after: float = 1.0):
        super().__init__(
            429, f"qos shed [{reason}] tenant={tenant} path={path} "
                 f"retry_after={retry_after:.3f}")
        self.path = path
        self.tenant = tenant
        self.reason = reason
        self.retry_after = retry_after


class _NoopAdmission:
    """Door-off / disabled-gate stand-in: full Admission surface,
    zero work, shared instance."""
    __slots__ = ()
    tenant = ""
    path = ""
    priority = FOREGROUND
    throttle_s = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def release(self):
        pass


NOOP_ADMISSION = _NoopAdmission()


class Admission:
    """One admitted request: context manager (or manual `release()`)
    that returns the inflight slot and restores the tenant context."""
    __slots__ = ("_gate", "path", "tenant", "priority", "throttle_s",
                 "_token", "_released")

    def __init__(self, gate: "QosGate", path: str, tenant: str,
                 priority: int, throttle_s: float):
        self._gate = gate
        self.path = path
        self.tenant = tenant
        self.priority = priority
        # shaping delay owed by this admission; the gate already slept
        # it when blocking, non-blocking callers (the simulator) add it
        # to their modeled latency instead
        self.throttle_s = throttle_s
        self._token = tracelib.set_tenant(tenant)
        self._released = False

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.release()
        return None

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        if self._token is not None:
            try:
                tracelib.reset_tenant(self._token)
            except ValueError:
                pass  # released from a different context (server thread)
            self._token = None
        self._gate._release(self.path)


class TenantQuota:
    """Per-tenant config: byte/op-rate quota + default priority."""
    __slots__ = ("rate", "burst", "priority")

    def __init__(self, rate: float = 0.0, burst: float | None = None,
                 priority: int = FOREGROUND):
        self.rate = float(rate)
        self.burst = burst
        self.priority = priority


class QosGate:
    """The admission gate shared by the objectnode/S3 and blob access
    front doors. One instance per process (`DEFAULT`) in production;
    drills build their own on FakeClock with a private SloTracker."""

    def __init__(self, tracker=None, clock=None, *,
                 max_inflight: int = 256,
                 burn_warn: float = 1.0,
                 burn_critical: float = 4.0,
                 shaping_timeout: float = 0.25,
                 brownout_quota: tuple[float, float] | None = None,
                 refresh_s: float = 1.0,
                 blocking: bool = True):
        self._tracker = tracker  # None -> utils.slo.DEFAULT_TRACKER, lazily
        self._clock = clock or MONOTONIC
        self.max_inflight = int(max_inflight)
        self.burn_warn = float(burn_warn)
        self.burn_critical = float(burn_critical)
        self.shaping_timeout = float(shaping_timeout)
        self.brownout_quota = brownout_quota
        self.refresh_s = float(refresh_s)
        self.blocking = blocking
        self._lock = threading.Lock()
        self._quotas: dict[str, TenantQuota] = {}
        self._buckets: dict[str, TokenBucket] = {}
        self._brownout_buckets: dict[str, TokenBucket] = {}
        self._inflight: dict[str, int] = {}
        self._levels: dict[str, int] = {}
        self._forced: dict[str, int] = {}
        self._last_refresh = float("-inf")
        self._counts = {"admitted": 0, "shed": 0, "throttled": 0}

    # ------------------------------------------------------------ config

    def configure(self, tenant: str, rate: float = 0.0,
                  burst: float | None = None,
                  priority: int = FOREGROUND) -> None:
        """Register a tenant quota (cost units/s; 0 = unlimited) and
        default priority class."""
        q = TenantQuota(rate, burst, priority)
        with self._lock:
            self._quotas[tenant] = q
            if rate > 0:
                self._buckets[tenant] = TokenBucket(
                    rate, burst, clock=self._clock, name=f"qos:{tenant}")
            else:
                self._buckets.pop(tenant, None)

    def tracker(self):
        if self._tracker is None:
            from . import slo
            self._tracker = slo.DEFAULT_TRACKER
        return self._tracker

    def force_level(self, path: str, level: int | None) -> None:
        """Operator/test override: pin a path's brownout level (None
        clears the pin and returns control to the burn-rate signal)."""
        with self._lock:
            if level is None:
                self._forced.pop(path, None)
            else:
                self._forced[path] = int(level)

    # ------------------------------------------------------- burn signal

    def _refresh_levels(self) -> None:
        now = self._clock.now()
        if now - self._last_refresh < self.refresh_s:
            return
        self._last_refresh = now
        snap = self.tracker().snapshot()
        levels = {}
        for path, entry in snap.items():
            burn = entry.get("burn_rate")
            if burn is None:
                continue
            if burn >= self.burn_critical:
                levels[path] = 2
            elif burn >= self.burn_warn:
                levels[path] = 1
            else:
                levels[path] = 0
        with self._lock:
            self._levels = levels
        for path, lvl in levels.items():
            metrics.qos_brownout.set(lvl, path=path)

    def level(self, path: str) -> int:
        """Current brownout level for a path (0 healthy / 1 warn /
        2 critical), refreshed from the SLO tracker at most every
        `refresh_s`."""
        self._refresh_levels()
        with self._lock:
            if path in self._forced:
                return self._forced[path]
            return self._levels.get(path, 0)

    def max_level(self) -> int:
        """Worst brownout level across all tracked paths — drives the
        global degradation hooks (fill suppression, repair throttle)."""
        self._refresh_levels()
        with self._lock:
            vals = list(self._levels.values()) + list(self._forced.values())
        return max(vals) if vals else 0

    # --------------------------------------------------------- admission

    def admit(self, path: str, tenant: str | None = None,
              priority: int | None = None, cost: float = 1.0,
              svc: str = "") -> "Admission | _NoopAdmission":
        """Admit one request to `path` on behalf of `tenant`, or raise
        QosRejected(429). Returns a context manager holding the
        inflight slot; use `with gate.admit(...):` around the handler
        body, or keep the Admission and `release()` it when the
        response is written."""
        if not enabled():
            return NOOP_ADMISSION
        if tenant is None:
            tenant = tracelib.current_tenant() or "anonymous"
        quota = self._quotas.get(tenant)
        if priority is None:
            priority = quota.priority if quota is not None else FOREGROUND
        priority = min(max(priority, FOREGROUND), SCRUB)
        level = self.level(path)

        # 1. burn-rate brownout: shed deferrable classes first
        if level >= 1 and priority >= SCRUB:
            self._shed(path, tenant, "brownout", retry_after=2.0)
        if level >= 2 and priority >= REPAIR:
            self._shed(path, tenant, "brownout", retry_after=2.0)

        # 2. queue-depth bound, scaled by priority share
        bound = int(self.max_inflight * _DEPTH_SHARE[priority])
        with self._lock:
            inflight = self._inflight.get(path, 0)
            if inflight >= bound:
                depth_full = True
            else:
                depth_full = False
                self._inflight[path] = inflight + 1
        if depth_full:
            self._shed(path, tenant, "queue_depth", retry_after=0.1)

        # 3. tenant bucket: shape while healthy, clamp under brownout
        throttle_s = 0.0
        bucket = self._buckets.get(tenant)
        if bucket is None and level >= 1 and self.brownout_quota:
            bucket = self._brownout_bucket(tenant)
        if bucket is not None:
            max_wait = 0.0 if level >= 1 else self.shaping_timeout
            wait = bucket.reserve(cost, max_wait=max_wait)
            if wait is None:
                self._release(path)
                self._shed(path, tenant, "over_quota",
                           retry_after=min(5.0, max(
                               0.05, bucket.time_to(cost))))
            if wait and wait > 0:
                throttle_s = wait
                metrics.qos_throttled.inc(path=path, tenant=tenant)
                metrics.qos_throttle_wait.observe(wait, path=path)
                with self._lock:
                    self._counts["throttled"] += 1
                if self.blocking:
                    self._clock.sleep(wait)

        metrics.qos_admitted.inc(
            path=path, tenant=tenant,
            priority=PRIORITY_NAMES.get(priority, str(priority)))
        metrics.qos_inflight.set(self._inflight.get(path, 0), path=path)
        with self._lock:
            self._counts["admitted"] += 1
        return Admission(self, path, tenant, priority, throttle_s)

    def _brownout_bucket(self, tenant: str) -> TokenBucket:
        with self._lock:
            b = self._brownout_buckets.get(tenant)
            if b is None:
                rate, burst = self.brownout_quota
                b = TokenBucket(rate, burst, clock=self._clock,
                                name=f"qos:brownout:{tenant}")
                self._brownout_buckets[tenant] = b
            return b

    def _shed(self, path: str, tenant: str, reason: str,
              retry_after: float):
        metrics.qos_shed.inc(path=path, tenant=tenant, reason=reason)
        with self._lock:
            self._counts["shed"] += 1
        raise QosRejected(path, tenant, reason, retry_after)

    def _release(self, path: str) -> None:
        with self._lock:
            n = self._inflight.get(path, 1) - 1
            self._inflight[path] = max(0, n)
        metrics.qos_inflight.set(self._inflight.get(path, 0), path=path)

    # ------------------------------------------------------------- views

    def snapshot(self) -> dict:
        self._refresh_levels()
        with self._lock:
            return {
                "counts": dict(self._counts),
                "inflight": dict(self._inflight),
                "levels": dict(self._levels, **self._forced),
                "tenants": {
                    t: {"rate": q.rate,
                        "priority": PRIORITY_NAMES.get(q.priority)}
                    for t, q in self._quotas.items()
                },
            }


DEFAULT = QosGate()


def admit(path: str, tenant: str | None = None, priority: int | None = None,
          cost: float = 1.0, svc: str = ""):
    return DEFAULT.admit(path, tenant=tenant, priority=priority,
                         cost=cost, svc=svc)


def fill_suppressed() -> bool:
    """Flash-tier fill suppression: while any path burns SLO budget,
    cache population (deferrable datanode->flashnode copies) stops so
    the disks serve foreground IO. Reads still hit existing cache."""
    if not enabled():
        return False
    return DEFAULT.max_level() >= 1


def scrub_suppressed() -> bool:
    """Scrub-class background work (cold-tier migration, compaction)
    stops at the first brownout level — the gate would shed its
    admissions anyway (SCRUB is dropped at level >= 1), so schedulers
    check this BEFORE reading payload bytes and skip the whole item
    instead of burning a read + a 429."""
    if not enabled():
        return False
    return DEFAULT.max_level() >= 1


def repair_step_scale() -> float:
    """Brownout multiplier for the repair scheduler's drain step bytes
    (its weights): 1.0 healthy, 0.5 under warn, 0.25 under critical."""
    if not enabled():
        return 1.0
    return _REPAIR_SCALE[min(2, DEFAULT.max_level())]
