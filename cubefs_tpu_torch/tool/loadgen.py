"""Closed-loop million-client traffic model on FakeClock.

The ROADMAP's brownout-under-load gate: a deterministic event-driven
simulation of 10^5-10^6 clients with tenant identity, zipf-skewed
object popularity, and open/closed arrival mixing, driving the
per-tenant QoS gate (utils/qos.py) against a shared-capacity queueing
backend — all on virtual time, so the same seed produces the same
schedule digest byte for byte.

Model
-----
Each client is one entry in a single event heap `(t, seq, client_id)`;
per-client state is derived from the id (tenant = id range), and all
randomness comes from one seeded `random.Random`, drawn in heap-pop
order — no wall clock, no threads, no per-client objects, which is
what makes 10^6 clients tractable and bit-reproducible.

- closed loop: a client's next request departs `latency + think` after
  the previous one completes (think ~ Exp(mean think_s)), so a
  saturated server self-limits its clients — the production behavior
  token-bucket sizing must be judged against.
- open mixing: with probability `open_fraction` the next arrival is
  scheduled `Exp(think_s)` after the *previous arrival* instead,
  modeling fire-and-forget producers that do not slow down under
  brownout.
- zipf popularity: object ranks weighted 1/rank^s over `n_objects`,
  sampled by CDF bisect.

`SimBackend` is a deterministic shared-FIFO queueing model: one
server of `capacity` cost-units/s; latency = queue wait + service.
One tenant saturating PUTs therefore inflates every tenant's tail —
exactly the noisy-neighbor failure the QoS gate must contain.

The `--qos-ab` mode runs the seeded noisy-neighbor drill ABBA
(on, off, off, on) and writes its record to `--out` when given: with
QoS on, the victim's read p99 stays within its registered SLO budget
while the bully is shed; door-off, the same seed demonstrably
violates it.

The port's copy of ``cubefs_tpu/tool/loadgen.py``, over the port's
``utils/{qos,slo,packet}.py`` and ``sdk.WireClient``; the same seed gives
the reference's schedule digest. It does no card work and imports
nothing that initialises CUDA, so ``--wire`` may fork its workers. Where
the reference's wire mode runs unpinned when the host refuses
``sched_setaffinity``, the port's fails loudly: the server-bottleneck
claim rests on one core per process. ``check_host()`` (``--check-host``)
probes the two host calls the wire mode needs.
"""

from __future__ import annotations

import argparse
import bisect
import ctypes
import hashlib
import heapq
import json
import math
import multiprocessing as mp
import os
import random
import resource
import time
from typing import NamedTuple

from ..utils import metrics, qos, slo
from ..utils.retry import FakeClock


class TenantSpec(NamedTuple):
    """One tenant population: `clients` identical closed-loop clients."""
    name: str
    clients: int
    think_s: float = 1.0        # mean think time between requests
    read_fraction: float = 0.5  # GET share; rest are PUTs
    put_cost: float = 8.0       # cost units per PUT (relative bytes)
    get_cost: float = 1.0       # cost units per GET
    open_fraction: float = 0.0  # share of arrivals that are open-loop
    priority: int = qos.FOREGROUND


class SimBackend:
    """Shared-capacity FIFO server: the cluster reduced to one queue.

    Deterministic: `issue(t, cost)` returns queue-wait + service time
    against a single `busy_until` horizon. A closed-loop client fleet
    against this reproduces the classic saturation curve (latency ~
    outstanding_work / capacity) without threads or wall time."""

    def __init__(self, capacity: float = 2000.0, base_latency: float = 0.002):
        self.capacity = float(capacity)
        self.base_latency = float(base_latency)
        self.busy_until = 0.0
        self.served_cost = 0.0

    def issue(self, t: float, cost: float) -> float:
        start = max(t, self.busy_until)
        service = cost / self.capacity
        self.busy_until = start + service
        self.served_cost += cost
        return (self.busy_until - t) + self.base_latency


class _Measure:
    """Per-(tenant, path) latency windows kept OUTSIDE the gate, so
    the off leg (gate no-op) measures with the identical instrument."""

    def __init__(self, clock, horizon_s: float):
        self._clock = clock
        self._horizon = horizon_s
        self._wh: dict[tuple[str, str], slo.WindowedHistogram] = {}

    def observe(self, tenant: str, path: str, latency: float) -> None:
        key = (tenant, path)
        wh = self._wh.get(key)
        if wh is None:
            wh = slo.WindowedHistogram(
                window_s=self._horizon, windows=1, clock=self._clock)
            self._wh[key] = wh
        wh.observe(latency)

    def quantile(self, tenant: str, path: str, q: float) -> float:
        wh = self._wh.get((tenant, path))
        return wh.quantile(q) if wh is not None else 0.0

    def count(self, tenant: str, path: str) -> int:
        wh = self._wh.get((tenant, path))
        return wh.count() if wh is not None else 0


class LoadModel:
    """The event loop: seeded, clocked, digested."""

    def __init__(self, tenants: list[TenantSpec], *, seed: int = 0,
                 n_objects: int = 4096, zipf_s: float = 1.1,
                 backend: SimBackend | None = None,
                 gate: "qos.QosGate | None" = None,
                 clock: FakeClock | None = None,
                 slo_hist: metrics.Histogram | None = None,
                 warmup_s: float = 1.0,
                 max_retries: int = 8):
        self.tenants = list(tenants)
        self.seed = seed
        self.rng = random.Random(seed)
        self.clock = clock or FakeClock()
        self.backend = backend or SimBackend()
        self.gate = gate
        # the gate's SloTracker reads this histogram's {path,
        # stage="total"} series — the simulation feeds it directly so
        # burn rates close the loop on modeled latency
        self.slo_hist = slo_hist
        self.warmup_s = warmup_s
        self.max_retries = max_retries
        # zipf CDF over object ranks (sampled by bisect)
        weights = [1.0 / (r ** zipf_s) for r in range(1, n_objects + 1)]
        total = math.fsum(weights)
        acc, cdf = 0.0, []
        for w in weights:
            acc += w
            cdf.append(acc / total)
        self._zipf_cdf = cdf
        # client_id -> tenant via contiguous id ranges
        self._bounds, self._specs = [], []
        base = 0
        for t in self.tenants:
            base += t.clients
            self._bounds.append(base)
            self._specs.append(t)
        self.n_clients = base
        self._digest = hashlib.sha256()
        self.stats = {
            "events": 0, "issued": 0, "shed": 0, "retries_exhausted": 0,
            "per_tenant": {t.name: {"issued": 0, "shed": 0, "cost": 0.0}
                           for t in self.tenants},
        }

    def _tenant_of(self, cid: int) -> TenantSpec:
        return self._specs[bisect.bisect_right(self._bounds, cid)]

    def _sample_object(self) -> int:
        return bisect.bisect_left(self._zipf_cdf, self.rng.random())

    def _exp(self, mean: float) -> float:
        # inverse-CDF draw from the shared rng (deterministic order)
        u = self.rng.random()
        return -mean * math.log(1.0 - u) if mean > 0 else 0.0

    def schedule_digest(self) -> str:
        return self._digest.hexdigest()

    def run(self, duration_s: float = 30.0,
            max_events: int = 1_000_000) -> dict:
        """Drive the fleet for `duration_s` of virtual time (or until
        `max_events`). Returns the stats dict (digest included)."""
        heap: list[tuple[float, int, int, int]] = []
        seq = 0
        for cid in range(self.n_clients):
            # staggered first arrivals across the warmup window; the
            # 4th tuple slot is the retry count of a shed request
            heap.append((self.rng.random() * self.warmup_s, seq, cid, 0))
            seq += 1
        heapq.heapify(heap)
        measure = _Measure(self.clock, horizon_s=duration_s + self.warmup_s)
        self.measure = measure
        while heap and self.stats["events"] < max_events:
            t, _, cid, retries = heapq.heappop(heap)
            if t > duration_s:
                break
            now = self.clock.now()
            if t > now:
                self.clock.advance(t - now)
            spec = self._tenant_of(cid)
            is_read = self.rng.random() < spec.read_fraction
            op = "get" if is_read else "put"
            path = f"blob.{op}"
            cost = spec.get_cost if is_read else spec.put_cost
            obj = self._sample_object()
            self.stats["events"] += 1
            self._digest.update(
                f"{t:.9f}|{cid}|{spec.name}|{op}|{obj}|{retries}\n"
                .encode())
            pt = self.stats["per_tenant"][spec.name]
            try:
                if self.gate is not None:
                    adm = self.gate.admit(path, tenant=spec.name,
                                          priority=spec.priority, cost=cost)
                else:
                    adm = qos.NOOP_ADMISSION
                with adm:
                    latency = (self.backend.issue(t, cost)
                               + adm.throttle_s)
            except qos.QosRejected as e:
                self.stats["shed"] += 1
                pt["shed"] += 1
                if retries < self.max_retries:
                    # capped exponential client backoff on 429, as the
                    # SDK's RetryPolicy would apply over the hint
                    backoff = min(5.0, e.retry_after * (2 ** retries))
                    heapq.heappush(
                        heap, (t + backoff + self._exp(backoff / 2),
                               seq, cid, retries + 1))
                    seq += 1
                else:
                    # give up this request; client thinks, then moves on
                    self.stats["retries_exhausted"] += 1
                    heapq.heappush(
                        heap, (t + self._exp(spec.think_s), seq, cid, 0))
                    seq += 1
                continue
            self.stats["issued"] += 1
            pt["issued"] += 1
            pt["cost"] += cost
            measure.observe(spec.name, path, latency)
            if self.slo_hist is not None:
                self.slo_hist.observe(latency, path=path, stage="total")
            if self.rng.random() < spec.open_fraction:
                # open-loop: next arrival independent of completion
                nxt = t + self._exp(spec.think_s)
            else:
                nxt = t + latency + self._exp(spec.think_s)
            heapq.heappush(heap, (nxt, seq, cid, 0))
            seq += 1
        self.stats["digest"] = self.schedule_digest()
        self.stats["clients"] = self.n_clients
        self.stats["virtual_s"] = round(self.clock.now(), 6)
        return self.stats


# --------------------------------------------------- noisy-neighbor drill

VICTIM_SLO = slo.SloTarget(0.25, 0.999)  # blob.get: 250ms @ 99.9%


def noisy_neighbor_leg(seed: int, qos_on: bool, *,
                       victim_clients: int = 400,
                       bully_clients: int = 1600,
                       capacity: float = 2000.0,
                       bully_quota: float = 800.0,
                       duration_s: float = 30.0) -> dict:
    """One leg of the drill: a well-behaved read-mostly victim sharing
    the cluster with a bully saturating PUTs. Returns the victim's
    p99 vs its SLO budget, bully progress, shed counts, digest."""
    clock = FakeClock()
    hist = metrics.Histogram("loadgen_stage_seconds", "", ("path", "stage"))
    tracker = slo.SloTracker(hist=hist, clock=clock, window_s=2.0, windows=5)
    tracker.register("blob.get", VICTIM_SLO.target_s, VICTIM_SLO.objective)
    tracker.register("blob.put", 0.5, 0.999)
    gate = None
    if qos_on:
        gate = qos.QosGate(tracker=tracker, clock=clock, blocking=False,
                           max_inflight=100_000, refresh_s=0.5,
                           shaping_timeout=0.05)
        # quota config: the bully's PUT budget is 40% of capacity with
        # a quarter-second burst allowance (a full-second burst would
        # itself flood the shared FIFO past the victim's 250ms budget);
        # the victim is trusted (unconfigured => work-conserving)
        gate.configure("bully", rate=bully_quota, burst=bully_quota / 4)
    tenants = [
        TenantSpec("victim", victim_clients, think_s=1.0,
                   read_fraction=1.0, get_cost=1.0),
        TenantSpec("bully", bully_clients, think_s=0.2,
                   read_fraction=0.0, put_cost=8.0, open_fraction=0.25),
    ]
    model = LoadModel(tenants, seed=seed, clock=clock, gate=gate,
                      backend=SimBackend(capacity=capacity),
                      slo_hist=hist)
    stats = model.run(duration_s=duration_s, max_events=400_000)
    p99 = model.measure.quantile("victim", "blob.get", 0.99)
    return {
        "qos": "on" if qos_on else "off",
        "seed": seed,
        "digest": stats["digest"],
        "events": stats["events"],
        "victim": {
            "reads": model.measure.count("victim", "blob.get"),
            "p99_s": round(p99, 6),
            "slo_target_s": VICTIM_SLO.target_s,
            "within_budget": bool(p99 <= VICTIM_SLO.target_s),
        },
        "bully": {
            "issued": stats["per_tenant"]["bully"]["issued"],
            "shed": stats["per_tenant"]["bully"]["shed"],
            "cost_admitted": round(
                stats["per_tenant"]["bully"]["cost"], 1),
        },
        "shed_total": stats["shed"],
    }


def qos_ab(seed: int = 12, out: str | None = None) -> dict:
    """ABBA noisy-neighbor A/B: legs (on, off, off, on), same seed.
    QoS on must keep the victim within budget; off must violate it."""
    legs = [noisy_neighbor_leg(seed, on) for on in (True, False,
                                                    False, True)]
    on_legs = [r for r in legs if r["qos"] == "on"]
    off_legs = [r for r in legs if r["qos"] == "off"]
    result = {
        "bench": "QOS_AB",
        "seed": seed,
        "order": ["on", "off", "off", "on"],
        "legs": legs,
        "victim_slo": {"path": "blob.get",
                       "target_s": VICTIM_SLO.target_s,
                       "objective": VICTIM_SLO.objective},
        "qos_on_within_budget": all(
            r["victim"]["within_budget"] for r in on_legs),
        "qos_off_violates": all(
            not r["victim"]["within_budget"] for r in off_legs),
        "reproducible": (
            on_legs[0]["digest"] == on_legs[1]["digest"]
            and off_legs[0]["digest"] == off_legs[1]["digest"]),
    }
    if out:
        with open(out, "w") as f:
            json.dump(result, f, indent=2)
    return result


def scale_run(clients: int = 100_000, seed: int = 7,
              max_events: int = 150_000, duration_s: float = 5.0) -> dict:
    """The >=10^5-client determinism check: a large mixed fleet against
    an uncontended backend, digest-stable across runs of the same
    seed. No gate — this measures the model, not the policy."""
    tenants = [
        TenantSpec("web", int(clients * 0.6), think_s=30.0,
                   read_fraction=0.9, open_fraction=0.1),
        TenantSpec("batch", int(clients * 0.3), think_s=60.0,
                   read_fraction=0.2),
        TenantSpec("scan", clients - int(clients * 0.6)
                   - int(clients * 0.3), think_s=45.0, read_fraction=1.0),
    ]
    model = LoadModel(tenants, seed=seed,
                      backend=SimBackend(capacity=1e9, base_latency=0.001),
                      n_objects=65536)
    return model.run(duration_s=duration_s, max_events=max_events)


# --------------------------------------------------- wire mode (real bytes)
#
# The sim above models 10^6 clients on a fake clock; wire mode pushes
# REAL packet bytes from pinned worker processes at a real QoS-gated
# packet server, so the A/B artifacts can show the server — not the
# loadgen — as the bottleneck. The op schedule stays seeded: each
# client's k-th request (op, object, size) is a pure function of
# (seed, worker, client, k), so the planned stream digests identically
# run to run; wall-clock interleaving is real and therefore not part
# of the digest.

_WIRE_EDGES = (0.001, 0.002, 0.005, 0.01, 0.02, 0.05, 0.1, 0.15, 0.2,
               0.25, 0.35, 0.5, 0.75, 1.0, 1.5, 2.5, 4.0, 8.0)
_NB = len(_WIRE_EDGES) + 1
_CTR = 3  # issued, shed, errors — per (worker, pair)
_BURN_BUF = b"\xa5" * 65536
_PLAN_OPS = 4096  # per-client planned op-stream length (execution
                  # consumes a prefix; the digest covers the full plan)


def _burn(cost: float, unit_loops: int) -> None:
    """~`cost` cost-units of genuine CPU service work (crc32 sweeps —
    the checksum work a real datanode write path does)."""
    import zlib
    for _ in range(max(1, int(cost * unit_loops))):
        zlib.crc32(_BURN_BUF)


def _client_plan_rng(seed: int, widx: int, cid: int) -> random.Random:
    return random.Random((seed << 24) ^ (widx << 18) ^ cid)


def _plan_digest(seed: int, widx: int, clients: list[tuple[int, int]],
                 specs: list[TenantSpec]) -> str:
    """sha256 over the full planned op stream of this worker's clients,
    in (client, k) order — reproducible from the seed alone."""
    h = hashlib.sha256()
    for cid, tidx in clients:
        spec = specs[tidx]
        rng = _client_plan_rng(seed, widx, cid)
        for k in range(_PLAN_OPS):
            is_read = rng.random() < spec.read_fraction
            obj = rng.randrange(4096)
            h.update(f"{widx}|{cid}|{k}|{'get' if is_read else 'put'}"
                     f"|{obj}\n".encode())
    return h.hexdigest()


def _cores() -> list[int]:
    """The cores this process may run on, in order."""
    if not hasattr(os, "sched_getaffinity"):
        raise RuntimeError("loadgen --wire needs sched_getaffinity/sched_setaffinity")
    return sorted(os.sched_getaffinity(0))


def _pin_to_core(core: int) -> int:
    """Pin the calling process to the ``core``-th core it may run on
    (modulo their count); returns that core, or raises where the host
    refuses."""
    cores = _cores()
    pick = cores[core % len(cores)]
    try:
        os.sched_setaffinity(0, {pick})
    except OSError as e:
        raise RuntimeError(f"loadgen --wire: sched_setaffinity({{{pick}}}) refused: {e}") from e
    if os.sched_getaffinity(0) != {pick}:
        raise RuntimeError(f"loadgen --wire: pinned to {pick}, running on "
                           f"{sorted(os.sched_getaffinity(0))}")
    return pick


def _cpu_seconds() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


CHECK_HOST_DEADLINE_S = 5.0  # longest burn waiting for RUSAGE_SELF to move


def check_host() -> dict:
    """The wire mode's host calls, probed in this process: pin to the
    first allowed core, burn a little CPU, read it back from
    ``RUSAGE_SELF``, restore the affinity. Raises where either fails."""
    before = _cores()
    cpu0 = _cpu_seconds()
    deadline = time.monotonic() + CHECK_HOST_DEADLINE_S
    try:
        pinned = _pin_to_core(0)
        # a host may count CPU time in ticks (10 ms under gVisor), so
        # burn until one lands or the deadline passes
        while True:
            _burn(64.0, 4)
            used = _cpu_seconds() - cpu0
            if used > 0.0 or time.monotonic() > deadline:
                break
    finally:
        os.sched_setaffinity(0, set(before))
    if used <= 0.0:
        raise RuntimeError(f"loadgen --wire: RUSAGE_SELF reads no CPU time ({used})")
    return {"cores": before, "pinned": pinned, "rusage_cpu_s": used}


def _wire_server_main(ctrl, qos_on: bool, unit_loops: int,
                      bully_quota: float, slo_target_s: float,
                      resp_bytes: dict, core: int) -> None:
    """Server process: a real PacketServer whose handlers run per-tenant
    QoS admission and burn genuine CPU per cost unit. Reports its own
    rusage CPU over the control pipe at shutdown."""
    from ..utils import packet

    _pin_to_core(core)
    base_cpu = _cpu_seconds()
    hist = metrics.Histogram("wiregen_stage_seconds", "",
                             ("path", "stage"))
    tracker = slo.SloTracker(hist=hist, window_s=2.0, windows=5)
    tracker.register("blob.get", slo_target_s, 0.999)
    tracker.register("blob.put", 1.0, 0.999)
    gate = None
    if qos_on:
        gate = qos.QosGate(tracker=tracker, blocking=False,
                           max_inflight=100_000, refresh_s=0.5,
                           shaping_timeout=0.05)
        gate.configure("bully", rate=bully_quota, burst=bully_quota / 4)
    import threading

    counts = {"issued": 0, "shed": 0}
    lock = threading.Lock()
    resp_pool = _BURN_BUF * 4  # GET replies are slices of this

    def serve(path: str):
        def handler(hdr, args, payload):
            cost = float(args.get("cost", 1.0))
            tenant = args.get("tenant", "unknown")
            try:
                adm = (gate.admit(path, tenant=tenant, cost=cost)
                       if gate is not None else qos.NOOP_ADMISSION)
            except qos.QosRejected as e:
                with lock:
                    counts["shed"] += 1
                raise packet.PacketError(
                    packet.RESULT_RPC,
                    json.dumps({"retry_after": e.retry_after}),
                    code=429) from None
            with adm:
                if adm.throttle_s:
                    time.sleep(adm.throttle_s)
                _burn(cost, unit_loops)
            with lock:
                counts["issued"] += 1
            # end-to-end latency from the CLIENT's send stamp (same
            # host, shared clock): queue wait included, which is what
            # the burn-rate brownout logic must react to
            sent = args.get("t_sent")
            if sent is not None:
                hist.observe(max(0.0, time.time() - sent),
                             path=path, stage="total")
            n = min(int(args.get("resp", 0)), len(resp_pool))
            return {}, memoryview(resp_pool)[:n] if n else b""
        return handler

    srv = packet.PacketServer({
        packet.OP_READ: serve("blob.get"),
        packet.OP_WRITE: serve("blob.put"),
    }, service="wiregen").start()
    ctrl.send(srv.addr)
    ctrl.recv()  # block until the parent says stop
    srv.stop()
    ctrl.send({"cpu_s": _cpu_seconds() - base_cpu,
               "issued": counts["issued"], "shed": counts["shed"],
               "qos": "on" if qos_on else "off"})
    ctrl.close()


def _wire_worker_main(widx: int, core: int, addr: str, seed: int,
                      duration_s: float, clients: list[tuple[int, int]],
                      specs: list[TenantSpec], sizes: dict,
                      buckets, ctrs, cpus, digests, barrier,
                      max_retries: int = 8) -> None:
    """One loadgen worker process: drives its client population's
    seeded op streams over ONE mux connection (victim and bully frames
    interleave on the same wire), windowed in-flight, open/closed
    arrival mixing and capped 429 backoff carried over from the sim.
    Results land in the shared-memory arrays; no pickling on the way
    back."""
    from ..utils import packet

    _pin_to_core(core)
    base_cpu = _cpu_seconds()
    digest = _plan_digest(seed, widx, clients, specs)
    digests[widx * 64:(widx + 1) * 64] = digest.encode()
    trng = random.Random((seed << 8) ^ widx)  # timing only, not digested

    def exp(mean: float) -> float:
        return -mean * math.log(1.0 - trng.random()) if mean > 0 else 0.0

    npairs = len(specs) * 2

    def pair_idx(tidx: int, is_read: bool) -> int:
        return tidx * 2 + (0 if is_read else 1)

    def bucket(lat: float) -> int:
        return bisect.bisect_left(_WIRE_EDGES, lat)

    plans = {cid: _client_plan_rng(seed, widx, cid) for cid, _ in clients}
    next_k = {cid: 0 for cid, _ in clients}
    from ..sdk import WireClient
    cli = WireClient(addr, timeout=10.0)
    cap = len(clients) + 2 * packet.window_size()
    barrier.wait()
    t0 = time.monotonic()
    # heap: (due, seq, cid, tidx, op or None, retries) — op is carried
    # on 429 retries so a shed request retries ITSELF, not a fresh draw
    heap: list[tuple] = []
    seq = 0
    for cid, tidx in clients:
        heap.append((trng.random() * 0.2, seq, cid, tidx, None, 0))
        seq += 1
    heapq.heapify(heap)
    inflight: list = []  # [fut, t_submit, pair, cid, tidx, op, retries]

    def harvest(ent, block_s: float | None) -> bool:
        fut, ts, pair, cid, tidx, op, retries = ent
        nonlocal seq
        try:
            if block_s is not None:
                fut.result(block_s)
            elif not fut.done():
                return False
            else:
                fut.result(0)
            lat = time.monotonic() - ts
            base = (widx * npairs + pair) * _NB
            buckets[base + bucket(lat)] += 1
            ctrs[(widx * npairs + pair) * _CTR + 0] += 1
            spec = specs[tidx]
            now = time.monotonic() - t0
            if trng.random() < spec.open_fraction:
                due = (ts - t0) + exp(spec.think_s)
            else:
                due = now + exp(spec.think_s)
            heapq.heappush(heap, (due, seq, cid, tidx, None, 0))
            seq += 1
        except packet.PacketError as e:
            now = time.monotonic() - t0
            if e.code == 429:
                ctrs[(widx * npairs + pair) * _CTR + 1] += 1
                try:
                    ra = json.loads(e.message).get("retry_after", 0.5)
                except (ValueError, AttributeError):
                    ra = 0.5
                if retries < max_retries:
                    backoff = min(5.0, ra * (2 ** retries))
                    heapq.heappush(heap, (now + backoff + exp(backoff / 2),
                                          seq, cid, tidx, op, retries + 1))
                else:
                    heapq.heappush(heap, (now + exp(specs[tidx].think_s),
                                          seq, cid, tidx, None, 0))
                seq += 1
            else:
                ctrs[(widx * npairs + pair) * _CTR + 2] += 1
                heapq.heappush(heap, (now + exp(specs[tidx].think_s),
                                      seq, cid, tidx, None, 0))
                seq += 1
        except (ConnectionError, OSError, TimeoutError):
            ctrs[(widx * npairs + pair) * _CTR + 2] += 1
        return True

    try:
        while True:
            now = time.monotonic() - t0
            if now >= duration_s:
                break
            while (heap and heap[0][0] <= now and len(inflight) < cap):
                _, _, cid, tidx, op, retries = heapq.heappop(heap)
                spec = specs[tidx]
                if op is None:
                    rng = plans[cid]
                    # k-th planned draw for this client (digested above)
                    is_read = rng.random() < spec.read_fraction
                    obj = rng.randrange(4096)
                    next_k[cid] += 1
                    op = ("get" if is_read else "put", obj)
                is_read = op[0] == "get"
                pair = pair_idx(tidx, is_read)
                name, size = (("blob.get", sizes.get("get_bytes", 8192))
                              if is_read else
                              ("blob.put", sizes.get("put_bytes", 65536)))
                args = {"tenant": spec.name,
                        "cost": spec.get_cost if is_read else spec.put_cost,
                        "t_sent": time.time()}
                payload = b""
                if is_read:
                    args["resp"] = size
                else:
                    payload = _BURN_BUF * (size // len(_BURN_BUF) + 1)
                    payload = payload[:size]
                try:
                    fut = cli.call_async(
                        packet.OP_READ if is_read else packet.OP_WRITE,
                        extent=op[1], args=args, payload=payload,
                        idempotent=False)
                except (ConnectionError, OSError):
                    ctrs[(widx * npairs + pair) * _CTR + 2] += 1
                    continue
                inflight.append([fut, time.monotonic(), pair, cid, tidx,
                                 op, retries])
            # reap whatever has completed, oldest first
            inflight = [e for e in inflight if not harvest(e, None)]
            if not inflight and heap:
                time.sleep(min(0.005, max(0.0, heap[0][0] - now)))
            elif inflight:
                time.sleep(0.001)
            elif not heap:
                break
        for ent in inflight:  # drain: bounded grace per in-flight op
            harvest(ent, 3.0)
    finally:
        cli.close()
        cpus[widx] = _cpu_seconds() - base_cpu


def _wire_quantile(buckets, widx_range, pair: int, npairs: int,
                   q: float) -> float:
    """Approximate quantile (upper bucket edge) from the shared counts."""
    counts = [0] * _NB
    for w in widx_range:
        base = (w * npairs + pair) * _NB
        for b in range(_NB):
            counts[b] += buckets[base + b]
    total = sum(counts)
    if not total:
        return 0.0
    acc = 0
    for b, c in enumerate(counts):
        acc += c
        if acc / total >= q:
            return _WIRE_EDGES[b] if b < len(_WIRE_EDGES) else float("inf")
    return float("inf")


def wire_brownout_leg(seed: int, qos_on: bool, *,
                      duration_s: float = 6.0,
                      workers: int | None = None,
                      victim_clients: int = 12,
                      bully_clients: int = 32,
                      unit_loops: int = 12,
                      bully_quota: float = 250.0) -> dict:
    """One REAL-BYTES noisy-neighbor leg over the mux wire: victim and
    bully streams share worker mux connections into a QoS-gated packet
    server that burns genuine CPU per cost unit. Returns the same shape
    of evidence as the simulated leg, plus per-process CPU seconds."""
    ncores = len(_cores())  # the cores this process may run on
    nworkers = workers if workers is not None else max(1, min(ncores, 4))
    specs = [
        TenantSpec("victim", victim_clients, think_s=0.15,
                   read_fraction=1.0, get_cost=1.0),
        TenantSpec("bully", bully_clients, think_s=0.02,
                   read_fraction=0.0, put_cost=16.0, open_fraction=0.3),
    ]
    sizes = {"get_bytes": 8192, "put_bytes": 65536}
    ctx = mp.get_context("fork")
    ctrl, srv_end = ctx.Pipe()
    srv_proc = ctx.Process(
        target=_wire_server_main,
        args=(srv_end, qos_on, unit_loops, bully_quota,
              VICTIM_SLO.target_s, sizes, 0),
        daemon=True)
    srv_proc.start()
    addr = ctrl.recv()
    npairs = len(specs) * 2
    buckets = ctx.Array(ctypes.c_uint64, nworkers * npairs * _NB,
                        lock=False)
    ctrs = ctx.Array(ctypes.c_uint64, nworkers * npairs * _CTR,
                     lock=False)
    cpus = ctx.Array(ctypes.c_double, nworkers, lock=False)
    digests = ctx.Array(ctypes.c_char, nworkers * 64, lock=False)
    barrier = ctx.Barrier(nworkers)
    # contiguous client ids; each tenant's population split round-robin
    # across workers so every mux connection carries BOTH tenants'
    # frames — the isolation claim is about streams, not sockets
    assign: list[list[tuple[int, int]]] = [[] for _ in range(nworkers)]
    cid = 0
    for tidx, spec in enumerate(specs):
        for _ in range(spec.clients):
            assign[cid % nworkers].append((cid, tidx))
            cid += 1
    procs = []
    for w in range(nworkers):
        p = ctx.Process(
            target=_wire_worker_main,
            args=(w, w % ncores, addr, seed, duration_s, assign[w],
                  specs, sizes, buckets, ctrs, cpus, digests, barrier),
            daemon=True)
        p.start()
        procs.append(p)
    for p in procs:
        p.join(timeout=duration_s + 30.0)
    ctrl.send("stop")
    server_stats = ctrl.recv()
    srv_proc.join(timeout=10.0)
    wdigests = sorted(bytes(digests[w * 64:(w + 1) * 64]).decode()
                      for w in range(nworkers))
    combined = hashlib.sha256("".join(wdigests).encode()).hexdigest()

    def pair_tot(pair: int, slot: int) -> int:
        return sum(ctrs[(w * npairs + pair) * _CTR + slot]
                   for w in range(nworkers))

    p99 = _wire_quantile(buckets, range(nworkers), 0, npairs, 0.99)
    return {
        "qos": "on" if qos_on else "off",
        "seed": seed,
        "digest": combined,
        "workers": nworkers,
        "cores": ncores,
        "worker_cpu_s": [round(cpus[w], 3) for w in range(nworkers)],
        "server_cpu_s": round(server_stats["cpu_s"], 3),
        "server_is_bottleneck": bool(
            server_stats["cpu_s"] > max(cpus[:] or [0.0])),
        "victim": {
            "reads": pair_tot(0, 0),
            "errors": pair_tot(0, 2),
            "p99_s": p99,
            "slo_target_s": VICTIM_SLO.target_s,
            "within_budget": bool(p99 <= VICTIM_SLO.target_s),
        },
        "bully": {
            "issued": pair_tot(3, 0),
            "shed": pair_tot(3, 1),
            "errors": pair_tot(3, 2),
        },
        "server": {"issued": server_stats["issued"],
                   "shed": server_stats["shed"]},
    }


def wire_qos_ab(seed: int = 17, out: str | None = None,
                duration_s: float = 6.0,
                workers: int | None = None) -> dict:
    """The brownout acceptance run: ABBA (on, off, off, on)
    real-bytes legs over the mux wire. Same seed => same planned
    schedule digest every leg (the plan is door-independent); QoS on
    must hold the victim within budget while the bully is shed."""
    from ..utils import packet

    legs = [wire_brownout_leg(seed, on, duration_s=duration_s,
                              workers=workers)
            for on in (True, False, False, True)]
    on_legs = [r for r in legs if r["qos"] == "on"]
    off_legs = [r for r in legs if r["qos"] == "off"]
    result = {
        "bench": "WIRE_QOS_AB",
        "seed": seed,
        "order": ["on", "off", "off", "on"],
        "transport": ("packet-mux" if packet.mux_enabled()
                      else "packet-serial"),
        "legs": legs,
        "victim_slo": {"path": "blob.get",
                       "target_s": VICTIM_SLO.target_s,
                       "objective": VICTIM_SLO.objective},
        "qos_on_within_budget": all(
            r["victim"]["within_budget"] for r in on_legs),
        "qos_off_violates": all(
            not r["victim"]["within_budget"] for r in off_legs),
        "reproducible": len({r["digest"] for r in legs}) == 1,
        "server_is_bottleneck": all(
            r["server_is_bottleneck"] for r in legs),
    }
    if out:
        with open(out, "w") as f:
            json.dump(result, f, indent=2)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="deterministic closed-loop traffic model / QoS drills")
    ap.add_argument("--qos-ab", action="store_true",
                    help="run the ABBA noisy-neighbor drill")
    ap.add_argument("--scale", type=int, default=0, metavar="CLIENTS",
                    help="run a CLIENTS-sized determinism check")
    ap.add_argument("--wire", action="store_true",
                    help="run the REAL-BYTES brownout ABBA over the "
                         "mux packet wire (multi-process)")
    ap.add_argument("--workers", type=int, default=None,
                    help="wire mode: loadgen worker processes "
                         "(default: one per core, max 4)")
    ap.add_argument("--duration", type=float, default=6.0,
                    help="wire mode: seconds per leg")
    ap.add_argument("--check-host", action="store_true",
                    help="probe sched_setaffinity and RUSAGE_SELF, which "
                         "--wire needs, and exit")
    ap.add_argument("--seed", type=int, default=12)
    ap.add_argument("--out", default=None, help="write JSON artifact here")
    args = ap.parse_args(argv)
    if args.check_host:
        print(json.dumps(check_host()))
        return 0
    if args.wire:
        result = wire_qos_ab(seed=args.seed, out=args.out,
                             duration_s=args.duration,
                             workers=args.workers)
        print(json.dumps(result, indent=2))
        return 0 if (result["qos_on_within_budget"]
                     and result["qos_off_violates"]
                     and result["reproducible"]) else 1
    if args.qos_ab:
        result = qos_ab(seed=args.seed, out=args.out)
        print(json.dumps(result, indent=2))
        return 0 if (result["qos_on_within_budget"]
                     and result["qos_off_violates"]
                     and result["reproducible"]) else 1
    if args.scale:
        stats = scale_run(clients=args.scale, seed=args.seed)
        print(json.dumps({k: v for k, v in stats.items()
                          if k != "per_tenant"}, indent=2))
        return 0
    ap.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
