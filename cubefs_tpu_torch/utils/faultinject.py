"""Deterministic, seeded chaos layer for the RPC transport.

The port's copy of ``cubefs_tpu/utils/faultinject.py``. Role parity:
blobstore/testing/dial's live prober and the per-disk fault hooks on
BlobNode, generalized: one ``FaultPlan`` describes every fault a
scenario injects — transport drops, delays, 5xx brownouts, CRC-corrupt
bodies, stale keep-alive sockets, duplicate delivery, symmetric and
one-way network partitions, seeded WAN latency edges, broken disks and
at-rest rot — keyed by ``(addr, method, invocation_index)`` so the
schedule is a pure function of the seed and the call sequence: the same
seed and the same calls give the reference's ``schedule_digest()``.

Hook: ``utils.rpc`` consults a single module-level ``rpc._fault``
reference (installed/uninstalled here).  When no plan is installed the
hot path pays exactly one ``is not None`` check — no allocations, no
locks. The blob plane reads the same plan: ``BlobNode._disk_down``
(broken disks), its ``rpc_put_shard`` (a rewrite heals planted rot) and
``chunkstore.verified_get_shard`` (at-rest rot surfaces as a CRC
mismatch). Raft declares its sender identity with ``sender()`` so
partitions cut both directions.

The star fault is **drop-after-execute**: the peer fully processed the
request but the reply is lost, which is precisely the situation the
rpc.call IDEMPOTENCY CONTRACT exists for — the client's retry must be
deduped server-side via ``op_id`` (utils/fsm.py ReplicatedFsm).
``duplicate`` delivers the same request twice on one call, proving the
dedup door replays instead of re-executing.

Smoke demo: ``python -m cubefs_tpu_torch.utils.faultinject --demo``.
"""

from __future__ import annotations

import argparse
import contextlib
import contextvars
import dataclasses
import hashlib
import threading

from . import metrics
from . import rpc
from . import trace as tracelib
from .retry import Clock, MONOTONIC

_NULL_CTX = contextlib.nullcontext()

# identity of the calling node (e.g. a raft peer) for sender-side
# partition checks; None for anonymous clients
_SENDER: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "faultinject_sender", default=None)

KINDS = ("drop_before", "drop_after", "delay", "error", "corrupt",
         "stale", "duplicate", "wan")

# at-rest faults: data already ON DISK goes bad, keyed like disk faults
# by (node_addr, disk_id) plus a unit key naming the payload —
# "dp{dp}:e{eid}" for datanode extents, "c{chunk}:b{bid}" for blobnode
# shards. All three manifest at the verifying read helper as a CRC
# mismatch (that is the point: the CRC door catches every flavor), but
# the planted kind names WHAT went bad for the schedule/digest:
#   bitflip    — payload bytes flipped under a correct-looking CRC table
#   torn_write — the tail of the payload never made it to the platter
#   stale_crc  — the payload is fine but the stored CRC lies
AT_REST_KINDS = ("bitflip", "torn_write", "stale_crc")


class InjectedCrash(Exception):
    """Raised by FaultPlan.gate() at an in-process fault point — models
    a process kill at that exact spot (the lcnode chaos drill arms these
    at migration phase boundaries). Deliberately NOT an RpcError: no
    retry layer may swallow it."""


@dataclasses.dataclass
class Rule:
    """One fault rule; matched in plan order, first terminal rule wins."""
    addr: str = "*"
    method: str = "*"
    kind: str = "drop_before"
    after: int = 0            # skip the first N matching invocations
    times: int | None = None  # max injections (None = unlimited)
    every: int = 1            # then inject every Nth matching invocation
    prob: float | None = None  # seeded per-invocation probability
    delay: float = 0.0        # seconds, kind in ("delay", "wan")
    jitter: float = 0.0       # extra seconds, seeded draw, delay/wan
    code: int = 503           # kind == "error"
    message: str | None = None
    src: str = "*"            # sender identity filter (kind == "wan":
    #                           a WAN edge is keyed (src, dst); senders
    #                           declare identity via sender())
    hits: int = 0

    def matches_site(self, addr: str, method: str,
                     sender: str | None = None) -> bool:
        return (self.addr in ("*", addr)
                and self.method in ("*", method)
                and (self.src == "*" or self.src == sender))


class FaultPlan:
    """A seeded schedule of faults; install() hooks it into utils.rpc.

    Same seed + same (single-threaded) call sequence => byte-identical
    schedule: every injected fault is appended to ``self.log`` and
    ``schedule_digest()`` hashes it.  Probabilistic rules and delay
    jitter draw from sha256(seed, addr, method, index) — no global RNG
    state, no ordering sensitivity across sites.
    """

    def __init__(self, seed: int = 0, clock: Clock = MONOTONIC):
        self.seed = seed
        self.clock = clock
        self.rules: list[Rule] = []
        self.log: list[tuple] = []
        self._counters: dict[tuple[str, str], int] = {}
        self._lock = threading.Lock()
        self._partitions: list[tuple[frozenset, frozenset]] = []
        self._oneway: list[tuple[frozenset, frozenset]] = []
        self._isolated: set[str] = set()
        self._broken_disks: set[tuple[str, int]] = set()
        # (node_addr, disk_id, unit) -> at-rest fault kind
        self._at_rest: dict[tuple[str, int, str], str] = {}

    # ---- authoring ----
    def on(self, addr: str = "*", method: str = "*",
           kind: str = "drop_before", **kw) -> "FaultPlan":
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; one of {KINDS}")
        self.rules.append(Rule(addr=addr, method=method, kind=kind, **kw))
        return self

    def isolate(self, *addrs: str) -> "FaultPlan":
        """Cut the given addrs off from everyone (both directions for
        senders that declare identity via sender())."""
        with self._lock:
            self._isolated.update(addrs)
        return self

    def partition(self, group_a, group_b) -> "FaultPlan":
        """Symmetric partition: traffic between the two groups drops.
        Sender-side enforcement needs sender() identity (raft declares
        it); anonymous client traffic is only checked by destination."""
        with self._lock:
            self._partitions.append((frozenset(group_a), frozenset(group_b)))
        return self

    def partition_oneway(self, src_group, dst_group) -> "FaultPlan":
        """Asymmetric partition: traffic FROM src_group TO dst_group
        drops; the reverse direction flows. Models a region that can
        hear but not be heard — the split-brain-inducing case geo
        fencing epochs must survive. Enforcement requires sender()
        identity on the src side (the geo pump and raft declare it);
        anonymous senders are never in src_group."""
        with self._lock:
            self._oneway.append((frozenset(src_group), frozenset(dst_group)))
        return self

    def wan(self, group_a, group_b, delay: float = 0.001,
            jitter: float = 0.0002) -> "FaultPlan":
        """Seeded WAN emulation between two regions: every rpc crossing
        the (src, dst) edge in either direction pays `delay` plus a
        seeded jitter draw. A distinct fault kind ("wan") so the
        schedule digest distinguishes geography from injected delay
        faults. Needs sender() identity, like one-way partitions."""
        for src, dst in [(group_a, group_b), (group_b, group_a)]:
            for s in src:
                for d in dst:
                    self.rules.append(Rule(addr=d, src=s, kind="wan",
                                           delay=delay, jitter=jitter))
        return self

    def heal(self) -> "FaultPlan":
        with self._lock:
            self._partitions.clear()
            self._oneway.clear()
            self._isolated.clear()
        return self

    # ---- disk faults (unifies BlobNode.break_disk under the plan) ----
    def break_disk(self, node_addr: str, disk_id: int) -> "FaultPlan":
        with self._lock:
            self._broken_disks.add((str(node_addr), int(disk_id)))
        return self

    def heal_disk(self, node_addr: str, disk_id: int) -> "FaultPlan":
        with self._lock:
            self._broken_disks.discard((str(node_addr), int(disk_id)))
        return self

    def disk_broken(self, node_addr: str, disk_id: int) -> bool:
        key = (str(node_addr), int(disk_id))
        with self._lock:
            return key in self._broken_disks or ("*", int(disk_id)) in self._broken_disks

    # ---- at-rest faults (bit-rot on stored payloads) ----
    def plant_rot(self, node_addr: str, disk_id: int, unit: str,
                  kind: str = "bitflip") -> "FaultPlan":
        """Corrupt one at-rest payload: subsequent verified reads of
        `unit` on (node_addr, disk_id) surface a CRC mismatch until a
        rewrite of that unit heals it (heal_rot). Planted faults land in
        the schedule/digest like transport faults."""
        if kind not in AT_REST_KINDS:
            raise ValueError(
                f"unknown at-rest kind {kind!r}; one of {AT_REST_KINDS}")
        key = (str(node_addr), int(disk_id), str(unit))
        with self._lock:
            self._at_rest[key] = kind
            self._log(kind, key[0], f"at_rest:{unit}", key[1])
        return self

    def heal_rot(self, node_addr: str, disk_id: int, unit: str) -> bool:
        """A rewrite of the unit landed: clear its planted rot. Returns
        whether rot was actually present — the store wrappers use this
        to count a HEAL, so a rewrite of a clean unit (which would be a
        false repair) never inflates the healed counter."""
        key = (str(node_addr), int(disk_id), str(unit))
        with self._lock:
            kind = self._at_rest.pop(key, None)
            if kind is not None:
                self._log("rot_healed", key[0], f"at_rest:{unit}", key[1])
            return kind is not None

    def at_rest_fault(self, node_addr: str, disk_id: int,
                      unit: str) -> str | None:
        key = (str(node_addr), int(disk_id), str(unit))
        with self._lock:
            return (self._at_rest.get(key)
                    or self._at_rest.get(("*", int(disk_id), str(unit))))

    def rot_remaining(self) -> int:
        """Planted at-rest faults not yet healed (the chaos drill's
        '100% healed' assertion is rot_remaining() == 0)."""
        with self._lock:
            return len(self._at_rest)

    # ---- determinism ----
    def _draw(self, addr: str, method: str, index: int, salt: str) -> float:
        h = hashlib.sha256(
            f"{self.seed}:{salt}:{addr}:{method}:{index}".encode()).digest()
        return int.from_bytes(h[:8], "big") / 2.0 ** 64

    def schedule(self) -> list[tuple]:
        with self._lock:
            return list(self.log)

    def schedule_digest(self) -> str:
        """sha256 over the injected-fault log; equal across runs with
        the same seed and call sequence (acceptance criterion).  Only
        the first five fields are hashed: field 5 is the active trace
        id (forensics — which request ate this fault), and trace ids
        are random per run, so they must never perturb the digest."""
        h = hashlib.sha256()
        for entry in self.schedule():
            h.update(repr(entry[:5]).encode())
        return h.hexdigest()

    # ---- decision engine ----
    def _log(self, kind: str, addr: str, method: str, index: int) -> None:
        # caller holds self._lock
        span = tracelib.current()
        tid = span.trace_id if span is not None else ""
        self.log.append((len(self.log), kind, addr, method, index, tid))
        metrics.faults_injected.inc(kind=kind)

    def _check_partition(self, addr: str, method: str) -> None:
        src = _SENDER.get()
        with self._lock:
            cut = None
            if addr in self._isolated and src != addr:
                cut = "partition"
            elif src is not None:
                if src in self._isolated and addr != src:
                    cut = "partition"
                else:
                    for a, b in self._partitions:
                        if ((src in a and addr in b)
                                or (src in b and addr in a)):
                            cut = "partition"
                            break
                    if cut is None:
                        for a, b in self._oneway:
                            if src in a and addr in b:
                                cut = "partition_oneway"
                                break
            if cut:
                idx = self._counters.get((addr, method), 0)
                self._log(cut, addr, method, idx)
        if cut:
            raise rpc.ServiceUnavailable(
                503, f"{addr}/{method}: injected network partition "
                     f"(from {src or 'anonymous'})")

    def _decide(self, addr: str, method: str) -> Rule | None:
        sender_ = _SENDER.get()
        with self._lock:
            idx = self._counters.get((addr, method), 0)
            self._counters[(addr, method)] = idx + 1
            for rule in self.rules:
                if not rule.matches_site(addr, method, sender_):
                    continue
                if idx < rule.after:
                    continue
                if rule.every > 1 and (idx - rule.after) % rule.every:
                    continue
                if rule.times is not None and rule.hits >= rule.times:
                    continue
                if (rule.prob is not None
                        and self._draw(addr, method, idx, "prob") >= rule.prob):
                    continue
                rule.hits += 1
                self._log(rule.kind, addr, method, idx)
                return rule
        return None

    def _sleep_for(self, rule: Rule, addr: str, method: str) -> None:
        extra = 0.0
        if rule.jitter:
            extra = rule.jitter * self._draw(addr, method, rule.hits, "jitter")
        self.clock.sleep(rule.delay + extra)

    # ---- transport hooks (called from utils.rpc) ----
    def around_http(self, addr, method, args, body, timeout, inner):
        """Wrap one HTTP rpc.call attempt. `inner` is rpc._http_call."""
        self._check_partition(addr, method)
        rule = self._decide(addr, method)
        if rule is None:
            return inner(addr, method, args, body, timeout)
        k = rule.kind
        if k in ("delay", "wan"):
            self._sleep_for(rule, addr, method)
            return inner(addr, method, args, body, timeout)
        if k == "drop_before":
            raise rpc.ServiceUnavailable(
                503, f"{addr}/{method}: injected drop-before-send")
        if k == "error":
            raise rpc.RpcError(
                rule.code,
                rule.message or f"{addr}/{method}: injected {rule.code}")
        if k == "corrupt":
            # really corrupt the wire body; the server's CRC door rejects
            return inner(addr, method, args, body, timeout, _corrupt=True)
        if k == "stale":
            # kill pooled idle sockets so the reuse path hits a genuinely
            # dead connection and exercises the fresh-connection retry
            return inner(addr, method, args, body, timeout, _stale=True)
        if k == "duplicate":
            inner(addr, method, args, body, timeout)  # first reply dropped
            return inner(addr, method, args, body, timeout)
        # drop_after: the peer executed, the reply is lost
        inner(addr, method, args, body, timeout)
        raise rpc.ServiceUnavailable(
            503, f"{addr}/{method}: injected drop-after-execute "
                 f"(reply lost; retry must dedup via op_id)")

    def around_direct(self, addr, method, invoke):
        """Wrap one in-process Client.call dispatch. `invoke` runs the
        handler and returns the normalized (reply, body) pair."""
        self._check_partition(addr, method)
        rule = self._decide(addr, method)
        if rule is None:
            return invoke()
        k = rule.kind
        if k in ("delay", "wan"):
            self._sleep_for(rule, addr, method)
            return invoke()
        if k == "drop_before":
            raise rpc.ServiceUnavailable(
                503, f"{addr}/{method}: injected drop-before-send")
        if k == "error":
            raise rpc.RpcError(
                rule.code,
                rule.message or f"{addr}/{method}: injected {rule.code}")
        if k == "corrupt":
            # mirror RpcServer's CRC rejection without executing
            raise rpc.RpcError(
                400, f"request body crc mismatch (injected on "
                     f"{addr}/{method})")
        if k in ("duplicate", "stale"):
            invoke()          # first delivery; reply discarded
            return invoke()   # duplicate delivery — dedup door must replay
        # drop_after
        invoke()
        raise rpc.ServiceUnavailable(
            503, f"{addr}/{method}: injected drop-after-execute "
                 f"(reply lost; retry must dedup via op_id)")

    def wire_frame(self, addr: str, op: str) -> str | None:
        """Per-FRAME hook for the binary mux plane (packet.py _MuxConn):
        frames are keyed method=``frame_<op>`` so plans target them
        independently of the rpc-level hooks, and every injection lands
        in the same schedule/digest. ``delay`` sleeps here; ``corrupt``
        / ``drop_before`` / ``drop_after`` are returned for the
        transport to apply at the byte level (flip a chunk byte under
        its already-computed CRC, or sever the connection before/after
        the frame leaves)."""
        method = f"frame_{op}"
        rule = self._decide(addr, method)
        if rule is None:
            return None
        if rule.kind in ("delay", "wan"):
            self._sleep_for(rule, addr, method)
            return None
        if rule.kind in ("drop_before", "drop_after", "corrupt"):
            return rule.kind
        return None

    # ---- in-process fault points (non-RPC) ----
    def gate(self, addr: str, method: str) -> None:
        """One named in-process fault point — code that wants to be
        killable mid-sequence (the tiering engine's phase boundaries)
        calls ``plan.gate("lcnode", "phase:prepared")`` between durable
        steps. Matching rules flow through the same seeded decision
        engine and land in the same schedule/digest as transport
        faults; `delay` sleeps, every other kind raises InjectedCrash
        (a simulated process kill at exactly that boundary)."""
        rule = self._decide(addr, method)
        if rule is None:
            return
        if rule.kind in ("delay", "wan"):
            self._sleep_for(rule, addr, method)
            return
        raise InjectedCrash(
            f"{addr}/{method}: injected {rule.kind} (process killed "
            f"at this phase boundary)")


# ---------------- install / sender identity ----------------

_PLAN: FaultPlan | None = None


def install(plan: FaultPlan) -> FaultPlan:
    """Hook the plan into utils.rpc (module-level, all transports)."""
    global _PLAN
    _PLAN = plan
    rpc._fault = plan
    return plan


def uninstall() -> None:
    global _PLAN
    _PLAN = None
    rpc._fault = None


def current() -> FaultPlan | None:
    return _PLAN


def gate(addr: str, method: str) -> None:
    """Module-level fault point: no-op (one None check) without an
    installed plan, so production code can sprinkle these freely."""
    if _PLAN is not None:
        _PLAN.gate(addr, method)


@contextlib.contextmanager
def installed(plan: FaultPlan):
    install(plan)
    try:
        yield plan
    finally:
        uninstall()


def sender(addr: str | None):
    """Declare the caller's identity for sender-side partition checks.
    Returns a shared no-op context when no plan is installed (raft wraps
    every outbound RPC with this; it must cost nothing in production)."""
    if _PLAN is None or addr is None:
        return _NULL_CTX
    return _SenderCtx(addr)


class _SenderCtx:
    __slots__ = ("addr", "_token")

    def __init__(self, addr: str):
        self.addr = addr

    def __enter__(self):
        self._token = _SENDER.set(self.addr)
        return self

    def __exit__(self, *exc):
        _SENDER.reset(self._token)
        return False


# ---------------- demo ----------------

def _demo() -> int:
    """Self-contained smoke: a toy alloc service with an op_id dedup
    door, hit by duplicate delivery and drop-after-execute."""
    from .retry import RetryPolicy

    class ToyAlloc:
        def __init__(self):
            self.next_id = 0
            self.cache = {}

        def rpc_alloc(self, args, body):
            op = args["op_id"]
            if op in self.cache:  # dedup door: replay, don't re-mint
                return {"id": self.cache[op], "replayed": True}
            self.cache[op] = self.next_id
            self.next_id += 1
            return {"id": self.cache[op], "replayed": False}

    pool = rpc.NodePool()
    pool.bind("toy", ToyAlloc())
    plan = FaultPlan(seed=42)
    plan.on("toy", "alloc", kind="duplicate", times=1)
    plan.on("toy", "alloc", kind="drop_after", times=1)
    policy = RetryPolicy(base=0.001, cap=0.002, deadline=1.0, seed=42)

    with installed(plan):
        client = pool.get("toy")
        # call 1: delivered twice by the plan; dedup door replays
        reply, _ = client.call("alloc", {"op_id": "op-1"})
        print(f"duplicate delivery  -> id={reply['id']} "
              f"replayed={reply['replayed']} (exactly-once)")
        # call 2: executes server-side, reply lost; retry with SAME op_id
        r = policy.start(op="alloc")
        while True:
            try:
                reply, _ = client.call("alloc", {"op_id": "op-2"})
                break
            except rpc.ServiceUnavailable:
                if not r.tick(reason="drop-after"):
                    raise
        print(f"drop-after-execute -> id={reply['id']} "
              f"replayed={reply['replayed']} (retry deduped via op_id)")

    print("\nfault schedule (seed=42):")
    for entry in plan.schedule():
        print(f"  {entry}")
    print(f"schedule digest: {plan.schedule_digest()}")
    assert reply["replayed"], "drop-after retry should have been deduped"
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cubefs_tpu_torch.utils.faultinject",
        description="deterministic chaos harness for the RPC transport")
    ap.add_argument("--demo", action="store_true",
                    help="run the self-contained dedup-under-chaos demo")
    args = ap.parse_args(argv)
    if args.demo:
        return _demo()
    ap.print_help()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
