"""Metrics: a Prometheus-style registry and its text exposition.

The port's trimmed copy of ``cubefs_tpu/utils/metrics.py``: the
registry, its three metric types and the families of the codec plane
under the reference's names, labels and buckets (the RPC transport,
``codec_bytes``, the batcher's ``codec_batch_*`` and the rows cache's
``codec_program_cache*``), and those of the blob plane and its
utilities (repair, placement, QoS, SLO, tracing, integrity, disk
health), the chaos harness's ``faults_injected`` and raft's
``raft_*`` series, and the file-system plane's (metanode group commit
and the client's fan-out, placement, the packet plane, tiering and the
lifecycle scan, the flash read tier, the elastic metadata plane and
geo-replication). Any RPC server mounts ``render_text()`` at
``GET /metrics``. Left out: the dp-split family (the port's batcher has
no dp split).

Added here: ``cubefs_codec_kernel_launches_total``, the launches of each
CUDA kernel, counted where ``ops/_build.launch`` counts them.
"""

from __future__ import annotations

import bisect
import threading
import time


class _Metric:
    def __init__(self, name: str, help_: str, labels: tuple[str, ...]):
        self.name = name
        self.help = help_
        self.label_names = labels
        self._series: dict[tuple, object] = {}
        self._lock = threading.Lock()

    def _key(self, labels: dict) -> tuple:
        return tuple(str(labels.get(k, "")) for k in self.label_names)


class Counter(_Metric):
    TYPE = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            self._series[k] = self._series.get(k, 0.0) + value

    def value(self, **labels) -> float:
        with self._lock:
            return self._series.get(self._key(labels), 0.0)

    def samples(self):
        with self._lock:
            return list(self._series.items())


class Gauge(Counter):
    TYPE = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[self._key(labels)] = float(value)


class Histogram(_Metric):
    TYPE = "histogram"
    BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 60)

    def __init__(self, name, help_, labels, buckets=None):
        super().__init__(name, help_, labels)
        # latency series keep the class default, count-shaped ones
        # (stripes per step) pass integer bounds
        self.BUCKETS = tuple(buckets) if buckets is not None else self.BUCKETS

    def observe(self, value: float, **labels) -> None:
        self.observe_many((value,), **labels)

    def observe_many(self, values, **labels) -> None:
        """Record several samples under one lock acquisition (the waits
        of every submission of one drained step)."""
        if not values:
            return
        k = self._key(labels)
        with self._lock:
            s = self._series.get(k)
            if s is None:
                s = self._series[k] = {"count": 0, "sum": 0.0,
                                       "buckets": [0] * len(self.BUCKETS)}
            for value in values:
                s["count"] += 1
                s["sum"] += value
                for j in range(bisect.bisect_left(self.BUCKETS, value), len(self.BUCKETS)):
                    s["buckets"][j] += 1

    def time(self, **labels):
        """A context manager observing the wall seconds of its block (the
        dial prober's per-leg latency)."""
        metric = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                metric.observe(time.perf_counter() - self.t0, **labels)

        return _Timer()

    def samples(self):
        with self._lock:
            return [(k, dict(v, buckets=list(v["buckets"]))) for k, v in self._series.items()]


class Registry:
    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name, help_, labels, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help_, tuple(labels), **kw)
            return m

    def counter(self, name, help_="", labels=()) -> Counter:
        return self._get(Counter, name, help_, labels)

    def gauge(self, name, help_="", labels=()) -> Gauge:
        return self._get(Gauge, name, help_, labels)

    def histogram(self, name, help_="", labels=(), buckets=None) -> Histogram:
        return self._get(Histogram, name, help_, labels, buckets=buckets)

    def render_text(self) -> str:
        """Prometheus exposition format."""
        out = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            out.append(f"# HELP {m.name} {m.help}")
            out.append(f"# TYPE {m.name} {m.TYPE}")
            if isinstance(m, Histogram):
                for k, s in m.samples():
                    lbl = _labels(m.label_names, k)
                    for bound, cum in zip(m.BUCKETS, s["buckets"]):
                        le = _labels(m.label_names + ("le",), k + (str(bound),))
                        out.append(f"{m.name}_bucket{le} {cum}")
                    inf = _labels(m.label_names + ("le",), k + ("+Inf",))
                    out.append(f"{m.name}_bucket{inf} {s['count']}")
                    out.append(f"{m.name}_sum{lbl} {s['sum']}")
                    out.append(f"{m.name}_count{lbl} {s['count']}")
            else:
                for k, v in m.samples():
                    out.append(f"{m.name}{_labels(m.label_names, k)} {v}")
        return "\n".join(out) + "\n"


def _labels(names, values) -> str:
    if not names:
        return ""
    return "{" + ",".join(f'{n}="{v}"' for n, v in zip(names, values)) + "}"


DEFAULT = Registry()


def render_text() -> str:
    """The process-wide registry in Prometheus text."""
    return DEFAULT.render_text()


# the RPC transport and the codec service
rpc_requests = DEFAULT.counter("cubefs_rpc_requests_total",
                               "RPC requests served", ("method", "code"))
rpc_latency = DEFAULT.histogram("cubefs_rpc_latency_seconds",
                                "RPC handler latency", ("method",))
codec_bytes = DEFAULT.counter("cubefs_codec_bytes_total",
                              "bytes through the EC codec", ("op", "engine"))

# batched codec admission (codec/batcher.py): device-sized steps
codec_batch_submissions = DEFAULT.counter(
    "cubefs_codec_batch_submissions_total",
    "stripes submitted through the codec admission surface", ("op",))
codec_batch_steps = DEFAULT.counter(
    "cubefs_codec_batch_steps_total",
    "drained device steps (each is ONE engine dispatch)",
    ("op", "engine"))
codec_batch_stripes = DEFAULT.histogram(
    "cubefs_codec_batch_stripes_per_step",
    "stripes coalesced per drained device step (1 = uncontended)",
    ("op",), buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024))
codec_batch_wait = DEFAULT.histogram(
    "cubefs_codec_batch_wait_seconds",
    "submit-to-device-step admission wait", ("op",))
codec_batch_backpressure = DEFAULT.counter(
    "cubefs_codec_batch_backpressure_total",
    "submissions that blocked on the bounded pending queue", ("op",))
codec_batch_errors = DEFAULT.counter(
    "cubefs_codec_batch_errors_total",
    "per-submission errors fanned back by the drainer", ("op", "kind"))
codec_batch_dp_steps = DEFAULT.counter(
    "cubefs_codec_batch_dp_steps_total",
    "device steps split dp-wise over the batcher's devices", ("dp",))

# the shared rows cache (ops/progcache.py)
codec_program_cache = DEFAULT.counter(
    "cubefs_codec_program_cache_total",
    "compiled-program cache traffic by kernel family and event "
    "(hit / miss / evict)", ("family", "event"))
codec_program_cache_entries = DEFAULT.gauge(
    "cubefs_codec_program_cache_entries",
    "entries resident in the shared compiled-program cache")

# the port's CUDA kernels (ops/_build.py)
kernel_launches = DEFAULT.counter(
    "cubefs_codec_kernel_launches_total",
    "CUDA kernel launches by kernel", ("kernel",))

# the blob plane and its utilities (cubefs_tpu_torch/blob, utils/)
repair_tasks = DEFAULT.counter("cubefs_repair_tasks_total",
                               "repair tasks", ("state",))
rpc_client_retries = DEFAULT.counter(
    "cubefs_rpc_client_retries_total",
    "client-side RPC retries taken through RetryPolicy", ("op", "reason"))
breaker_state = DEFAULT.gauge(
    "cubefs_breaker_state",
    "per-address circuit breaker state (0=closed, 1=half-open, 2=open)",
    ("addr",))
breaker_skips = DEFAULT.counter(
    "cubefs_breaker_skips_total",
    "calls skipped because the address's breaker was open", ("addr",))
faults_injected = DEFAULT.counter(
    "cubefs_faults_injected_total",
    "chaos faults injected by the installed FaultPlan", ("kind",))

# write-path group commit (raft proposal batching)
raft_proposals = DEFAULT.counter(
    "cubefs_raft_proposals_total",
    "entries proposed through the leader group-commit batcher", ("group",))
raft_proposal_batches = DEFAULT.counter(
    "cubefs_raft_proposal_batches_total",
    "batcher drains: each is one log append + one WAL write + one "
    "replication round", ("group",))
raft_entries_per_batch = DEFAULT.histogram(
    "cubefs_raft_entries_per_batch",
    "entries carried per proposal-batcher drain", ("group",),
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))
raft_wal_fsyncs = DEFAULT.counter(
    "cubefs_raft_wal_fsyncs_total",
    "actual fsync(2) calls on the raft WAL (group fsync shares one "
    "flush across concurrent acks)", ("group",))
raft_batch_apply_latency = DEFAULT.histogram(
    "cubefs_raft_batch_apply_seconds",
    "latency of applying one drained batch of committed entries before "
    "waking waiters", ("group",))

# pipelined replication (CUBEFS_RAFT_PIPELINE) and the shared ReplMux
# sender plane
raft_pipelined_appends = DEFAULT.counter(
    "cubefs_raft_pipelined_appends_total",
    "AppendEntries dispatched through the pipelined per-follower "
    "window (sent without waiting for the previous batch's ack)",
    ("group",))
raft_inflight_window = DEFAULT.histogram(
    "cubefs_raft_inflight_window",
    "in-flight appends per follower observed at dispatch — the "
    "replication pipeline depth actually used", ("group",),
    buckets=(1, 2, 3, 4, 6, 8, 12, 16))
raft_mux_jobs = DEFAULT.counter(
    "cubefs_raft_mux_jobs_total",
    "replication jobs shipped through the shared per-address ReplMux "
    "sender lanes (the multi-raft proposal mux)", ("kind",))
raft_mux_senders = DEFAULT.gauge(
    "cubefs_raft_mux_senders",
    "live sender worker threads in a ReplMux address lane", ("addr",))
placement_az_skew = DEFAULT.gauge(
    "cubefs_placement_az_skew",
    "volume-unit count spread across AZs (max - min), set by the "
    "rebalance sweep's scoring pass")
placement_misplaced = DEFAULT.gauge(
    "cubefs_placement_misplaced_units",
    "volume units living outside their local stripe's home AZ; zero "
    "means every LRC stripe is physically AZ-local")
placement_colocated = DEFAULT.counter(
    "cubefs_placement_colocated_total",
    "volume allocations that degraded the failure-domain contract "
    "under allow_colocated_units", ("kind",))
rebalance_moves = DEFAULT.counter(
    "cubefs_rebalance_moves_total",
    "unit migrations queued by the rebalance sweep", ("reason",))
reconstruct_reads = DEFAULT.counter(
    "cubefs_reconstruct_total",
    "degraded-read reconstructions by stripe scope (local = intra-AZ "
    "LRC stripe, global = full-width RS)", ("path",))
repair_codec_leg = DEFAULT.counter(
    "cubefs_repair_codec_leg_total",
    "repair decode dispatches by the engine leg that served them "
    "(post-fallback, post-XOR-door)", ("leg",))
repair_bytes_pulled = DEFAULT.counter(
    "cubefs_repair_bytes_pulled_total",
    "bytes downloaded from survivors by repair (full shards on the "
    "conventional path, beta-sized helper symbols on the MSR path)",
    ("scope",))
repair_subshard_reads = DEFAULT.counter(
    "cubefs_repair_subshard_reads_total",
    "beta-sized helper symbols served through read_subshard (one per "
    "bid per helper)")
repair_msr_fallbacks = DEFAULT.counter(
    "cubefs_repair_msr_fallback_total",
    "MSR repairs that fell back to the conventional k-shard decode",
    ("reason",))
request_stage_seconds = DEFAULT.histogram(
    "cubefs_request_stage_seconds",
    "per-stage latency of instrumented hot-path requests",
    ("path", "stage"),
    buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
             0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60))
slo_latency_quantile = DEFAULT.gauge(
    "cubefs_slo_latency_quantile_seconds",
    "sliding-window latency quantile estimate per instrumented path",
    ("path", "quantile"))
slo_burn_rate = DEFAULT.gauge(
    "cubefs_slo_burn_rate",
    "error-budget burn rate per path: fraction of windowed requests "
    "over the SLO target divided by the budget (1-objective); 1.0 "
    "burns the budget exactly at the objective rate",
    ("path",))
slo_budget_remaining = DEFAULT.gauge(
    "cubefs_slo_error_budget_remaining",
    "fraction of the window's error budget still unspent (1 = no "
    "violations, 0 = budget exhausted)",
    ("path",))
trace_spans_total = DEFAULT.counter(
    "cubefs_trace_spans_total",
    "spans finished into the in-memory collector")
trace_evictions = DEFAULT.counter(
    "cubefs_trace_evictions_total",
    "whole traces evicted from the collector (oldest-root-first)")
slow_traces = DEFAULT.counter(
    "cubefs_slow_traces_total",
    "root spans that exceeded CUBEFS_SLOW_MS and were captured to the "
    "slow-trace forensics log", ("path",))
ratelimit_waits = DEFAULT.counter(
    "cubefs_ratelimit_waits_total",
    "token-bucket reservations that had to wait for refill", ("limiter",))
ratelimit_wait_seconds = DEFAULT.histogram(
    "cubefs_ratelimit_wait_seconds",
    "per-reservation token-bucket wait (virtual-queue debt / rate)",
    ("limiter",))
qos_admitted = DEFAULT.counter(
    "cubefs_qos_admitted_total",
    "requests admitted through the QoS gate",
    ("path", "tenant", "priority"))
qos_shed = DEFAULT.counter(
    "cubefs_qos_shed_total",
    "requests shed (429) at admission: `over_quota` exhausted the "
    "tenant bucket, `queue_depth` hit the per-priority inflight bound, "
    "`brownout` was a low-priority class dropped while the path burns "
    "SLO budget", ("path", "tenant", "reason"))
qos_throttled = DEFAULT.counter(
    "cubefs_qos_throttled_total",
    "admissions shaped (delayed but not shed) by the tenant bucket",
    ("path", "tenant"))
qos_throttle_wait = DEFAULT.histogram(
    "cubefs_qos_throttle_wait_seconds",
    "admission shaping delay applied by the tenant bucket", ("path",))
qos_inflight = DEFAULT.gauge(
    "cubefs_qos_inflight",
    "requests currently inside the QoS gate, per path", ("path",))
qos_brownout = DEFAULT.gauge(
    "cubefs_qos_brownout_level",
    "burn-rate-driven degradation level per path: 0 healthy, 1 shed "
    "scrub + suppress flash fills + halve repair steps, 2 shed repair "
    "too and quarter repair steps", ("path",))
integrity_corruptions_detected = DEFAULT.counter(
    "cubefs_integrity_corruptions_detected_total",
    "at-rest corruptions caught by a CRC check, by plane (fs/blob/wal) "
    "and source (`read` = foreground verified read, `scrub` = "
    "background sweep, `replay` = WAL replay)", ("plane", "source"))
integrity_corruptions_healed = DEFAULT.counter(
    "cubefs_integrity_corruptions_healed_total",
    "corrupt copies rewritten in place from a healthy replica (fs) or "
    "EC reconstruction (blob), by plane and source", ("plane", "source"))
integrity_repair_failures = DEFAULT.counter(
    "cubefs_integrity_repair_failures_total",
    "read-repair attempts that could not heal the bad copy (left for "
    "the scrubber / repair queue)", ("plane",))
wal_torn_tail = DEFAULT.counter(
    "cubefs_wal_torn_tail_total",
    "WAL replays that truncated a torn trailing record (the expected "
    "crash artifact; corrupt-MIDDLE records refuse replay instead)")
scrub_items = DEFAULT.counter(
    "cubefs_scrub_items_total",
    "scrubbed units by plane and outcome: `clean`, `corrupt` (detected "
    "and queued/healed), `skipped` (brownout or rate limit deferred)",
    ("plane", "outcome"))
scrub_last_full_pass = DEFAULT.gauge(
    "cubefs_scrub_last_full_pass_seconds",
    "wall seconds the most recent COMPLETED full scrub pass took, per "
    "plane (0 until a first pass completes)", ("plane",))
scrub_cursor = DEFAULT.gauge(
    "cubefs_scrub_cursor_position",
    "resumable sweep cursor position within the current pass",
    ("plane",))
disk_quarantined = DEFAULT.gauge(
    "cubefs_disk_quarantine_active",
    "disks currently quarantined (no new allocations; probe-based "
    "unquarantine pending)", ("node",))
disk_quarantine_transitions = DEFAULT.counter(
    "cubefs_disk_quarantine_transitions_total",
    "disk health state transitions: `quarantine` (io-error or latency "
    "outlier tripped), `probe_pass` (probe healed it back), "
    "`probe_fail` (probe kept it quarantined)", ("node", "event"))

# the file-system plane (cubefs_tpu_torch/fs): metanode group commit,
# the client's cross-partition fan-out coalescer, placement and the
# range redirects a metanode answers
meta_batch_entries = DEFAULT.counter(
    "cubefs_meta_batch_entries_total",
    "__batch__ raft entries proposed by the metanode submit coalescer",
    ("pid",))
meta_batched_ops = DEFAULT.counter(
    "cubefs_meta_batched_ops_total",
    "mutations carried inside coalesced __batch__ entries", ("pid",))
meta_ops_per_batch = DEFAULT.histogram(
    "cubefs_meta_ops_per_batch_entry",
    "mutations carried per coalesced submit (1 = uncontended fast path)",
    ("pid",), buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))
meta_fanout_batches = DEFAULT.counter(
    "cubefs_meta_fanout_batches_total",
    "client-side cross-partition fan-out drains (one submit_batch RPC "
    "per drain)", ("pid",))
meta_fanout_ops = DEFAULT.counter(
    "cubefs_meta_fanout_ops_total",
    "mutations carried by client fan-out drains", ("pid",))
meta_fanout_inflight = DEFAULT.histogram(
    "cubefs_meta_fanout_partitions_inflight",
    "partitions with a batch in flight when a fan-out drain launches — "
    "the client-side K window actually used",
    buckets=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32))
# AZ-local hot-read tier (fs/remotecache.py CachedReader) + fs-plane
# topology (fs/topology.py). `cubefs-cli metrics read-path` renders the
# readcache series; the misplaced gauge is the fs sweep's 0-contract.
readcache_serves = DEFAULT.counter(
    "cubefs_readcache_serves_total",
    "reads answered by the flash tier, by the serving group's AZ "
    "locality relative to the client", ("scope",))  # az_local | cross_az
readcache_fills = DEFAULT.counter(
    "cubefs_readcache_fills_total",
    "miss-path outcomes: `populated` pushed the block to a flashnode, "
    "`skipped_cold` failed the hotness admission bar (streaming scans "
    "must not flush the hot set), `failed` found no writable flashnode, "
    "`suppressed` deferred the fill during a QoS brownout",
    ("outcome",))
readcache_singleflight = DEFAULT.counter(
    "cubefs_readcache_singleflight_total",
    "concurrent misses of one block collapsed onto another caller's "
    "in-flight datanode read (thundering-herd suppression)")
readcache_invalidations = DEFAULT.counter(
    "cubefs_readcache_invalidations_total",
    "cached blocks evicted from the flash tier by write-path "
    "invalidation (overwrite / truncate / unlink)")
fs_placement_misplaced = DEFAULT.gauge(
    "cubefs_fs_placement_misplaced_replicas",
    "dp replicas colocated in an AZ beyond the one-per-AZ fair share; "
    "the rate-limited misplaced-replica sweep drives this to zero")
# elastic metadata plane (fs/split.py). `cubefs-cli metrics meta`
# renders these; the imbalance gauge is the meta balance sweep's
# 0-contract, mirroring the fs placement sweep above.
meta_partition_imbalance = DEFAULT.gauge(
    "cubefs_meta_partition_imbalance",
    "actionable metapartitions: hot/oversized ones the split engine "
    "would split plus cold adjacent pairs it would merge; the "
    "rate-limited balance sweep drives this to zero")
meta_range_migrations = DEFAULT.counter(
    "cubefs_meta_range_migrations_total",
    "completed live inode-range migrations, by kind", ("kind",))
meta_range_migration_aborts = DEFAULT.counter(
    "cubefs_meta_range_migration_aborts_total",
    "in-flight migrations aborted before COMMIT (poisoned delta tap, "
    "donor leadership change, crash recovery); aborts are clean — the "
    "range table never moved", ("reason",))
meta_range_redirects = DEFAULT.counter(
    "cubefs_meta_range_redirects_total",
    "requests bounced with the 453 range-moved routing code (frozen "
    "sub-range during handoff, or a stale client map after COMMIT)")

# cold-data lifecycle tiering (fs/tiering.py, fs/lcnode.py)
tiering_transitions = DEFAULT.counter(
    "cubefs_tiering_transitions_total",
    "cold-tier migration attempts by outcome: `migrated` released the "
    "hot extents after a verified blob copy, `fenced` lost the race to "
    "a concurrent write/rename and rolled back, `resumed` finished a "
    "half-done migration found by rescan, `aborted` rolled one back, "
    "`verify_failed` rejected a corrupt blob copy before release, "
    "`error` died mid-flight (state machine resumes it)", ("outcome",))
tiering_bytes = DEFAULT.counter(
    "cubefs_tiering_bytes_total",
    "payload bytes moved across the fs<->blob bridge",
    ("direction",))  # cold (migrate) / hot (untier) / read (read-through)
tiering_cold_reads = DEFAULT.counter(
    "cubefs_tiering_cold_reads_total",
    "read-through requests served from the blob plane")
tiering_untiered = DEFAULT.counter(
    "cubefs_tiering_untiered_total",
    "re-heat promotions back to datanode extents by outcome",
    ("outcome",))
tiering_orphans_reaped = DEFAULT.counter(
    "cubefs_tiering_orphans_reaped_total",
    "unreachable blob copies deleted by the deferred blob-free reaper")
tiering_blob_freelist = DEFAULT.gauge(
    "cubefs_tiering_blob_freelist",
    "blob locations queued for deferred deletion (nonzero between a "
    "rollback/overwrite/unlink and the next reaper sweep)")
tiering_orphans_reconciled = DEFAULT.counter(
    "cubefs_tiering_orphans_reconciled_total",
    "leaked blob bids found by inventory reconciliation (the "
    "put->blob_written crash window) and enqueued for the reaper")
lc_scan_errors = DEFAULT.counter(
    "cubefs_lc_scan_errors_total",
    "lifecycle scan loop iterations that raised (loop stays alive)")

# the multiplexed streaming packet plane (utils/packet.py)
pkt_frames = DEFAULT.counter(
    "cubefs_pkt_frames_total",
    "binary-plane frames moved, by direction (`tx`/`rx`) and side "
    "(`client`/`server`)", ("dir", "side"))
pkt_chunk_bytes = DEFAULT.counter(
    "cubefs_pkt_chunk_bytes_total",
    "binary-plane bytes moved (headers + args + payload chunks), by "
    "direction and side", ("dir", "side"))
pkt_mux_conns = DEFAULT.gauge(
    "cubefs_pkt_mux_conns",
    "live client-side mux connections (one shared socket per address)")
pkt_mux_streams = DEFAULT.gauge(
    "cubefs_pkt_mux_streams",
    "requests currently in flight across all mux connections (streams "
    "registered and not yet resolved)")
pkt_mux_queue_wait = DEFAULT.histogram(
    "cubefs_pkt_mux_queue_wait_seconds",
    "wait for the shared connection's per-frame send slot — how long "
    "one chunk queued behind other streams' frames",
    buckets=(0.00005, 0.0002, 0.001, 0.005, 0.02, 0.1, 0.5, 2))
pkt_stream_drops = DEFAULT.counter(
    "cubefs_pkt_stream_drops_total",
    "streams failed by a per-chunk CRC mismatch while the connection "
    "itself was kept (framing intact)", ("side",))

# cross-cluster geo-replication (utils/georepl.py + fs/georepl.py):
# per-partition WAL shipping, fenced promote/failback, follower-region
# read serving. `cubefs-cli metrics geo` renders these.
geo_lag = DEFAULT.gauge(
    "cubefs_geo_lag_seconds",
    "replication lag per shipped partition: ship-stamp age of the last "
    "record the follower applied (tenant-scoped RPO clock)",
    ("part", "tenant"))
geo_rpo_bytes = DEFAULT.gauge(
    "cubefs_geo_rpo_bytes",
    "bytes committed on the primary but not yet acknowledged by the "
    "follower — the data at risk if the region dies right now",
    ("part", "tenant"))
geo_shipped = DEFAULT.counter(
    "cubefs_geo_shipped_total",
    "records shipped to the peer region, per partition", ("part",))
geo_applied = DEFAULT.counter(
    "cubefs_geo_applied_total",
    "follower-side stream outcomes per partition: `applied`, "
    "`duplicate` (seq <= applied, idempotent skip), `gap` (backfill "
    "triggered), `corrupt` (framing/CRC rejected)", ("part", "outcome"))
geo_fencing_rejections = DEFAULT.counter(
    "cubefs_geo_fencing_rejections_total",
    "shipped records rejected for carrying a stale fencing epoch (a "
    "healed old primary replaying into a promoted follower)", ("part",))
geo_backfills = DEFAULT.counter(
    "cubefs_geo_backfills_total",
    "gap recoveries per partition by kind: `ring` (bounded backfill "
    "from the shipper's ring) or `bootstrap` (full snapshot transfer "
    "over the packet mux)", ("part", "kind"))
geo_state = DEFAULT.gauge(
    "cubefs_geo_state",
    "promote/failback state machine position per cluster: 0=PRIMARY "
    "1=FOLLOWING 2=FENCED 3=PROMOTED 4=FAILBACK_SYNC", ("cluster",))
geo_epoch = DEFAULT.gauge(
    "cubefs_geo_epoch",
    "current fencing epoch per cluster (monotonic; bumps on every "
    "promote so stale-primary appends are rejectable)", ("cluster",))
geo_redirects = DEFAULT.counter(
    "cubefs_geo_redirects_total",
    "mutations bounced off a follower region with GeoRedirect (the sdk "
    "retries them against the primary)", ("part",))
