"""cfs-cli analog: cluster admin + file + blob operations.

Role parity: cli/ (cobra `cfs-cli` command groups: vol, datanode,
datapartition, user...) and blobstore/cli. Usage:

  python -m cubefs_tpu_torch.cli cluster stat --master HOST:PORT
  python -m cubefs_tpu_torch.cli vol create NAME --master ...
  python -m cubefs_tpu_torch.cli fs put LOCAL /remote --master ... --vol NAME
  python -m cubefs_tpu_torch.cli fs get /remote LOCAL --master ... --vol NAME
  python -m cubefs_tpu_torch.cli fs ls /dir  | rm | stat | mkdir
  python -m cubefs_tpu_torch.cli blob put LOCAL --access HOST:PORT
  python -m cubefs_tpu_torch.cli blob get LOCATION.json LOCAL --access ...
  python -m cubefs_tpu_torch.cli topology blob --clustermgr HOST:PORT
  python -m cubefs_tpu_torch.cli topology rebalance --scheduler HOST:PORT

(installed as ``cubefs-tpu-torch-cli``). The port's copy of
``cubefs_tpu/cli.py``: the same groups, actions and JSON. It is a host
program that talks to the roles, and the roles hold the card: it takes no
device and imports no torch, so a metrics view or a ``vol create`` pays
for no CUDA initialisation. Its per-node calls (``node decommission``,
``dp raft-status``, ``tasks``, ``scrub``) go to the one named address
through a fresh ``rpc.Client``, which has learned no leader to follow.
"""

from __future__ import annotations

import argparse
import json
import sys


def _fs(args):
    from .fs.client import FileSystem
    from .utils.rpc import NodePool
    from .utils import rpc

    master = rpc.Client(args.master)
    view = master.call("client_view", {"name": args.vol})[0]["volume"]
    return FileSystem(view, NodePool())


def _fetch_metrics(addr: str) -> str:
    import http.client

    host, port = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=5.0)
    try:
        conn.request("GET", "/metrics")
        return conn.getresponse().read().decode()
    finally:
        conn.close()


def _fetch_json(addr: str, path: str) -> dict:
    import http.client

    host, port = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=5.0)
    try:
        conn.request("GET", path)
        return json.loads(conn.getresponse().read().decode())
    finally:
        conn.close()


def _parse_metrics(text: str) -> list[tuple[str, dict, float]]:
    """Prometheus exposition text -> [(name, labels, value)]."""
    out = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        head, _, val = line.rpartition(" ")
        labels: dict = {}
        name = head
        if "{" in head:
            name, _, inner = head.partition("{")
            for pair in inner.rstrip("}").split(","):
                if pair:
                    k, _, v = pair.partition("=")
                    labels[k] = v.strip('"')
        try:
            out.append((name, labels, float(val)))
        except ValueError:
            continue
    return out


def _write_path_view(text: str) -> dict:
    """The group-commit write-path digest: is batching actually
    amortizing replication rounds and fsyncs on this node?"""
    series = _parse_metrics(text)

    def total(name, **match):
        return sum(v for n, lb, v in series if n == name
                   and all(lb.get(k) == str(w) for k, w in match.items()))

    proposals = total("cubefs_raft_proposals_total")
    batches = total("cubefs_raft_proposal_batches_total")
    fsyncs = total("cubefs_raft_wal_fsyncs_total")
    apply_sum = total("cubefs_raft_batch_apply_seconds_sum")
    apply_cnt = total("cubefs_raft_batch_apply_seconds_count")
    coalesced_entries = total("cubefs_meta_batch_entries_total")
    coalesced_ops = total("cubefs_meta_batched_ops_total")
    groups = sorted({lb["group"] for n, lb, _ in series
                     if n == "cubefs_raft_proposals_total" and "group" in lb})
    view = {
        "raft": {
            "proposals": proposals,
            "proposal_batches": batches,
            "entries_per_batch_avg":
                round(proposals / batches, 2) if batches else None,
            "wal_fsyncs": fsyncs,
            "proposals_per_fsync":
                round(proposals / fsyncs, 2) if fsyncs else None,
            "batch_apply_avg_ms":
                round(1000 * apply_sum / apply_cnt, 3) if apply_cnt else None,
            "groups": len(groups),
        },
        "meta_coalescer": {
            "batch_entries": coalesced_entries,
            "batched_ops": coalesced_ops,
            "ops_per_batch_entry_avg":
                round(coalesced_ops / coalesced_entries, 2)
                if coalesced_entries else None,
        },
    }
    # pipelined replication (CUBEFS_RAFT_PIPELINE) + shared mux planes
    pipelined = total("cubefs_raft_pipelined_appends_total")
    win_sum = total("cubefs_raft_inflight_window_sum")
    win_cnt = total("cubefs_raft_inflight_window_count")
    mux_jobs = [(lb.get("kind"), v) for n, lb, v in series
                if n == "cubefs_raft_mux_jobs_total"]
    senders = total("cubefs_raft_mux_senders")
    if pipelined or mux_jobs:
        view["pipeline"] = {
            "pipelined_appends": pipelined,
            "inflight_window_avg":
                round(win_sum / win_cnt, 2) if win_cnt else None,
            "mux_jobs": {k: v for k, v in mux_jobs},
            "mux_sender_threads": senders,
        }
    # client-side cross-partition fan-out (CUBEFS_META_FANOUT)
    fan_batches = total("cubefs_meta_fanout_batches_total")
    fan_ops = total("cubefs_meta_fanout_ops_total")
    fan_sum = total("cubefs_meta_fanout_partitions_inflight_sum")
    fan_cnt = total("cubefs_meta_fanout_partitions_inflight_count")
    if fan_batches or fan_cnt:
        view["client_fanout"] = {
            "fanout_batches": fan_batches,
            "fanout_ops": fan_ops,
            "ops_per_batch_avg":
                round(fan_ops / fan_batches, 2) if fan_batches else None,
            "partitions_inflight_avg":
                round(fan_sum / fan_cnt, 2) if fan_cnt else None,
        }
    return view


def _codec_view(text: str) -> dict:
    """The codec-admission digest: is the batcher actually coalescing
    concurrent submissions into device-sized steps on this node?"""
    series = _parse_metrics(text)

    def total(name, **match):
        return sum(v for n, lb, v in series if n == name
                   and all(lb.get(k) == str(w) for k, w in match.items()))

    view: dict = {}
    for op in ("encode", "apply"):
        subs = total("cubefs_codec_batch_submissions_total", op=op)
        steps = total("cubefs_codec_batch_steps_total", op=op)
        stripes = total("cubefs_codec_batch_stripes_per_step_sum", op=op)
        step_cnt = total("cubefs_codec_batch_stripes_per_step_count", op=op)
        wait_sum = total("cubefs_codec_batch_wait_seconds_sum", op=op)
        wait_cnt = total("cubefs_codec_batch_wait_seconds_count", op=op)
        if not (subs or steps):
            continue
        view[op] = {
            "stripes_submitted": subs,
            "device_steps": steps,
            "stripes_per_step_avg":
                round(stripes / step_cnt, 2) if step_cnt else None,
            "admission_wait_avg_ms":
                round(1000 * wait_sum / wait_cnt, 3) if wait_cnt else None,
            "backpressure_blocks":
                total("cubefs_codec_batch_backpressure_total", op=op),
            "errors_fanned_back":
                total("cubefs_codec_batch_errors_total", op=op),
        }
    engines = sorted({lb.get("engine") for n, lb, _ in series
                      if n == "cubefs_codec_batch_steps_total"} - {None})
    view["steps_by_engine"] = {
        e: total("cubefs_codec_batch_steps_total", engine=e)
        for e in engines}
    dp = [(lb.get("dp"), v) for n, lb, v in series
          if n == "cubefs_codec_batch_dp_steps_total"]
    view["dp_sharded_steps"] = {k: v for k, v in dp}
    view["codec_bytes_by_engine"] = {
        e: total("cubefs_codec_bytes_total", engine=e)
        for e in sorted({lb.get("engine") for n, lb, _ in series
                         if n == "cubefs_codec_bytes_total"} - {None})}
    fams = sorted({lb.get("family") for n, lb, _ in series
                   if n == "cubefs_codec_program_cache_total"} - {None})
    if fams:
        view["program_cache"] = {
            fam: {
                "hits": total("cubefs_codec_program_cache_total",
                              family=fam, event="hit"),
                "misses": total("cubefs_codec_program_cache_total",
                                family=fam, event="miss"),
                "evictions": total("cubefs_codec_program_cache_total",
                                   family=fam, event="evict"),
            }
            for fam in fams}
        view["program_cache"]["entries"] = total(
            "cubefs_codec_program_cache_entries")
    legs = sorted({lb.get("leg") for n, lb, _ in series
                   if n == "cubefs_repair_codec_leg_total"} - {None})
    if legs:
        view["repair_decode_by_leg"] = {
            leg: total("cubefs_repair_codec_leg_total", leg=leg)
            for leg in legs}
    return view


def _repair_view(text: str) -> dict:
    """The repair-traffic digest: how many bytes did repairs pull from
    survivors (and from which failure domains), how much of it rode the
    beta-sized MSR sub-shard path, and did any MSR repair degrade to the
    conventional k-shard decode?"""
    series = _parse_metrics(text)

    def total(name, **match):
        return sum(v for n, lb, v in series if n == name
                   and all(lb.get(k) == str(w) for k, w in match.items()))

    az_local = total("cubefs_repair_bytes_pulled_total", scope="az_local")
    cross_az = total("cubefs_repair_bytes_pulled_total", scope="cross_az")
    pulled = az_local + cross_az
    fallbacks = {lb.get("reason", ""): v for n, lb, v in series
                 if n == "cubefs_repair_msr_fallback_total"}
    return {
        "bytes_pulled": {
            "total": pulled,
            "az_local": az_local,
            "cross_az": cross_az,
            "cross_az_fraction":
                round(cross_az / pulled, 4) if pulled else None,
        },
        "subshard_reads": total("cubefs_repair_subshard_reads_total"),
        "msr_fallbacks": fallbacks,
        "repair_tasks": {
            lb.get("state", ""): v for n, lb, v in series
            if n == "cubefs_repair_tasks_total"},
    }


def _read_path_view(text: str) -> dict:
    """The hot-read-tier digest: is the flash cache actually absorbing
    reads, are serves staying AZ-local, and is admission / singleflight
    / invalidation behaving on this node?"""
    series = _parse_metrics(text)

    def total(name, **match):
        return sum(v for n, lb, v in series if n == name
                   and all(lb.get(k) == str(w) for k, w in match.items()))

    hits = total("cubefs_flashcache_ops_total", result="hit")
    misses = total("cubefs_flashcache_ops_total", result="miss")
    az_local = total("cubefs_readcache_serves_total", scope="az_local")
    cross_az = total("cubefs_readcache_serves_total", scope="cross_az")
    serves = az_local + cross_az
    return {
        "lookups": {
            "hits": hits,
            "misses": misses,
            "hit_ratio": round(hits / (hits + misses), 4)
            if hits + misses else None,
        },
        "serves": {
            "az_local": az_local,
            "cross_az": cross_az,
            "az_local_fraction":
                round(az_local / serves, 4) if serves else None,
        },
        "fills": {lb.get("outcome", ""): v for n, lb, v in series
                  if n == "cubefs_readcache_fills_total"},
        "singleflight_collapses":
            total("cubefs_readcache_singleflight_total"),
        "invalidated_blocks":
            total("cubefs_readcache_invalidations_total"),
    }


def _wire_view(text: str) -> dict:
    """The binary packet-plane digest: frame and byte traffic on both
    sides of the wire, live mux sessions with their in-flight streams,
    how long chunks queued behind other streams for the shared send
    slot, and CRC stream drops (a nonzero drop count with the conn
    still up is the per-stream failure isolation working; a climbing
    one means a flaky path). streams/conn >> 1 is the multiplexing
    win — the legacy serial plane pins it at <= 1."""
    series = _parse_metrics(text)

    def by_labels(name, *labels):
        out = {}
        for n, lb, v in series:
            if n == name:
                key = "/".join(lb.get(x, "") for x in labels)
                out[key] = out.get(key, 0) + v
        return out

    def total(name):
        return sum(v for n, _, v in series if n == name)

    conns = total("cubefs_pkt_mux_conns")
    streams = total("cubefs_pkt_mux_streams")
    wait_sum = total("cubefs_pkt_mux_queue_wait_seconds_sum")
    wait_cnt = total("cubefs_pkt_mux_queue_wait_seconds_count")
    return {
        "frames": by_labels("cubefs_pkt_frames_total", "side", "dir"),
        "bytes": by_labels("cubefs_pkt_chunk_bytes_total", "side",
                           "dir"),
        "mux": {
            "conns": conns,
            "inflight_streams": streams,
            "streams_per_conn": round(streams / conns, 2)
            if conns else None,
            "send_queue_wait_avg_ms":
                round(1000 * wait_sum / wait_cnt, 3) if wait_cnt else None,
            "send_queue_waits": wait_cnt,
        },
        "stream_drops": by_labels("cubefs_pkt_stream_drops_total",
                                  "side"),
    }


def _geo_view(text: str) -> dict:
    """The geo-replication digest: per-partition lag and at-risk bytes
    (the live RPO), applied/duplicate/gap/corrupt outcome counts on the
    follower, backfill mode split (ring vs full bootstrap), fencing
    rejections (a healed old primary replaying a divergent tail — each
    one is a double-apply that did NOT happen), and this node's
    promote/failback state + fencing epoch."""
    series = _parse_metrics(text)

    def by_label(name, label):
        out = {}
        for n, lb, v in series:
            if n == name:
                key = lb.get(label, "")
                out[key] = out.get(key, 0) + v
        return out

    parts = sorted({lb["part"] for n, lb, _ in series
                    if n in ("cubefs_geo_lag_seconds",
                             "cubefs_geo_rpo_bytes") and "part" in lb})
    per_part = {}
    for p in parts:
        outcomes = {lb.get("outcome", ""): v for n, lb, v in series
                    if n == "cubefs_geo_applied_total"
                    and lb.get("part") == p}
        per_part[p] = {
            "lag_s": sum(v for n, lb, v in series
                         if n == "cubefs_geo_lag_seconds"
                         and lb.get("part") == p),
            "rpo_bytes": sum(v for n, lb, v in series
                             if n == "cubefs_geo_rpo_bytes"
                             and lb.get("part") == p),
            "applied": outcomes,
        }
    states = by_label("cubefs_geo_state", "cluster")
    from .utils.georepl import STATES
    return {
        "clusters": {c: {"state": STATES[int(v)]
                         if 0 <= int(v) < len(STATES) else v,
                         "epoch": by_label("cubefs_geo_epoch",
                                           "cluster").get(c, 0)}
                     for c, v in states.items()},
        "parts": per_part,
        "shipped": by_label("cubefs_geo_shipped_total", "part"),
        "backfills": by_label("cubefs_geo_backfills_total", "kind"),
        "fencing_rejections": by_label(
            "cubefs_geo_fencing_rejections_total", "part"),
        "redirects": by_label("cubefs_geo_redirects_total", "part"),
    }


def _meta_view(text: str) -> dict:
    """The elastic-metadata digest: actionable partition imbalance (the
    gauge the balance sweep drives to zero), completed migrations by
    kind, pre-commit aborts by reason, and 453 range-moved bounces —
    whether the plane is rebalancing and whether handoffs are clean."""
    series = _parse_metrics(text)

    def by_label(name, label):
        out = {}
        for n, lb, v in series:
            if n == name:
                key = lb.get(label, "")
                out[key] = out.get(key, 0) + v
        return out

    return {
        "imbalance": sum(v for n, _, v in series
                         if n == "cubefs_meta_partition_imbalance"),
        "migrations": by_label("cubefs_meta_range_migrations_total",
                               "kind"),
        "aborts": by_label("cubefs_meta_range_migration_aborts_total",
                           "reason"),
        "range_redirects": sum(
            v for n, _, v in series
            if n == "cubefs_meta_range_redirects_total"),
    }


def _qos_view(text: str) -> dict:
    """The overload-protection digest: per-tenant admit/shed/throttle
    counters, shaping waits, and burn-rate brownout state per path —
    whether the gate is shedding, who it is shedding, and why."""
    series = _parse_metrics(text)

    def total(name, **match):
        return sum(v for n, lb, v in series if n == name
                   and all(lb.get(k) == str(w) for k, w in match.items()))

    tenants = sorted({lb["tenant"] for n, lb, _ in series
                      if n in ("cubefs_qos_admitted_total",
                               "cubefs_qos_shed_total",
                               "cubefs_qos_throttled_total")
                      and "tenant" in lb})
    per_tenant = {}
    for t in tenants:
        shed_reasons = {lb.get("reason", ""): v for n, lb, v in series
                        if n == "cubefs_qos_shed_total"
                        and lb.get("tenant") == t}
        per_tenant[t] = {
            "admitted": total("cubefs_qos_admitted_total", tenant=t),
            "shed": sum(shed_reasons.values()),
            "shed_reasons": shed_reasons,
            "throttled": total("cubefs_qos_throttled_total", tenant=t),
        }
    brownout = {lb.get("path", ""): int(v) for n, lb, v in series
                if n == "cubefs_qos_brownout_level"}
    burn = {lb.get("path", ""): v for n, lb, v in series
            if n == "cubefs_slo_burn_rate"}
    return {
        "tenants": per_tenant,
        "brownout_level": brownout,
        "burn_rate": burn,
        "inflight": {lb.get("path", ""): int(v) for n, lb, v in series
                     if n == "cubefs_qos_inflight"},
        "ratelimit_waits": total("cubefs_ratelimit_waits_total"),
    }


def _tiering_view(text: str) -> dict:
    """The cold-tier digest: migration outcomes (did transitions land,
    get fenced by racing writes, or fail verification), bytes moved in
    each direction, read-through and re-heat activity, and the orphan
    backlog — nonzero `blob_freelist_pending` between a rollback and
    the next reaper sweep is normal; a growing one is not."""
    series = _parse_metrics(text)

    def by_label(name, label):
        return {lb.get(label, ""): v for n, lb, v in series if n == name}

    def total(name):
        return sum(v for n, _, v in series if n == name)

    freelist = [v for n, _, v in series
                if n == "cubefs_tiering_blob_freelist"]
    return {
        "transitions": by_label("cubefs_tiering_transitions_total",
                                "outcome"),
        "bytes": by_label("cubefs_tiering_bytes_total", "direction"),
        "cold_reads": total("cubefs_tiering_cold_reads_total"),
        "untiered": by_label("cubefs_tiering_untiered_total", "outcome"),
        "orphans_reaped": total("cubefs_tiering_orphans_reaped_total"),
        "blob_freelist_pending": freelist[0] if freelist else 0,
        "scan_errors": total("cubefs_lc_scan_errors_total"),
    }


def _integrity_view(text: str) -> dict:
    """The silent-corruption digest: corruptions caught vs healed (by
    plane and by which reader tripped over them), repair attempts that
    could not heal, WAL torn-tail truncations, scrubber progress per
    plane, and the disk-quarantine picture. A healthy cluster shows
    healed == detected and zero repair_failures; a `detected` that
    outruns `healed` means the healer is losing ground."""
    series = _parse_metrics(text)

    def by_labels(name, *labels):
        out = {}
        for n, lb, v in series:
            if n == name:
                key = "/".join(lb.get(x, "") for x in labels)
                out[key] = out.get(key, 0) + v
        return out

    def total(name):
        return sum(v for n, _, v in series if n == name)

    return {
        "detected": by_labels("cubefs_integrity_corruptions_detected_total",
                              "plane", "source"),
        "healed": by_labels("cubefs_integrity_corruptions_healed_total",
                            "plane", "source"),
        "repair_failures": by_labels(
            "cubefs_integrity_repair_failures_total", "plane"),
        "wal_torn_tails": total("cubefs_wal_torn_tail_total"),
        "scrub_items": by_labels("cubefs_scrub_items_total",
                                 "plane", "outcome"),
        "scrub_last_full_pass_seconds": by_labels(
            "cubefs_scrub_last_full_pass_seconds", "plane"),
        "scrub_cursor": by_labels("cubefs_scrub_cursor_position", "plane"),
        "disks_quarantined": by_labels("cubefs_disk_quarantine_active",
                                       "node"),
        "quarantine_transitions": by_labels(
            "cubefs_disk_quarantine_transitions_total", "node", "event"),
        "orphans_reconciled": total(
            "cubefs_tiering_orphans_reconciled_total"),
    }


def _slo_view(text: str) -> dict:
    """The tail-latency digest: per-path quantiles from the sliding
    window, SLO burn rate, and remaining error budget (scraping
    /metrics triggers the node's tracker refresh)."""
    series = _parse_metrics(text)
    paths = sorted({lb["path"] for n, lb, _ in series
                    if n.startswith("cubefs_slo_") and "path" in lb})
    view = {}
    for path in paths:
        quantiles = {lb["quantile"]: v for n, lb, v in series
                     if n == "cubefs_slo_latency_quantile_seconds"
                     and lb.get("path") == path}
        burn = [v for n, lb, v in series
                if n == "cubefs_slo_burn_rate" and lb.get("path") == path]
        budget = [v for n, lb, v in series
                  if n == "cubefs_slo_error_budget_remaining"
                  and lb.get("path") == path]
        total = sum(v for n, lb, v in series
                    if n == "cubefs_request_stage_seconds_count"
                    and lb.get("path") == path and lb.get("stage") == "total")
        view[path] = {
            "latency_ms": {q: round(v * 1000, 3)
                           for q, v in sorted(quantiles.items())},
            "burn_rate": burn[0] if burn else None,
            "budget_remaining": budget[0] if budget else None,
            "requests": total,
        }
    slow = {lb.get("path", ""): v for n, lb, v in series
            if n == "cubefs_slow_traces_total"}
    if slow:
        view["slow_traces"] = slow
    return view


def main(argv=None):
    ap = argparse.ArgumentParser(prog="cubefs-tpu-torch-cli")
    sub = ap.add_subparsers(dest="group", required=True)

    p_cluster = sub.add_parser("cluster")
    p_cluster.add_argument("action", choices=["stat"])
    p_cluster.add_argument("--master")
    p_cluster.add_argument("--clustermgr")

    p_vol = sub.add_parser("vol")
    p_vol.add_argument("action", choices=["create", "view", "update"])
    p_vol.add_argument("name")
    p_vol.add_argument("--master", required=True)
    p_vol.add_argument("--mp-count", type=int, default=3)
    p_vol.add_argument("--dp-count", type=int, default=4)
    p_vol.add_argument("--capacity", type=int,
                       help="volume capacity in bytes (0 = unlimited)")

    p_quota = sub.add_parser("quota")
    p_quota.add_argument("action", choices=["set", "list", "delete", "enforce"])
    p_quota.add_argument("--master", required=True)
    p_quota.add_argument("--vol", required=True)
    p_quota.add_argument("--path", help="quota dir path (for set)")
    p_quota.add_argument("--qid", type=int, help="quota id (for delete)")
    p_quota.add_argument("--max-bytes", type=int, default=0)
    p_quota.add_argument("--max-files", type=int, default=0)

    p_fs = sub.add_parser("fs")
    p_fs.add_argument("action",
                      choices=["put", "get", "ls", "rm", "stat", "mkdir", "mv"])
    p_fs.add_argument("args", nargs="*")
    p_fs.add_argument("--master", required=True)
    p_fs.add_argument("--vol", required=True)

    p_blob = sub.add_parser("blob")
    p_blob.add_argument("action",
                        choices=["put", "get", "delete", "stat",
                                 "vols", "disks", "disk-status",
                                 "chunks", "compact"])
    p_blob.add_argument("args", nargs="*")
    p_blob.add_argument("--access", help="access addr (put/get/delete/stat)")
    p_blob.add_argument("--clustermgr",
                        help="clustermgr addr (vols/disks/disk-status)")
    p_blob.add_argument("--blobnode", help="blobnode addr (chunks/compact)")
    p_blob.add_argument("--disk-id", type=int)
    p_blob.add_argument("--chunk-id", type=int)
    p_blob.add_argument("--status", type=int,
                        help="disk status code (disk-status) or volume "
                             "status filter (vols)")

    p_cm = sub.add_parser("cm")  # clustermgr managers (config/kv/scope)
    p_cm.add_argument("action",
                      choices=["config-get", "config-set", "config-del",
                               "config-list", "kv-get", "kv-set", "kv-del",
                               "kv-list", "scope-alloc", "scope-next"])
    p_cm.add_argument("args", nargs="*")
    p_cm.add_argument("--clustermgr", required=True)
    p_cm.add_argument("--prefix", default="")
    p_cm.add_argument("--count", type=int, default=100)

    p_mq = sub.add_parser("mq")  # replicated bus introspection
    p_mq.add_argument("action", choices=["status", "backlog"])
    p_mq.add_argument("--member", required=True, help="bus member addr")
    p_mq.add_argument("--topic", default="all",
                      help="one topic (e.g. repair/delete) or 'all'")

    p_node = sub.add_parser("node")
    p_node.add_argument("action", choices=["list", "decommission",
                                           "offline-disk", "disk-sweep"])
    p_node.add_argument("--master", required=True)
    p_node.add_argument("--addr", help="datanode address")
    p_node.add_argument("--disk", help="disk path (offline-disk)")

    p_mp = sub.add_parser("mp")
    p_mp.add_argument("action", choices=["split", "check"])
    p_mp.add_argument("--master", required=True)
    p_mp.add_argument("--vol", help="volume name (for split)")

    p_meta = sub.add_parser("meta")  # elastic metadata plane
    p_meta.add_argument("action",
                        choices=["split", "merge", "balance", "status"])
    p_meta.add_argument("--master", required=True)
    p_meta.add_argument("--vol", help="volume name")
    p_meta.add_argument("--pid", type=int,
                        help="donor partition (split/merge); auto-picked "
                             "when omitted")
    p_meta.add_argument("--split-ino", type=int,
                        help="explicit split point (split)")
    p_meta.add_argument("--absorber", type=int,
                        help="absorbing partition (merge); defaults to "
                             "the donor's left-adjacent neighbour")
    p_meta.add_argument("--max-moves", type=int, default=1,
                        help="migration cap for one balance sweep")

    p_user = sub.add_parser("user")
    p_user.add_argument("action",
                        choices=["create", "grant", "revoke", "list",
                                 "delete"])
    p_user.add_argument("--master", required=True)
    p_user.add_argument("--user-id")
    p_user.add_argument("--ak")
    p_user.add_argument("--vol")
    p_user.add_argument("--perm", default="rw", choices=["r", "rw"])

    p_tasks = sub.add_parser("tasks")
    p_tasks.add_argument("action",
                         choices=["list", "enable", "disable", "stats"])
    p_tasks.add_argument("--scheduler", required=True)
    p_tasks.add_argument("--kind", help="task kind (for enable/disable)")

    p_dp = sub.add_parser("dp")
    p_dp.add_argument("action", choices=["view", "check", "raft-status"])
    p_dp.add_argument("--master", help="master addr (view/check)")
    p_dp.add_argument("--datanode", help="datanode addr (raft-status)")
    p_dp.add_argument("--vol", help="volume name (view)")
    p_dp.add_argument("--dp-id", type=int, help="partition id (raft-status)")

    p_flash = sub.add_parser("flash")
    p_flash.add_argument("action",
                         choices=["ring", "register-group", "remove-group",
                                  "set-status", "stats"])
    p_flash.add_argument("--fgm", help="flashgroupmanager addr")
    p_flash.add_argument("--flashnode", help="flashnode addr (stats)")
    p_flash.add_argument("--group-id", type=int)
    p_flash.add_argument("--addrs", help="comma-separated flashnode addrs")
    p_flash.add_argument("--status", help="group status (set-status)")

    p_topo = sub.add_parser("topology")  # failure-domain views
    p_topo.add_argument("action", choices=["fs", "blob", "rebalance",
                                           "tree"])
    p_topo.add_argument("--master", help="fs master addr (fs/tree)")
    p_topo.add_argument("--clustermgr", help="clustermgr addr (blob)")
    p_topo.add_argument("--scheduler", help="scheduler addr (rebalance)")
    p_topo.add_argument("--max-moves", type=int,
                        help="cap unit migrations queued this sweep")

    p_geo = sub.add_parser("geo")  # cross-cluster replication / DR
    p_geo.add_argument("action",
                       choices=["status", "fence", "promote", "demote",
                                "failback-sync", "resume-following"])
    p_geo.add_argument("--gateway", required=True,
                       help="this region's geo gateway RPC addr")
    p_geo.add_argument("--op-id",
                       help="idempotency key for transitions (a retried "
                            "promote replays instead of re-fencing)")

    p_metrics = sub.add_parser("metrics")  # node observability views
    p_metrics.add_argument("action",
                           choices=["write-path", "codec", "repair", "slo",
                                    "read-path", "qos", "tiering",
                                    "integrity", "wire", "geo", "meta",
                                    "raw"])
    p_metrics.add_argument("--addr", required=True,
                           help="any node's RPC addr (serves /metrics)")

    p_scrub = sub.add_parser("scrub")  # continuous integrity sweep
    p_scrub.add_argument("action", choices=["status", "run"])
    p_scrub.add_argument("--scheduler", required=True,
                         help="blob scheduler addr")
    p_scrub.add_argument("--full", action="store_true",
                         help="run a complete pass instead of one slice")
    p_scrub.add_argument("--max-units", type=int, default=8,
                         help="units to scrub this slice (run)")

    p_trace = sub.add_parser("trace")  # distributed-trace forensics
    p_trace.add_argument("action", choices=["show", "slow", "list"])
    p_trace.add_argument("trace_id", nargs="?",
                         help="trace id (for show)")
    p_trace.add_argument("--addr", required=True,
                         help="any node's RPC addr (serves /traces)")
    p_trace.add_argument("--top", type=int, default=10,
                         help="worst-N slow roots (for slow)")
    p_trace.add_argument("--json", action="store_true",
                         help="raw JSON instead of the rendered tree")

    p_san = sub.add_parser("sanitize")  # concurrency sanitizer evidence
    p_san.add_argument("action", choices=["status"])
    p_san.add_argument("--path", default=None,
                       help="witness dump (default: artifacts/"
                            "SANITIZE_WITNESS.json from the last "
                            "CUBEFS_SANITIZE=1 run)")
    p_san.add_argument("--json", action="store_true",
                       help="raw dump instead of the rendered summary")

    p_auth = sub.add_parser("auth")
    p_auth.add_argument("action", choices=["register", "ticket"])
    p_auth.add_argument("--authnode", required=True)
    p_auth.add_argument("--id", help="client/service id (register)")
    p_auth.add_argument("--client-id")
    p_auth.add_argument("--service-id")
    p_auth.add_argument("--key", help="b64 client key (ticket)")

    args = ap.parse_args(argv)
    from .utils import rpc

    if args.group == "cluster":
        addr = args.master or args.clustermgr
        if not addr:
            sys.exit("need --master or --clustermgr")
        print(json.dumps(rpc.call(addr, "stat")[0], indent=2))

    elif args.group == "vol":
        master = rpc.Client(args.master)
        if args.action == "create":
            out = master.call("create_volume", {
                "name": args.name, "mp_count": args.mp_count,
                "dp_count": args.dp_count})[0]
        elif args.action == "update":
            if args.capacity is None:
                sys.exit("vol update needs --capacity")
            out = master.call("set_vol_capacity", {
                "name": args.name, "capacity": args.capacity})[0]
        else:
            out = master.call("client_view", {"name": args.name})[0]
        print(json.dumps(out, indent=2))

    elif args.group == "quota":
        master = rpc.Client(args.master)
        if args.action == "set":
            if not args.path:
                sys.exit("quota set needs --path")
            fs_args = argparse.Namespace(master=args.master, vol=args.vol)
            dir_ino = _fs(fs_args).resolve(args.path)
            out = master.call("set_quota", {
                "name": args.vol, "dir_ino": dir_ino,
                "max_bytes": args.max_bytes, "max_files": args.max_files})[0]
        elif args.action == "delete":
            if args.qid is None:
                sys.exit("quota delete needs --qid")
            out = master.call("delete_quota",
                              {"name": args.vol, "qid": args.qid})[0]
        elif args.action == "enforce":
            out = master.call("enforce_quotas", {})[0]
        else:
            out = master.call("list_quotas", {"name": args.vol})[0]
        print(json.dumps(out, indent=2))

    elif args.group == "fs":
        fs = _fs(args)
        a = args.args
        if args.action == "put":
            fs.write_file(a[1], open(a[0], "rb").read())
            print(f"put {a[0]} -> {a[1]}")
        elif args.action == "get":
            data = fs.read_file(a[0])
            open(a[1], "wb").write(data)
            print(f"get {a[0]} -> {a[1]} ({len(data)} bytes)")
        elif args.action == "ls":
            for name, ino in sorted(fs.readdir(a[0] if a else "/").items()):
                st = fs.meta.inode_get(ino)
                print(f"{st['type']:<8} {st['size']:>12} {name}")
        elif args.action == "rm":
            fs.unlink(a[0])
        elif args.action == "stat":
            print(json.dumps(fs.stat(a[0]), indent=2, default=str))
        elif args.action == "mkdir":
            fs.mkdir(a[0])
        elif args.action == "mv":
            fs.rename(a[0], a[1])

    elif args.group == "node":
        master = rpc.Client(args.master)
        if args.action == "decommission":
            if not args.addr:
                sys.exit("node decommission needs --addr")
            out = master.call("decommission_datanode", {"addr": args.addr})[0]
        elif args.action == "offline-disk":
            if not args.addr or not args.disk:
                sys.exit("node offline-disk needs --addr and --disk")
            out = master.call("offline_disk", {"addr": args.addr,
                                               "path": args.disk})[0]
        elif args.action == "disk-sweep":
            out = master.call("check_broken_disks", {})[0]
        else:
            out = master.call("node_list", {})[0]
        print(json.dumps(out, indent=2))

    elif args.group == "mp":
        master = rpc.Client(args.master)
        if args.action == "split":
            if not args.vol:
                sys.exit("mp split needs --vol")
            out = master.call("split_meta_partition", {"name": args.vol})[0]
        else:
            out = master.call("check_meta_partitions", {})[0]
        print(json.dumps(out, indent=2))

    elif args.group == "meta":
        from .sdk import MasterClient

        mc = MasterClient(args.master)
        if args.action == "split":
            if not args.vol:
                sys.exit("meta split needs --vol")
            out = mc.meta_split(args.vol, pid=args.pid,
                                split_ino=args.split_ino)
        elif args.action == "merge":
            if not args.vol:
                sys.exit("meta merge needs --vol")
            out = mc.meta_merge(args.vol, donor_pid=args.pid,
                                absorber_pid=args.absorber)
        elif args.action == "balance":
            out = mc.meta_balance(max_moves=args.max_moves)
        else:
            out = mc.meta_status(args.vol)
        print(json.dumps(out, indent=2))

    elif args.group == "user":
        from .sdk import MasterClient

        mc = MasterClient(args.master)
        if args.action == "create":
            if not args.user_id:
                sys.exit("user create needs --user-id")
            out = mc.create_user(args.user_id)
        elif args.action == "grant":
            if not (args.ak and args.vol):
                sys.exit("user grant needs --ak and --vol")
            mc.grant(args.ak, args.vol, args.perm)
            out = {"granted": f"{args.ak} -> {args.vol} ({args.perm})"}
        elif args.action == "revoke":
            if not (args.ak and args.vol):
                sys.exit("user revoke needs --ak and --vol")
            mc.revoke(args.ak, args.vol)
            out = {"revoked": f"{args.ak} -> {args.vol}"}
        elif args.action == "delete":
            if not args.ak:
                sys.exit("user delete needs --ak")
            mc.delete_user(args.ak)
            out = {"deleted": args.ak}
        else:
            out = mc.list_users()
        print(json.dumps(out, indent=2))

    elif args.group == "tasks":
        from .sdk import SchedulerClient

        sched = SchedulerClient(args.scheduler)
        if args.action == "stats":
            out = sched.stats()
        else:
            if args.action in ("enable", "disable") and not args.kind:
                sys.exit(f"tasks {args.action} needs --kind")
            out = sched.task_switch(args.action, args.kind)
        print(json.dumps(out, indent=2))

    elif args.group == "dp":
        if args.action == "raft-status":
            if not args.datanode or args.dp_id is None:
                sys.exit("dp raft-status needs --datanode and --dp-id")
            out = rpc.call(args.datanode, "dp_raft_status",
                           {"dp_id": args.dp_id})[0]
        elif args.action == "view":
            if not (args.master and args.vol):
                sys.exit("dp view needs --master and --vol")
            out = rpc.Client(args.master).call(
                "dp_view", {"name": args.vol})[0]
        else:  # check
            if not args.master:
                sys.exit("dp check needs --master")
            from .sdk import MasterClient

            out = {"actions": MasterClient(args.master).check_replicas()}
        print(json.dumps(out, indent=2))

    elif args.group == "cm":
        from .sdk.clients import ClusterMgrClient

        cmc = ClusterMgrClient(args.clustermgr)
        a = args.args
        needs = {"config-get": 1, "config-set": 2, "config-del": 1,
                 "kv-get": 1, "kv-set": 2, "kv-del": 1,
                 "scope-alloc": 1, "scope-next": 1}
        if len(a) < needs.get(args.action, 0):
            sys.exit(f"cm {args.action} needs {needs[args.action]} "
                     f"positional argument(s)")
        if args.action == "config-get":
            print(json.dumps({"value": cmc.get_config(a[0])}))
        elif args.action == "config-set":
            cmc.set_config(a[0], a[1])
        elif args.action == "config-del":
            cmc.delete_config(a[0])
        elif args.action == "config-list":
            print(json.dumps(cmc.list_config(), indent=2))
        elif args.action == "kv-get":
            print(json.dumps({"value": cmc.kv_get(a[0])}))
        elif args.action == "kv-set":
            cmc.kv_set(a[0], a[1])
        elif args.action == "kv-del":
            cmc.kv_delete(a[0])
        elif args.action == "kv-list":
            items, marker = cmc.kv_list(prefix=args.prefix,
                                        marker=a[0] if a else "",
                                        count=args.count)
            print(json.dumps({"items": items, "marker": marker}, indent=2))
        elif args.action == "scope-alloc":
            count = int(a[1]) if len(a) > 1 else 1
            print(json.dumps({"start": cmc.alloc_scope(a[0], count)}))
        elif args.action == "scope-next":
            meta, _ = rpc.call(args.clustermgr, "scope_watermark",
                               {"name": a[0]})
            print(json.dumps(meta))

    elif args.group == "mq":
        meta, _ = rpc.call(args.member, "mq_status", {})
        if args.topic != "all":
            if args.topic not in meta:
                sys.exit(f"no topic {args.topic!r}; have {sorted(meta)}")
            meta = {args.topic: meta[args.topic]}
        if args.action == "status":
            print(json.dumps(meta, indent=2))
        else:  # backlog
            total = {t: sum(p["backlog"] for p in st["partitions"])
                     for t, st in meta.items()}
            print(json.dumps(total))

    elif args.group == "flash":
        from .sdk import FlashClient, FlashGroupClient

        if args.action == "stats":
            if not args.flashnode:
                sys.exit("flash stats needs --flashnode")
            out = FlashClient(args.flashnode).stats()
        else:
            if not args.fgm:
                sys.exit(f"flash {args.action} needs --fgm")
            fgc = FlashGroupClient(args.fgm)
            if args.action == "ring":
                out = fgc.ring()
            elif args.action == "register-group":
                if args.group_id is None or not args.addrs:
                    sys.exit("needs --group-id and --addrs")
                fgc.register_group(args.group_id, args.addrs.split(","))
                out = {"registered": args.group_id}
            elif args.action == "remove-group":
                if args.group_id is None:
                    sys.exit("needs --group-id")
                fgc.remove_group(args.group_id)
                out = {"removed": args.group_id}
            else:  # set-status
                if args.group_id is None or not args.status:
                    sys.exit("needs --group-id and --status")
                fgc.set_group_status(args.group_id, args.status)
                out = {"group": args.group_id, "status": args.status}
        print(json.dumps(out, indent=2))

    elif args.group == "topology":
        if args.action == "fs":
            if not args.master:
                sys.exit("topology fs needs --master")
            out = rpc.call(args.master, "topology_view")[0]
        elif args.action == "tree":
            # az -> rack -> node map of the fs plane, with the
            # misplaced-replica gauge the sweep drives to zero
            if not args.master:
                sys.exit("topology tree needs --master")
            out = rpc.call(args.master, "topology_tree")[0]
        elif args.action == "blob":
            if not args.clustermgr:
                sys.exit("topology blob needs --clustermgr")
            out = rpc.call(args.clustermgr, "topology_view")[0]
        else:  # rebalance: one rate-limited sweep, prints the move count
            if not args.scheduler:
                sys.exit("topology rebalance needs --scheduler")
            q = {} if args.max_moves is None else {"max_moves": args.max_moves}
            out = rpc.call(args.scheduler, "rebalance", q)[0]
        print(json.dumps(out, indent=2))

    elif args.group == "metrics":
        text = _fetch_metrics(args.addr)
        if args.action == "raw":
            print(text, end="")
        elif args.action == "codec":
            print(json.dumps(_codec_view(text), indent=2))
        elif args.action == "repair":
            print(json.dumps(_repair_view(text), indent=2))
        elif args.action == "slo":
            print(json.dumps(_slo_view(text), indent=2))
        elif args.action == "read-path":
            print(json.dumps(_read_path_view(text), indent=2))
        elif args.action == "qos":
            print(json.dumps(_qos_view(text), indent=2))
        elif args.action == "tiering":
            print(json.dumps(_tiering_view(text), indent=2))
        elif args.action == "integrity":
            print(json.dumps(_integrity_view(text), indent=2))
        elif args.action == "wire":
            print(json.dumps(_wire_view(text), indent=2))
        elif args.action == "geo":
            print(json.dumps(_geo_view(text), indent=2))
        elif args.action == "meta":
            print(json.dumps(_meta_view(text), indent=2))
        else:
            print(json.dumps(_write_path_view(text), indent=2))

    elif args.group == "geo":
        from .sdk.clients import GeoClient

        geo = GeoClient(args.gateway)
        if args.action == "status":
            out = geo.status()
        else:
            out = geo.transition(args.action.replace("-", "_"),
                                 op_id=args.op_id)
        print(json.dumps(out, indent=2))

    elif args.group == "scrub":
        sched = rpc.Client(args.scheduler)
        if args.action == "run":
            out = sched.call("scrub_run", {
                "full": args.full, "max_units": args.max_units})[0]
        else:
            out = sched.call("scrub_status", {})[0]
        print(json.dumps(out, indent=2))

    elif args.group == "trace":
        if args.action == "show":
            if not args.trace_id:
                sys.exit("trace show needs a trace_id")
            out = _fetch_json(args.addr, f"/traces?trace_id={args.trace_id}")
            if args.json:
                print(json.dumps(out, indent=2))
            else:
                print(f"trace {out['trace_id']}")
                print(out.get("render") or "(no spans collected)")
        elif args.action == "slow":
            out = _fetch_json(args.addr, f"/traces?top={args.top}")
            slow = out.get("slow", [])
            if args.json:
                print(json.dumps(slow, indent=2))
            else:
                for rec in slow:
                    print(f"{rec['duration_ms']:>10.2f}ms  "
                          f"{rec['path']:<14} {rec['trace_id']}  "
                          f"{rec.get('stages', '')}")
                if not slow:
                    print("(no slow traces captured; set CUBEFS_SLOW_MS)")
        else:  # list
            out = _fetch_json(args.addr, "/traces")
            print(json.dumps(out.get("trace_ids", []), indent=2))

    elif args.group == "sanitize":
        import os

        from .utils import lockwitness

        path = args.path or os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "artifacts", "SANITIZE_WITNESS.json")
        if not os.path.exists(path):
            sys.exit(f"no witness dump at {path} — run the suite with "
                     "CUBEFS_SANITIZE=1 first (tests/conftest.py dumps "
                     "the evidence when the run ends)")
        data = json.load(open(path))
        if args.json:
            print(json.dumps(data, indent=2))
        else:
            live = "on" if lockwitness.enabled() else "off"
            edges = data.get("edges", [])
            print(f"lock witness (this process: CUBEFS_SANITIZE {live})")
            print(f"  acquisitions      {data.get('acquisitions', 0)}")
            print(f"  max held depth    {data.get('max_held_depth', 0)}")
            print(f"  rpc checks        {data.get('rpc_checks', 0)}")
            print(f"  instance overlaps {data.get('instance_overlaps', 0)}")
            print(f"  locks seen        {len(data.get('locks_seen', []))}")
            print(f"  order edges       {len(edges)}")
            for e in edges:
                print(f"    {e['src']} -> {e['dst']}  "
                      f"(thread {e.get('thread', '?')!r}, "
                      f"acquired at {e.get('acquired_at', '?')})")

    elif args.group == "auth":
        import base64

        from .sdk import AuthClient

        ac = AuthClient(args.authnode)
        if args.action == "register":
            if not args.id:
                sys.exit("auth register needs --id")
            out = {"id": args.id,
                   "key": base64.b64encode(ac.register(args.id)).decode()}
        else:  # ticket
            if not (args.client_id and args.service_id and args.key):
                sys.exit("auth ticket needs --client-id --service-id --key")
            out = ac.get_ticket(args.client_id, args.service_id,
                                base64.b64decode(args.key))
        print(json.dumps(out, indent=2))

    elif args.group == "blob":
        a = args.args
        if args.action in ("put", "get", "delete", "stat") and not args.access:
            sys.exit(f"blob {args.action} needs --access")
        if args.action == "put":
            data = open(a[0], "rb").read()
            meta, _ = rpc.call(args.access, "put", {}, data)
            print(json.dumps(meta["location"]))
        elif args.action == "get":
            loc = json.load(open(a[0]))
            _, data = rpc.call(args.access, "get", {"location": loc})
            open(a[1], "wb").write(data)
            print(f"{len(data)} bytes")
        elif args.action == "delete":
            loc = json.load(open(a[0]))
            rpc.call(args.access, "delete", {"location": loc})
        elif args.action == "stat":
            print(json.dumps(rpc.call(args.access, "stat")[0], indent=2))
        elif args.action in ("vols", "disks", "disk-status"):
            if not args.clustermgr:
                sys.exit(f"blob {args.action} needs --clustermgr")
            cm_client = rpc.Client(args.clustermgr)
            if args.action == "vols":
                q = {} if args.status is None else {"status": args.status}
                out = cm_client.call("list_volumes", q)[0]
            elif args.action == "disks":
                out = cm_client.call("list_disks", {})[0]
            else:  # disk-status (offline/online a blob disk)
                if args.disk_id is None or args.status is None:
                    sys.exit("blob disk-status needs --disk-id and --status")
                cm_client.call("set_disk_status", {
                    "disk_id": args.disk_id, "status": args.status})
                out = {"disk_id": args.disk_id, "status": args.status}
            print(json.dumps(out, indent=2))
        elif args.action in ("chunks", "compact"):
            if not (args.blobnode and args.disk_id is not None
                    and args.chunk_id is not None):
                sys.exit(f"blob {args.action} needs --blobnode --disk-id "
                         f"--chunk-id")
            method = "list_chunk" if args.action == "chunks" else "compact_chunk"
            out = rpc.call(args.blobnode, method, {
                "disk_id": args.disk_id, "chunk_id": args.chunk_id})[0]
            print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
