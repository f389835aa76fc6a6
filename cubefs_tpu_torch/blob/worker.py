"""Repair worker: pulls unit-repair tasks and reconstructs on the codec.

Role parity: blobstore/blobnode worker (loopAcquireTask at
worker_service.go:206; ShardRecover download-and-reconstruct at
worker_slice_recover.go:458,865; CRC cross-check at :45).

Device-first redesign: instead of reconstructing blob-by-blob, a task's
blobs are grouped by shard size and recovered as BATCHED stripe stacks
(B, n, S) in one device call — the migrate fleet's throughput rides the
batch dimension.

The port's copy of ``cubefs_tpu/blob/worker.py``: the repair leg (RS,
LRC and MSR rows, batched ``matrix_apply`` of up to ``batch_stripes``
stripes, the MSR sub-shard path and its fallback, the extra-survivor
check that refuses writeback). A worker takes a ``device`` beside the
engine name; its engine comes from ``codecio`` (None: the reference's
default, ``CUBEFS_TPU_EC_ENGINE`` or the card). Shard-replica swaps
(``shard_repair``/``shard_migrate`` tasks) are the reference's RPCs to
the shardnodes. ``CUBEFS_CODEC_MSR=0`` pins MSR-coded volumes to the
conventional repair rows, as in the reference.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from collections import defaultdict

import numpy as np

from ..ops import rs_kernel
from ..codec import codemode as cm
from ..codec.engine import last_dispatch
from ..utils import metrics, rpc
from ..utils import trace as tracelib
from . import codecio, topology
from .types import VolumeInfo


def _msr_repair_enabled() -> bool:
    """CUBEFS_CODEC_MSR=0 pins MSR-coded volumes to the conventional
    k-full-shard repair path (the A/B door; reconstruction stays
    byte-identical either way, only the traffic shape changes)."""
    return os.environ.get("CUBEFS_CODEC_MSR", "1").lower() not in (
        "0", "false", "")


class MsrFallback(Exception):
    """Raised inside the MSR sub-shard path to hand the repair to the
    conventional decode — always BEFORE any writeback, so the fallback
    re-runs from scratch with no partial writes to undo."""

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        super().__init__(detail or reason)


class RepairWorker:
    def __init__(self, scheduler_client: rpc.Client, cm_client: rpc.Client,
                 node_pool, engine: str | None = "auto",
                 worker_id: str | None = None, batch_stripes: int = 64,
                 device=None):
        self.sched = scheduler_client
        self.cm = cm_client
        self.nodes = node_pool
        # 'auto' + admission: repair legs inherit the measured
        # crossover policy AND coalesce with concurrent PUT encodes
        # into shared device steps (codec/batcher.py)
        self.codec = codecio.engine(device, engine)
        self.worker_id = worker_id or uuid.uuid4().hex[:12]
        self.batch_stripes = batch_stripes
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.completed = 0
        self.failed = 0

    # ---------------- loop ----------------
    def start(self, idle_wait: float = 0.5) -> None:
        def loop():
            while not self._stop.wait(0 if self.run_once() else idle_wait):
                pass

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def run_once(self) -> bool:
        """Acquire and execute one task; returns True if one was run."""
        meta, _ = self.sched.call("acquire_task", {"worker_id": self.worker_id})
        task = meta.get("task")
        if not task:
            return False
        try:
            self.execute(task)
            self.sched.call("complete_task",
                            {"task_id": task["task_id"], "worker_id": self.worker_id})
            self.completed += 1
            metrics.repair_tasks.inc(state="completed")
        except Exception as e:
            self.sched.call(
                "fail_task",
                {"task_id": task["task_id"], "worker_id": self.worker_id,
                 "error": f"{type(e).__name__}: {e}"},
            )
            self.failed += 1
            metrics.repair_tasks.inc(state="failed")
        return True

    # ---------------- execution ----------------
    def execute(self, task: dict) -> None:
        # renew the lease on a timer for the whole execution: survivor
        # downloads for a large chunk can exceed one lease period long
        # before the first batch writes back
        renew_stop = threading.Event()

        def renew_loop():
            while not renew_stop.wait(10.0):
                try:
                    self.sched.call("renew_task",
                                    {"task_id": task["task_id"],
                                     "worker_id": self.worker_id})
                except Exception:
                    pass

        renewer = threading.Thread(target=renew_loop, daemon=True)
        renewer.start()
        try:
            self._execute(task)
        finally:
            renew_stop.set()

    def _execute(self, task: dict) -> None:
        with tracelib.path_span("blob.repair", "worker.repair") as sp:
            sp.set_tag("svc", "worker").set_tag("task", task["type"])
            self._execute_traced(task, sp)

    def _execute_traced(self, task: dict, sp) -> None:
        if task["type"] in ("shard_repair", "shard_migrate"):
            return self._execute_shard_swap(task)
        vol = VolumeInfo.from_dict(
            self.cm.call("get_volume", {"vid": task["vid"]})[0]["volume"]
        )
        t = cm.tactic(vol.codemode)
        bad = int(task["unit_index"])

        # discover the blob population from surviving units' chunk listings
        bids = self._list_bids(vol, exclude=bad)
        dest = self.nodes.get(task["dest_addr"])
        if not bids:
            return  # empty chunk: nothing to rebuild

        if t.is_msr() and _msr_repair_enabled():
            try:
                return self._execute_msr(task, vol, t, bad, bids, dest)
            except MsrFallback as e:
                # exactly-once degradation: the sub-shard path never
                # wrote anything (reads and verification both precede
                # writeback), so the conventional decode below rebuilds
                # from scratch
                metrics.repair_msr_fallbacks.inc(reason=e.reason)
                sp.set_tag("msr_fallback", e.reason)
        self._execute_conventional(task, vol, t, bad, bids, dest)

    def _execute_conventional(self, task: dict, vol: VolumeInfo,
                              t: cm.Tactic, bad: int, bids: list[int],
                              dest) -> None:
        # choose the read set: prefer the bad unit's local stripe peers
        # when an LRC local repair is possible (intra-AZ bandwidth). A
        # dark AZ (blackout) starves the local read set entirely — fall
        # back to the global stripe, which can also re-encode a lost
        # LOCAL PARITY through its stripe members (lrc_reconstruct_rows).
        # code_pos maps unit index -> index within the solving code's
        # shard space.
        local_idx, ln, lm = t.local_stripe(bad) if t.l else ([], 0, 0)
        sources = (["local", "global"] if local_idx and bad in local_idx
                   else ["global"])
        with tracelib.stage("survivor_reads"):
            for source in sources:
                if source == "local":
                    read_set = [i for i in local_idx if i != bad]
                    n_solve, total_code = ln, ln + lm
                    code_pos = {u: s for s, u in enumerate(local_idx)}
                    bad_sub = code_pos[bad]
                else:
                    read_set = [i for i in range(t.n + t.m) if i != bad]
                    n_solve, total_code = t.n, t.n + t.m
                    code_pos = {u: u for u in read_set}
                    bad_sub = bad

                # per-bid survivor reads (one EXTRA when available: the
                # extra is reconstructed from the first n and compared,
                # the pre-writeback consistency check — a corrupted
                # download must not become the new truth). The ACTUALLY-
                # read survivor set selects the decode matrix, so per-
                # shard read failures mid-task are fine.
                want = min(n_solve + 1, len(read_set))
                by_key: dict[tuple, list] = defaultdict(list)
                try:
                    for bid in bids:
                        subs, shards = self._read_survivors(
                            vol, read_set, code_pos, bid, need=n_solve,
                            want=want, failed_az=vol.units[bad].az)
                        by_key[(len(shards[0]), tuple(subs))].append(
                            (bid, shards))
                except RuntimeError:
                    if source != sources[-1]:
                        continue  # local stripe unreadable: widen global
                    raise
                break

        self._decode_writeback(task, t, by_key, n_solve, total_code,
                               bad_sub, dest)

    def _decode_writeback(self, task, t, by_key, n_solve, total_code,
                          bad_sub, dest) -> None:
        writes: list[tuple[int, bytes]] = []
        with tracelib.stage("decode"):
            self._decode_groups(t, by_key, n_solve, total_code, bad_sub,
                                writes)
        with tracelib.stage("writeback"):
            for bid, shard in writes:
                dest.call(
                    "put_shard",
                    {"disk_id": task["dest_disk"],
                     "chunk_id": task["dest_chunk"], "bid": bid},
                    shard,
                )

    def _decode_groups(self, t, by_key, n_solve, total_code, bad_sub,
                       writes) -> None:
        for (size, subs), group in by_key.items():
            solve_subs = list(subs[:n_solve])
            wanted_out = [bad_sub]
            if len(subs) > n_solve:  # reconstruct bad + the extra survivor
                wanted_out = sorted({bad_sub, subs[n_solve]})
                verify_pos = wanted_out.index(subs[n_solve])
            if bad_sub >= total_code:
                # global fallback for a LOCAL PARITY unit: its row lives
                # outside the global code space, so compose the local
                # encode row with the global solve
                rows = rs_kernel.lrc_reconstruct_rows(
                    n_solve, total_code, t.ec_layout_by_az(),
                    (t.n + t.m) // t.az_count, solve_subs, wanted_out
                )
            elif t.is_msr():
                # conventional decode of an MSR-coded stripe: k full
                # shards solved with the product-matrix generator over
                # the sub-shard space (the helper-failure fallback)
                rows = rs_kernel.msr_reconstruct_rows(
                    n_solve, total_code, t.d,
                    tuple(solve_subs), tuple(wanted_out))
            else:
                rows = rs_kernel.reconstruct_rows(
                    n_solve, total_code, solve_subs, wanted_out
                )
            out_pos = wanted_out.index(bad_sub)
            for start in range(0, len(group), self.batch_stripes):
                chunk = group[start : start + self.batch_stripes]
                batch = np.stack([
                    np.stack([np.frombuffer(s, dtype=np.uint8)
                              for s in shards[:n_solve]])
                    for _, shards in chunk
                ])  # (B, n_solve, size)
                if t.is_msr() and bad_sub < total_code:
                    if size % t.alpha:
                        raise RuntimeError(
                            f"shard size {size} not divisible by "
                            f"alpha={t.alpha}: not MSR-encoded")
                    sub = batch.reshape(
                        len(chunk), n_solve * t.alpha, size // t.alpha)
                    recovered = self.codec.matrix_apply(rows, sub).reshape(
                        len(chunk), len(wanted_out), size)
                else:
                    recovered = self.codec.matrix_apply(rows, batch)
                # which leg actually decoded (post-fallback, post-door):
                # the degraded-mode evidence the XOR_AB drill reads back
                metrics.repair_codec_leg.inc(
                    leg=last_dispatch.get("served") or "unknown")
                for (bid, shards), rec in zip(chunk, recovered):
                    if len(subs) > n_solve:
                        expect = np.frombuffer(shards[n_solve], dtype=np.uint8)
                        if not np.array_equal(rec[verify_pos], expect):
                            raise RuntimeError(
                                f"bid {bid}: reconstruction disagrees with "
                                f"extra survivor {subs[n_solve]} — refusing "
                                f"writeback (crc-conflict role)"
                            )
                    writes.append((bid, rec[out_pos].tobytes()))

    def _execute_msr(self, task: dict, vol: VolumeInfo, t: cm.Tactic,
                     bad: int, bids: list[int], dest) -> None:
        """Sub-shard repair of one failed MSR unit: pull a single
        beta-sized helper symbol per bid from each of d helpers
        (d*S/alpha bytes total vs the conventional k*S), solve the
        cached product-matrix repair rows, verify against an extra
        helper's symbol, THEN write back. Any miss before writeback
        raises MsrFallback — the conventional path owns the retry."""
        k, total, d, alpha = t.n, t.total, t.d, t.alpha
        with tracelib.stage("helper_election"):
            try:
                order = topology.pick_repair_helpers(vol.units, bad, d)
            except topology.NoAvailableDisks as e:
                raise MsrFallback("helpers_unavailable", str(e)) from None
            helpers = tuple(order[:d])
            extra = order[d] if len(order) > d else None
            coeff = rs_kernel.msr_helper_rows(k, total, d, bad)[0].tolist()
        failed_az = vol.units[bad].az

        # ONE read_subshard RPC per helper, batched over every bid; all
        # network reads land before any math or writeback, so a helper
        # dying mid-repair costs nothing but the fallback
        per_bid: dict[int, dict[int, bytes]] = {b: {} for b in bids}
        with tracelib.stage("beta_pulls"):
            for h in helpers + ((extra,) if extra is not None else ()):
                u = vol.units[h]
                try:
                    meta, raw = self.nodes.get(u.node_addr).call(
                        "read_subshard",
                        {"disk_id": u.disk_id, "chunk_id": u.chunk_id,
                         "bids": bids, "coeff": coeff})
                    sizes = meta["sizes"]
                    if len(sizes) != len(bids):
                        raise rpc.RpcError(409, f"{len(sizes)} sizes for "
                                                f"{len(bids)} bids")
                except rpc.RpcError as e:
                    if h == extra:
                        extra = None  # verification extra is best-effort
                        continue
                    raise MsrFallback(
                        "helper_read", f"helper unit {h}: {e}") from None
                scope = ("az_local" if u.az == failed_az else "cross_az")
                metrics.repair_bytes_pulled.inc(len(raw), scope=scope)
                off = 0
                for bid, beta in zip(bids, sizes):
                    per_bid[bid][h] = raw[off:off + beta]
                    off += beta

        # repair math + the extra-helper prediction are ONE fused device
        # step, so the "verify" stage covers both
        writes: list[tuple[int, bytes]] = []
        with tracelib.stage("verify"):
            rows = rs_kernel.msr_repair_rows(k, total, d, bad, helpers)
            if extra is not None:
                # verification rides the SAME device step: one stacked
                # (alpha+1, d) matrix predicts the extra helper's symbol
                # alongside the repair — a corrupt download breaks the
                # prediction before it can become the new truth
                rows = np.concatenate(
                    [rows, rs_kernel.msr_verify_rows(
                        k, total, d, bad, helpers, extra)])
            groups: dict[int, list[int]] = defaultdict(list)
            for bid in bids:
                sym = per_bid[bid]
                beta = len(sym[helpers[0]])
                if any(len(sym[h]) != beta for h in helpers):
                    raise MsrFallback(
                        "helper_read",
                        f"bid {bid}: helper symbol widths differ")
                groups[beta].append(bid)

            for beta, group in groups.items():
                for start in range(0, len(group), self.batch_stripes):
                    chunk = group[start:start + self.batch_stripes]
                    batch = np.stack([
                        np.stack([np.frombuffer(per_bid[b][h],
                                                dtype=np.uint8)
                                  for h in helpers])
                        for b in chunk
                    ])  # (B, d, beta)
                    out = self.codec.matrix_apply(rows, batch)
                    metrics.repair_codec_leg.inc(
                        leg=last_dispatch.get("served") or "unknown")
                    for i, b in enumerate(chunk):
                        if extra is not None:
                            expect = np.frombuffer(
                                per_bid[b].get(extra, b""), dtype=np.uint8)
                            if (expect.size != beta
                                    or not np.array_equal(out[i, alpha],
                                                          expect)):
                                raise MsrFallback(
                                    "verify",
                                    f"bid {b}: repair disagrees with extra "
                                    f"helper {extra}'s symbol")
                        writes.append(
                            (b, out[i, :alpha].reshape(-1).tobytes()))
        with tracelib.stage("writeback"):
            for bid, shard in writes:
                dest.call(
                    "put_shard",
                    {"disk_id": task["dest_disk"],
                     "chunk_id": task["dest_chunk"], "bid": bid},
                    shard,
                )

    def _execute_shard_swap(self, task: dict) -> None:
        """shard_repair / shard_migrate execution (shard_disk_repairer
        role): swap one replica of a shard's raft group. Raft moves the
        data — the new member starts empty and the leader catches it up
        (appends or InstallSnapshot); this choreography is idempotent,
        so a lease expiry mid-way just re-runs it.

        Order matters: the NEW member must exist before survivors
        repoint at it, or the shrunk group could elect without it."""
        new_addrs = task["new_addrs"]
        dest = self.nodes.get(task["dest_addr"])
        dest.call("create_shard", {
            "shard_id": task["shard_id"], "start": task["start"],
            "end": task["end"], "peers": new_addrs})
        # re-issue the peer list on the destination too: a retried task
        # may find the shard pre-created with a stale set
        dest.call("update_shard_peers", {
            "shard_id": task["shard_id"], "peers": new_addrs})
        for addr in new_addrs:
            if addr == task["dest_addr"]:
                continue
            self.nodes.get(addr).call("update_shard_peers", {
                "shard_id": task["shard_id"], "peers": new_addrs})
        # the old replica (if it still answers) leaves the group; best
        # effort — a dead node is the usual reason we're here
        try:
            self.nodes.get(task["src_addr"]).call("update_shard_peers", {
                "shard_id": task["shard_id"], "peers": list(new_addrs)})
        except Exception:
            pass

    def _list_bids(self, vol: VolumeInfo, exclude: int) -> list[int]:
        for u in vol.units:
            if u.index == exclude:
                continue
            try:
                meta, _ = self.nodes.get(u.node_addr).call(
                    "list_chunk", {"disk_id": u.disk_id, "chunk_id": u.chunk_id}
                )
                return [b for b, _, _ in meta["shards"]]
            except rpc.RpcError:
                continue
        raise RuntimeError(f"vid {vol.vid}: no unit listable")

    def _read_survivors(
        self, vol: VolumeInfo, read_set: list[int], code_pos: dict[int, int],
        bid: int, need: int, want: int | None = None, failed_az: str = "",
    ) -> tuple[list[int], list[bytes]]:
        """Read up to `want` survivors for bid (at least `need`, which is
        fatal to miss; the extras enable pre-writeback verification).
        Returns (code-space indices actually read, payloads), ascending."""
        want = want or need
        subs: list[int] = []
        shards: list[bytes] = []
        for idx in read_set:
            if len(shards) == want:
                break
            u = vol.units[idx]
            try:
                _, payload = self.nodes.get(u.node_addr).call(
                    "get_shard",
                    {"disk_id": u.disk_id, "chunk_id": u.chunk_id, "bid": bid},
                )
            except rpc.RpcError:
                continue
            metrics.repair_bytes_pulled.inc(
                len(payload),
                scope="az_local" if u.az == failed_az else "cross_az")
            subs.append(code_pos[idx])
            shards.append(payload)
        if len(shards) < need:
            raise RuntimeError(f"bid {bid}: only {len(shards)}/{need} survivors")
        order = np.argsort(subs)
        return [subs[i] for i in order], [shards[i] for i in order]
