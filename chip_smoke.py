#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port, ``cubefs_tpu_torch``.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout,
holds each against its plain PyTorch version at the width of the
production EC12P4 codemode (RS(12+4), 4 MiB shards), at the LRC and MSR
shapes (EC16P20L2's composed 22x16 rows, EC6P6MSR's 36x36 rows, helper
row and repair rows at beta = 699,051) and on the edges of their
designs (ragged and unaligned shards, parity written in place, strided
and unaligned CRC blocks of odd lengths), times each whole call with
CUDA events (``ms``) and each kernel alone from the profiler's CUDA
trace (``device_ms``, host work excluded), then drives the port's main
path through its public entry points (encode and reconstruct of a
48 MiB payload, the pinned RS(12+4) fixture, the repair step with a
corrupted survivor, blob frame verification) and checks that the path
launched both of its kernels. Then the codec families (EC16P20L2 and
EC6P6MSR stripes at full width, the pinned EC16P20L2 fixture, the MSR
sub-shard repair of every slot with a corrupted helper symbol) and the
codec batcher (concurrent small PUTs from 32 threads, of one size and
of mixed sizes) and its dp split (phase ``batcher_dp``: an EC12P4 step
of 8 stripes at 4 MiB shards cut over the card named twice, device
tensors and host stripes, encode and reconstruct, and a missing card
refused), each held against the plain version and the unbatched
launches, with the launch counts of each path read from zero. It times the entry points end to
end. Then it drives the GF tuning path (``tuning/gf_tuning.py``, both
rounds), which runs the bit-matrix tensor-core kernels, and checks that
it launched them. Last, the sharded codec step (``parallel/``): 8 ranks
spawned on the card (gloo, or NCCL where 8 cards are visible) run the
encode, repair and CRC on a mixed (2, 2, 2) mesh at the repair case's
width and on a dp-only (8, 1, 1) fleet, each rank on its own block
through A and B, every block held exactly against the plain version,
the single-rank path, the lost shards and zlib. Before it, the codec
service: the server's ``codec`` role started as its users start it
(``python -m cubefs_tpu_torch.cmd``) in a process of its own, driven
over its wire with ``http.client`` (8 MiB blobs over the body, 4 MiB
shards through ``/dev/shm``, CRCs, verify, 32 concurrent clients, four
refusals), every reply held against the plain versions and zlib, the
coalescing and byte counts read from its ``/metrics``. After the codec
engine layer (host legs, the measured ``auto`` crossover), the blob
plane (``cubefs_tpu_torch/blob/``): an in-process cluster of 6 blobnodes
x 3 disks PUTs 64 MiB objects under ``auto`` and ``cuda``, reads them
back healthy and with two disks down, repairs a broken disk through the
scheduler and the worker and an EC6P6MSR unit through the sub-shard
path, every byte held against what was written and the parity on disk
against the plain version. Then the same plane as its users start it
(phase ``roles``): the launcher (``cubefs_tpu_torch/deploy/cluster.py``)
starts a clustermgr, 6 blobnodes x 3 disks, a proxy, access and a
scheduler, each a ``python -m cubefs_tpu_torch.cmd`` process with its
audit log; 64 MiB objects go in and out over HTTP, healthy and with one
blobnode process stopped, kernel A counted from the access process's
``/metrics``, one PUT's trace read across the processes' ``/spans`` and
``/traces``. Then the replicated plane (phase ``raft``): a clustermgr
raft group of 3, 6 blobnodes x 3 disks, 3 schedulers hosting the
replicated repair/delete bus and access producing into it, each a
process on static ports; PUTs and GETs across a clustermgr leader kill
(the election timed) and the killed member's restart from its raft WAL,
degraded GETs with a blobnode process stopped, and the repair backlog
held across the loss of a bus member. Then the integrity sweep (phase
``integrity``): in process, with phase ``blob``'s cluster, the
scheduler's scrub verifies 1 GiB of objects with kernel A as its parity
recompute, finds 4 planted bitflips, queues repairs of exactly those
units, and the worker rebuilds them; read-repair, with and without
``CUBEFS_VERIFY_READS``, and the scrub's doors (``CUBEFS_SCRUB``, a
brownout, ``CUBEFS_QOS``). Then the metadata shards (phase
``shardnode``, host only): 3 shardnodes on raft over the native KV store
take 4,096 items from 8 clients, split a shard, lose a node whose
replicas the scheduler's shard tasks move to a spare, and restart from
their directories. Then the file-system plane (phase ``fs``): the
launcher starts a master, 3 metanodes, 4 datanodes (replicas 3) and a
volume of 3 meta and 4 data partitions beside a clustermgr and 6
blobnodes x 3 disks, each a process; the client in this process writes
16 files of 64 MiB from 4 threads over the packet plane, reads them
through the native read plane, creates, stats, renames and unlinks small
files from 8 threads (group commit read from the metanodes'
``/metrics``), tiers 4 aged files by a lifecycle scan into the blob plane
(kernel A encodes each tier PUT here, and rebuilds each cold read with a
blobnode process stopped), holds their parity against the plain version,
re-heats one, reaps, and reads every file again with a datanode process
stopped. Then the S3 gateway (phase ``s3``): the same planes and the
``objectnode`` role, every request SigV4-signed over ``http.client``:
8 objects of 64 MiB from 4 threads read back whole and in ranges, a
256 MiB multipart upload in 32 parts of 8 MiB, 1,024 small objects PUT,
HEAD and GET from 8 threads, listed in pages of 1,000 and batch-deleted,
three refusals, and 4 objects tiered by the bucket's own lifecycle rule
(kernel A encodes each tier PUT in this process), their parity held
against the plain version, read cold through a gateway in this process,
healthy and with a blobnode process stopped (A rebuilds). Then the
file-system plane's three doors (phase ``fs_doors``): phase ``fs``'s
planes with a flash group manager and two flash groups of 2 flashnodes,
one group per AZ, each a process; 4 tiered files held across a live
metapartition split raced by 4 threads of creates, then a merge and a
balance sweep (every replica's digest equal, the tiered files read cold
through kernel A with a blobnode process stopped); the AZ-local flash
read tier with its hotness gate, eviction, a flashnode killed mid-read
and an overwrite invalidating every AZ's copy; and geo-replication of
16,384 inode records between two regions in this process, a snapshot
bootstrap over the packet mux and a fenced failover and failback. Then
the clients and mounts (phase ``clients``): the launcher adds the
``codec``, ``fsgateway`` and ``console`` roles to phase ``fs``'s planes
with a proxy and access, and a ``fuseclient`` mounts the volume; the
port's C library (``runtime/nativeclient``, built here by g++) drives the
codec role (A and B), the access role (64 MiB objects, A on the PUT
stacks and the degraded GETs) and the gateway (``tests/c/fs_abi_test.c``
compiled by gcc, 1 GiB in 1 MiB ``cfs_pwrite`` calls from 4 threads), a
gateway and a FUSE mount in this process serve 2 tiered files cold
(A rebuilds with a blobnode process stopped), and the typed SDK clients
drive the master, clustermgr and console. Then the operator plane and
the tools (phase ``operators``): phase ``fs``'s planes beside the blob
roles, driven through the CLI (``python -m cubefs_tpu_torch.cli``) as
operators run it: a volume created, 64 MiB files and objects in and out,
the views, a ``scrub run --full`` on a scheduler role that finds 4 bits
flipped on the blobnodes' disks (A its parity recompute, the repair
worker here rebuilding each unit), ``fsck`` finding and healing a
replica mismatch and the FS scrubber a second, a snapshot restored to
the live state, the dial prober and the blob bench, and in this process
``bench_codec``'s batched and repair legs and ``tier_ab`` on the card.
Then the file-system plane's benchmark harness and the build check of the
kernels (phase ``fs_bench``): ``python -m cubefs_tpu_torch.tool.bench_fs``
(the mdtest/fio run, the wire, split and geo A/Bs) and ``python -m
cubefs_tpu_torch.tool.aot_cuda`` (the three sources compiled for
``sm_90a`` with nvcc alone, ptxas' figures for every kernel symbol), each
a process of its own, held by their identity fields.
Each phase prints one JSON line; any failure, in any rank, raises.
Each phase has a deadline (``PHASE_BUDGETS``, about 1.5 times its time
in a whole run on the card) under one for the whole script
(``SCRIPT_BUDGET``): the ``Watchdog`` re-armed at each phase prints
``{"phase": ..., "overran_s": ...}`` and every thread's stack when one
passes, stops every process the script started and exits 1.

The last lines are the kernels' record, the card's name and power limit
as nvidia-smi reports them, and ``{"ok": true, "device": {...}}``.
Without a CUDA device, or outside a checkout of the repository, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import functools
import http.client
import itertools
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SEED = 20261016
MIB = 1 << 20
SHARD = 4 * MIB  # EC12P4 production shard size
MSR_PAYLOAD = 24 * MIB  # an EC6P6MSR blob: shards of 4 MiB + 2, beta = 699,051
PUT = MIB  # a small blob PUT, as the access layer sends them concurrently
KERNEL_REPS = 10
DP_STRIPES = 8  # phase batcher_dp: a split step of 8 EC12P4 stripes, 384 MiB in
PLAIN_REPS = 3
MAIN_KERNELS = ("gf_apply", "crc32_blocks")  # repair_step and Encoder run these
# the sharded step's meshes on 8 ranks: the mixed mesh at the repair case's
# width, then the reference dryrun's dp-only fleet at its widths (32 stripes,
# 96 MiB of survivors: cut from its 64 to make room for phase batcher_dp)
SHARDED_RUNS = (
    {"name": "mixed", "dims": {"dp": 2, "tp": 2, "sp": 2}, "seed": SEED, "b": 4, "n": 12,
     "m": 4, "s": SHARD, "bad": [1, 7]},
    {"name": "dp_only", "dims": {"dp": 8, "tp": 1, "sp": 1}, "seed": SEED + 1, "b": 32,
     "n": 12, "m": 4, "s": 256 << 10, "bad": [2, 13]},
)
# phase service: the codec role as its users start it ("listen_port": 0 takes
# a free port), an access-layer blob (blob_size = 8 MiB: EC12P4 shards of
# 699,051 bytes, A's byte-load path) and the timed calls a case makes
SERVICE_CFG = {"role": "codec", "listen_port": 0}
BLOB = 8 * MIB
SERVICE_REPS = 5
# phase engines: the five legs of the codec engine layer, the stripe sizes
# of the crossover's classes, the beyond-table step and the concurrent PUTs
LEGS = ("cuda", "cpp", "cpp-xor", "numpy-xor", "numpy")
BEYOND_TABLE = 64 * MIB
ENGINE_THREADS, ENGINE_PUTS = 32, 8
ENGINES_CFG = {"role": "codec", "listen_port": 0, "ec_engine": "auto"}
BLOB_PUT = 64 * MIB  # phase blob: an object of eight 8 MiB blobs, EC12P4 by policy
BLOB_PUTS = 4  # per engine (cut from 8 for phase batcher_dp)
BLOB_MSR = 24 * MIB  # one EC6P6MSR object: three 8 MiB blobs
BLOB_NODES, BLOB_DISKS = 6, 3  # EC12P4's 16 units and 2 spares
# phases roles, raft and integrity: 64 MiB objects PUT, read back, read
# degraded (cut from 8, 4 and 16 for phase batcher_dp)
ROLES_PUTS = 4  # phase roles
RAFT_PUTS = 2  # phase raft: on each side of a clustermgr leader kill
INTEGRITY_OBJECTS = 8  # phase integrity: 512 MiB of user data
INTEGRITY_GETS = 8  # foreground GETs alone and under a full scrub pass
# phase shardnode: 1 MiB of 1 KiB items (cut from 16,384 items when phase
# clients was added, from 8,192 when phase operators was: the script ran
# 1,130 s with it, its limit 1,200; and from 4,096 for phase batcher_dp)
SN_ITEMS, SN_VALUE, SN_THREADS = 1024, 1024, 8
# phase fs: 4 files of 64 MiB from 4 writers (cut from 16 for phase
# batcher_dp), 8 threads x 64 files of 4 KiB (cut from 1,024 a thread:
# 8,192 creates, renames and stats took 243 s on the card's host; from 256
# when phase operators was added, and from 128 for phase batcher_dp), 2
# files tiered (cut from 4)
FS_FILES, FS_FILE, FS_WRITERS = 4, 64 * MIB, 4
FS_META_THREADS, FS_META_FILES, FS_META_SIZE = 8, 64, 4096
FS_TIER = 2
# phase s3: the objectnode role over the same planes; 4 objects of 64 MiB
# from 4 threads (cut from 16 when phase operators was added, and from 8
# for phase batcher_dp), one multipart object of 128 MiB in 16 parts of
# 8 MiB (the AWS CLI's multipart_chunksize; cut from 32 parts for phase
# batcher_dp), 8 threads x 128 objects of 4 KiB (phase fs's cut), listings
# and DeleteObjects in pages of 1,000 (S3's default max-keys and its batch
# cap; the 1,024 small objects keep the listing at 2 pages), 2 objects
# tiered (cut from 4)
S3_OBJECTS, S3_OBJECT, S3_WRITERS = 4, 64 * MIB, 4
S3_MULTIPART, S3_PART = 128 * MIB, 8 * MIB
S3_SMALL_THREADS, S3_SMALL, S3_SMALL_SIZE = 8, 128, 4096
S3_PAGE = 1000
S3_TIER = 2
# phase fs_doors: phase fs's cluster with a flash group manager and two flash
# groups (az-a, az-b) of 2 flashnodes at the role's default of 256 MiB.
# Case split: 13 files of 64 MiB from 4 writers, 2 of them tiered (cut from
# 16 and 4 for phase batcher_dp; the 11 left are the flash sets), 4 threads
# of 4 KiB creates (at most 256 each) racing an operator split. Case flash:
# working sets of 3 files (192 MiB, within half the az-a group's 512 MiB)
# and 8 files (512 MiB, twice that; the hotness gate tracks 4,096 blocks,
# 512 MiB, so a larger set is never admitted). Case geo: 16,384 records.
DOORS_FILES, DOORS_FILE, DOORS_WRITERS, DOORS_TIER = 13, 64 * MIB, 4, 2
DOORS_RACERS, DOORS_RACE_FILES, DOORS_RACE_SIZE = 4, 256, 4096
FLASH_SMALL_FILES, FLASH_BIG_FILES = 3, 8
GEO_RECORDS = 16384
# phase clients: the C ABI against the launched codec role (EC12P4 stripes of
# 4 MiB shards through /dev/shm, B = 4; 8 MiB blobs over the body, B = 4;
# 1,024 CRC blocks of 128 KiB, the codec service phase's sizes), against the
# access role (4 objects of 64 MiB) and against the fsgateway (4 files of
# 64 MiB from 4 threads in 1 MiB calls; the first 2 tiered, the other 2
# copied in and out through the FUSE mount (tiered and FUSE files cut from 4
# when phase operators was added: each 64 MiB through the card's runsc FUSE
# took 9-11 s; the FUSE battery renames one and sets xattrs on the other;
# objects and files cut from 8 and 16 for phase batcher_dp)
CLIENT_OBJECTS, CLIENT_OBJECT = 4, 64 * MIB
CLIENT_FILES, CLIENT_FILE, CLIENT_WRITERS, CLIENT_CALL, CLIENT_TIER = 4, 64 * MIB, 4, MIB, 2
CLIENT_FUSE_FILES = 2
CLIENT_CRC_BLOCKS, CLIENT_CRC_BLOCK = 1024, 128 << 10
# phase operators: phase fs's file-system plane and the blob roles of phase
# roles, driven through the operator's CLI (python -m cubefs_tpu_torch.cli):
# 3 files of 64 MiB through its fs group (fsck corrupts the 2 left after
# the mv and rm), 2 objects of 64 MiB through its blob group, 4 bitflips for
# the scheduler role's scrub, the dial prober, the blob bench at 16 x 8 MiB
# from 4 threads, bench_codec's run_ab at 32 submitters (its acceptance
# shape; 25 stripes each, cut from its default of 200) and run_repair_ab at
# EC6P6MSR, and tier_ab's legs at their own sizes. The cuts: the phase took
# 195 s alone at the full depth, and the script 1,130 s at 8 objects and 100
# stripes (its limit 1,200); then files 4 -> 3, objects 4 -> 2 and stripes
# 50 -> 25 for phase batcher_dp
OPS_FILES, OPS_FILE = 3, 64 * MIB
OPS_OBJECTS, OPS_OBJECT = 2, 64 * MIB
OPS_BITFLIPS = 4
OPS_BENCH_COUNT, OPS_BENCH_SIZE, OPS_BENCH_CONC = 16, 8 * MIB, 4
OPS_SUBMITTERS, OPS_ITERS, OPS_REPAIR_STRIPES = 32, 25, 96
LAUNCH_B = 'cubefs_codec_kernel_launches_total{kernel="crc32_blocks"}'
# phase fs_bench: the file-system plane's benchmark harness and the sm_90a
# build check, each a process of its own (name, module, arguments): the
# mdtest/fio run at the harness's defaults (200 files, 16 MiB, 8 threads),
# the wire A/B at its defaults, the split and geo A/Bs at 1 s windows and
# one round (cut from 4 s x 2 rounds and 1 s x 3 rounds), and the build
# check of the three kernel sources
BENCH_FS = "cubefs_tpu_torch.tool.bench_fs"
FS_BENCH_RUNS = (
    ("mdtest_fio", BENCH_FS, ()),
    ("wire_ab", BENCH_FS, ("--wire-ab",)),
    ("split_ab", BENCH_FS, ("--split-ab", "--secs", "1", "--rounds", "1")),
    ("geo_ab", BENCH_FS, ("--geo-ab", "--secs", "1", "--rounds", "1")),
    ("aot_cuda", "cubefs_tpu_torch.tool.aot_cuda", ()),
)
MDTEST_KEYS = ("dir_create_ops", "dir_stat_ops", "small_file_create_tps", "small_file_read_tps",
               "file_stat_ops", "seq_write_mbps", "seq_read_mbps", "file_remove_ops")
S3_OWNER = {"access_key": "AKIDSMOKEOWNER000001", "secret_key": "smoke-owner-secret-key"}
S3_STRANGER = {"access_key": "AKIDSMOKESTRANGER001", "secret_key": "smoke-stranger-secret"}
# each phase's deadline in seconds (Watchdog): about 1.5 times the longest
# of its times in whole runs on the card at these depths (PERF.md, section
# 6), and never under 30 s; and the whole script's
PHASE_BUDGETS = {
    "build": 30, "gf_apply": 30, "crc32_blocks": 30, "gf_bitmajor": 30, "main_path": 30,
    "codec_families": 30, "batcher": 30, "batcher_dp": 30, "end_to_end": 30, "gf_tuning": 30,
    "service": 60, "engines": 60, "blob": 30, "roles": 80, "raft": 60, "integrity": 30,
    "shardnode": 45, "fs": 90, "s3": 125, "fs_doors": 165, "clients": 245, "operators": 155,
    "fs_bench": 120, "sharded": 55, "kernels": 30,
}
SCRIPT_BUDGET = 1100.0
# the C and D instantiations the kernels' record reports: (case, extract, probe, grid)
RECORDED_BM = (("tuning_rows_2x12_B4", "bcast", None, "flat"),
               ("tuning_rows_2x12_B4", "bcast", "nodot", "stripe"))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def descendants(pid: int) -> list[int]:
    """Every live process below ``pid`` (children first), read from /proc."""
    children = collections.defaultdict(list)
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue  # gone, or not readable
        children[ppid].append(int(entry))
    out, todo = [], [pid]
    while todo:
        kids = children.get(todo.pop(), [])
        out += kids
        todo += kids
    return out


def running(pid: int) -> bool:
    """Whether ``pid`` exists and has not exited (a zombie has)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return False


def dump_role_stacks(pids: list[int], lines: int = 60) -> None:
    """SIGUSR1 to each process (a role of ``cubefs_tpu_torch.cmd`` then
    writes every thread's stack to its stderr, its log), then the last
    ``lines`` lines of each log, to stdout."""
    logs = {}
    for pid in pids:
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
            if b"cubefs_tpu_torch.cmd" not in argv:
                continue
            logs[pid] = os.readlink(f"/proc/{pid}/fd/2")
            os.kill(pid, signal.SIGUSR1)
        except OSError:
            continue  # gone, or no log to read
    time.sleep(2.0)
    for pid, path in logs.items():
        try:
            with open(path, errors="replace") as f:
                tail = f.readlines()[-lines:]
        except OSError:
            continue
        print(f"--- role process {pid}, {path}:\n{''.join(tail)}", flush=True)


def stop_processes(pids: list[int], grace: float = 5.0) -> None:
    """SIGTERM each process (and the group of each that leads one, as
    the tools the script runs in sessions of their own do), then SIGKILL
    what is left after ``grace`` seconds."""
    own = os.getpgrp()
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid in pids:
            try:
                if os.getpgid(pid) == pid != own:
                    os.killpg(pid, sig)
                else:
                    os.kill(pid, sig)
            except OSError:
                pass  # already gone
        end = time.monotonic() + grace
        while sig == signal.SIGTERM and time.monotonic() < end and any(map(running, pids)):
            time.sleep(0.1)


class Watchdog:
    """A deadline for each phase and one for the whole script.

    ``arm(name)`` starts phase ``name`` with its budget from ``budgets``
    (and records the seconds of the phase before it); ``disarm()`` ends
    the last. A thread waits for the earlier of the phase's deadline and
    the script's. When one passes it prints ``{"phase": name,
    "overran_s": ...}`` and every thread's stack, the stacks of the
    roles it started (``dump_role_stacks``), stops every process the
    script started (``descendants``) and ends the process with exit
    code 1, whatever the phase is doing. faulthandler backs it with a
    deadline of its own a minute after the script's, in case the thread
    itself cannot run."""

    def __init__(self, budgets: dict[str, float], total: float):
        import faulthandler

        self.budgets, self.total = budgets, total
        self.t0 = time.monotonic()
        self.name: str | None = None
        self.started = self.t0
        self.seconds: dict[str, float] = {}
        self._done = False
        self._cond = threading.Condition()
        faulthandler.dump_traceback_later(total + 60.0, exit=True)
        threading.Thread(target=self._watch, name="phase-watchdog", daemon=True).start()

    def arm(self, name: str) -> None:
        now = time.monotonic()
        with self._cond:
            if self.name is not None:
                self.seconds[self.name] = now - self.started
            self.name, self.started = name, now
            self._cond.notify_all()

    def elapsed(self) -> float:
        """Seconds since the current phase was armed."""
        return time.monotonic() - self.started

    def disarm(self) -> None:
        import faulthandler

        self.arm(None)
        with self._cond:
            self._done = True
            self._cond.notify_all()
        faulthandler.cancel_dump_traceback_later()

    def _watch(self) -> None:
        with self._cond:
            while True:
                if self._done:
                    return
                now = time.monotonic()
                budget = self.budgets[self.name] if self.name is not None else self.total
                end = min(self.started + budget, self.t0 + self.total)
                if now >= end:
                    break
                self._cond.wait(end - now)
            name, over = self.name, now - self.started
        self._fire(name, over, budget)

    def _fire(self, name: str | None, over: float, budget: float) -> None:
        import faulthandler

        script_s = time.monotonic() - self.t0
        emit({"phase": name, "overran_s": over, "budget_s": budget, "script_s": script_s,
              "limit": "script" if script_s >= self.total else "phase",
              "seconds": self.seconds})
        sys.stderr.flush()
        faulthandler.dump_traceback(file=sys.stdout, all_threads=True)
        sys.stdout.flush()
        kids = descendants(os.getpid())
        dump_role_stacks(kids)
        stop_processes(kids)
        os._exit(1)


def sharded_summary(run: dict, per_rank: list[dict]) -> dict:
    """One mesh's record from its ranks' ``dryrun.multichip`` summaries:
    every check on every rank, each rank's launches of A and B in the
    sharded calls, the slowest rank's medians and rank 0's kernel times.
    ``held``: every check true, every rank launched A and B, nothing else."""
    launched = [s["launches"] for s in per_rank]
    res = {"run": run["name"], "dims": per_rank[0]["dims"], "B": run["b"], "N": run["n"],
           "M": run["m"], "S": run["s"], "bad": run["bad"], "block": per_rank[0]["block"],
           "equal": {c: all(s["checks"][c] for s in per_rank) for c in per_rank[0]["checks"]},
           "launches": {k: [c[k] for c in launched] for k in MAIN_KERNELS},
           "other_launches": sum(v for c in launched for k, v in c.items()
                                 if k not in MAIN_KERNELS)}
    for key in ("step_ms", "encode_ms", "collective_ms"):
        res[key] = max(s[key] for s in per_rank)
    res["step_ms_by_rank"] = [s["step_ms"] for s in per_rank]
    res["rank0_device_ms"] = per_rank[0]["kernel_ms"]
    res["held"] = (all(res["equal"].values()) and res["other_launches"] == 0
                   and all(x > 0 for k in MAIN_KERNELS for x in res["launches"][k]))
    return res


def rpc_post(addr: str, method: str, args: dict, body: bytes = b"",
             headers: dict | None = None) -> tuple[int, dict, bytes]:
    """One call of the codec service's wire over a fresh connection, as
    its native client makes it: (status, meta, payload)."""
    host, port = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=300)
    try:
        conn.request("POST", f"/{method}", body=body,
                     headers={"X-Rpc-Args": json.dumps(args), **(headers or {})})
        resp = conn.getresponse()
        payload = resp.read()
        return resp.status, json.loads(resp.headers.get("X-Rpc-Resp") or "{}"), payload
    finally:
        conn.close()


_PORTS_GIVEN: set[int] = set()


def free_port() -> int:
    """A free TCP port on 127.0.0.1, for a role that needs a static one
    (a raft member names itself). It is drawn below the kernel's range
    of ephemeral ports (and below 16,000, where gVisor's starts), never
    twice in a run: a port the kernel hands to a ``listen_port: 0`` role
    or to an outgoing connection between this choice and the role's
    bind would fail that bind with ``EADDRINUSE``."""
    import random
    import socket

    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 16000
    high = min(low, 16000)
    rng = random.Random()
    for _ in range(1000):
        port = rng.randrange(high - 6000, high)
        if port in _PORTS_GIVEN:
            continue
        with socket.socket() as sk:
            try:
                sk.bind(("127.0.0.1", port))
            except OSError:
                continue
        _PORTS_GIVEN.add(port)
        return port
    raise RuntimeError(f"no free port in [{high - 6000}, {high})")


def scrape(addr: str) -> dict[str, float]:
    """The server's ``GET /metrics`` as {series (name and labels): value}."""
    host, port = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    try:
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
    finally:
        conn.close()
    return {ln.rsplit(" ", 1)[0]: float(ln.rsplit(" ", 1)[1])
            for ln in text.splitlines() if ln and not ln.startswith("#")}


LAUNCH_A = 'cubefs_codec_kernel_launches_total{kernel="gf_apply"}'


def timed_case(acc: str, calls: list, nbytes: int) -> tuple[dict, list]:
    """Run each (method, args, body) on the access role over HTTP, timing
    each; returns the case's record (wall-clock median, min, max and
    GiB/s, A's launches and the encode steps by leg from the access
    process's ``/metrics``) and the replies (meta, payload)."""
    def series() -> dict[str, float]:
        return {k: v for k, v in scrape(acc).items() if k.startswith("cubefs_codec_")}

    m0 = series()
    out, ms = [], []
    for method, args, body in calls:
        t = time.perf_counter()
        status, meta, payload = rpc_post(acc, method, args, body)
        ms.append((time.perf_counter() - t) * 1e3)
        if status != 200:
            raise AssertionError(f"{method} answered {status} {meta}")
        out.append((meta, payload))
    m1 = series()
    med = statistics.median(ms)
    rec = {"count": len(calls), "bytes": nbytes, "ms": med, "ms_min": min(ms),
           "ms_max": max(ms), "ms_runs": ms, "gib_s": nbytes / (med / 1e3) / 2**30,
           "a_launches": m1.get(LAUNCH_A, 0.0) - m0.get(LAUNCH_A, 0.0),
           "steps": {k.split("{", 1)[1].rstrip("}"): v - m0.get(k, 0.0)
                     for k, v in m1.items()
                     if k.startswith("cubefs_codec_batch_steps_total") and v != m0.get(k, 0.0)}}
    return rec, out


def parity_equals_plain(vol: dict, bid: int, n: int, m: int) -> bool:
    """A blob's stripe fetched from the blobnodes' ``get_shard``: its
    parity rows against ``rs_kernel``'s plain version (``gf_apply_bits``,
    no kernel), run on the card where there is one."""
    import torch

    from cubefs_tpu_torch.ops import gf256, rs_kernel

    rows = []
    for u in vol["units"]:
        st, _, shard = rpc_post(u["node_addr"], "get_shard", {
            "disk_id": u["disk_id"], "chunk_id": u["chunk_id"], "bid": bid})
        if st != 200:
            return False
        rows.append(np.frombuffer(shard, np.uint8))
    stripe = np.stack(rows)
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    w = torch.from_numpy(rs_kernel.coeff_bits(gf256.parity_matrix(n, m)))
    plain = rs_kernel.gf_apply_bits(w, torch.from_numpy(stripe[:n].copy()).to(dev))
    return bool(np.array_equal(plain.cpu().numpy(), stripe[n:]))


class Quiet:
    """The QoS gate's burn-rate source, pinned: a phase's own write burst
    would brown out ``SCRUB`` and defer every scrub step and migrate."""

    def snapshot(self):
        return {}


def run_threads(n: int, fn) -> float:
    """``fn(i)`` for i < n, each on a thread of its own; the seconds taken."""
    t = time.perf_counter()
    with ThreadPoolExecutor(n) as ex:
        list(ex.map(fn, range(n)))
    return time.perf_counter() - t


def op_stats(ms: list, secs: float) -> dict:
    """Op count, rate and the median and p99 of per-op milliseconds."""
    ms = sorted(ms)
    return {"ops": len(ms), "seconds": secs, "ops_s": len(ms) / secs,
            "p50_ms": ms[len(ms) // 2], "p99_ms": ms[min(len(ms) - 1, int(len(ms) * 0.99))]}


def tiered_volumes(cmgr: str, locs: list) -> dict:
    """The clustermgr's record of every volume the tiered locations use."""
    vols = {}
    for loc in locs:
        for sl in loc["slices"]:
            if sl["vid"] not in vols:
                vols[sl["vid"]] = rpc_post(cmgr, "get_volume", {"vid": sl["vid"]})[1]["volume"]
    return vols


def tiered_parity_equal(vols: dict, locs: list, n: int, m: int) -> list[bool]:
    """``parity_equals_plain`` for every blob of the tiered locations."""
    return [parity_equals_plain(vols[sl["vid"]], bid, n, m) for loc in locs
            for sl in loc["slices"] for bid in range(sl["min_bid"], sl["min_bid"] + sl["count"])]


def stop_a_blobnode(c, blobnodes: list, vols: dict, locs: list, n: int, m: int) -> tuple:
    """SIGTERM the blobnode process holding the most units of the tiered
    volumes among those whose loss leaves every volume at most ``m``
    units short; returns its name, its exit code and the tiered blobs
    that lost a data unit (each read of one decodes)."""
    held = {bn: {vid: [u["index"] for u in v["units"] if u["node_addr"] == bn]
                 for vid, v in vols.items()} for bn in blobnodes}
    victim = max((bn for bn in blobnodes if max(len(ix) for ix in held[bn].values()) <= m),
                 key=lambda bn: sum(len(ix) for ix in held[bn].values()))
    proc = next(p for p in c.procs if p.addr == victim)
    proc.p.terminate()
    code = proc.p.wait(60)
    lost = sum(sl["count"] for loc in locs for sl in loc["slices"]
               if any(i < n for i in held[victim][sl["vid"]]))
    return proc.name, code, lost


def start_server(root: str, cfg: dict, workdir: str) -> tuple[subprocess.Popen, str]:
    """The port's codec role as its users start it, ``python -m
    cubefs_tpu_torch.cmd -c <cfg>``; returns (process, address) once it
    prints its listening line, or kills it and raises."""
    path = os.path.join(workdir, "codec.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    err = open(os.path.join(workdir, "codec.err"), "w")
    proc = subprocess.Popen([sys.executable, "-m", "cubefs_tpu_torch.cmd", "-c", path],
                            cwd=root, stdout=subprocess.PIPE, stderr=err, text=True)
    err.close()
    line: list[str] = []
    reader = threading.Thread(target=lambda: line.append(proc.stdout.readline()), daemon=True)
    reader.start()
    reader.join(180.0)
    m = re.fullmatch(r"\[codec\] listening on (\S+)\n", line[0]) if line else None
    if m is None:
        proc.kill()
        proc.wait(30)
        with open(os.path.join(workdir, "codec.err")) as f:
            raise AssertionError(f"the codec role did not start: {line} {f.read()[-4000:]}")
    return proc, m.group(1)


def cpu_model() -> str:
    """The host CPU as /proc/cpuinfo gives its first processor: the model
    name, then vendor, family, model and stepping (a sandboxed kernel may
    report the name as "unknown"), and the SIMD flags the host legs use."""
    info = {}
    with open("/proc/cpuinfo") as f:
        for ln in f:
            if not ln.strip():
                break
            key, _, value = ln.partition(":")
            info[key.strip()] = value.strip()
    flags = [f for f in ("ssse3", "avx2", "avx512f", "avx512bw", "gfni")
             if f in info.get("flags", "").split()]
    return (f"{info.get('model name', '?')} ({info.get('vendor_id', '?')} family "
            f"{info.get('cpu family', '?')} model {info.get('model', '?')} stepping "
            f"{info.get('stepping', '?')}, {info.get('cpu MHz', '?')} MHz; "
            f"{' '.join(flags)})")


def engines_phase(root: str, dev, card: str, *, shard: int = SHARD, blob: int = BLOB,
                  beyond: int = BEYOND_TABLE, put: int = PUT, sizes=None,
                  server_cfg: dict = ENGINES_CFG, crc_rows: tuple = (1024, 128 << 10)) -> dict:
    """Phase ``engines``: the codec engine layer on this host and card.

    The five legs agree byte for byte on the EC12P4 encode at ``shard``
    and at the shard size of a ``blob``, the (2, 12) recovery rows of
    shards 1 and 7, the composed EC16P20L2 rows and an EC6P6MSR repair
    matrix; ``measure_crossover`` times the legs at the reference's sizes
    and persists the table; ``auto`` routes a 64 KiB stripe to the
    table's leg and a step beyond the table to ``cuda`` (kernel A, one
    launch); the ``CUBEFS_CODEC_DEAD=cuda`` drill serves it by ``cpp``,
    logged, and clearing it restores ``cuda``; 32 threads of numpy PUTs
    go through the batcher under ``auto``; and a second codec role with
    ``ec_engine: auto`` answers encode and crc32 from the table just
    persisted. Every leg's time is its whole call, numpy in to numpy out
    (the ``cuda`` leg's copies in and out included), and its GiB/s the
    stripe's input bytes over that time. Returns the phase's record with
    ``checks``; the caller fails on any false one."""
    import logging

    from cubefs_tpu_torch.codec import codemode as cm
    from cubefs_tpu_torch.codec import engine as engines
    from cubefs_tpu_torch.codec.batcher import AdmittedEngine, BatchCodec
    from cubefs_tpu_torch.codec.encoder import CodecConfig, new_encoder
    from cubefs_tpu_torch.ops import _build, gf256, gfcpu, msr, rs_kernel
    from cubefs_tpu_torch.utils import metrics

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 9)
    host = {"card": card, "cpu_model": cpu_model(), "gf_cpu_level": gfcpu.cpu_level(),
            "cpu_count": os.cpu_count()}
    print(json.dumps({"phase": "engines", "host": host}), flush=True)
    os.environ.pop("CUBEFS_CODEC_DEAD", None)
    os.environ.pop("CUBEFS_CODEC_XOR", None)
    _build.reset_launches()

    def call(leg: str, coeff, x) -> tuple[np.ndarray, float]:
        t = time.perf_counter()
        y = engines.host_call(leg, "matrix_apply", dev, coeff, x)
        return y, time.perf_counter() - t

    # -- the five legs agree --------------------------------------------------
    n, m = 12, 4
    blob_s = -(-blob // n)
    present = [i for i in range(n + m) if i not in (1, 7)]
    lrc_rows = new_encoder(CodecConfig(cm.CodeMode.EC16P20L2, engine="numpy"))._encode_rows
    msr_t = cm.tactic(cm.CodeMode.EC6P6MSR)
    helpers = tuple(range(1, msr_t.total))
    beta = new_encoder(CodecConfig(cm.CodeMode.EC6P6MSR, engine="numpy")).shard_size(
        3 * blob) // msr_t.alpha
    agree_cases = [  # (label, coeff, shards)
        ("encode_EC12P4_4MiB", gf256.parity_matrix(n, m), (n, shard)),
        ("encode_EC12P4_S699051", gf256.parity_matrix(n, m), (n, blob_s)),
        ("recover_2x12_shards_1_7", rs_kernel.reconstruct_rows(n, n + m, present, [1, 7]),
         (n, shard)),
        ("lrc_rows_22x16_EC16P20L2", lrc_rows, (16, shard // 4)),
        ("msr_repair_6x11_EC6P6MSR", msr.repair_rows(msr_t.n, msr_t.total, msr_t.d, 0, helpers),
         (msr_t.d, beta)),
    ]
    agree = []
    for label, coeff, shape in agree_cases:
        x = rng.integers(0, 256, shape, dtype=np.uint8)
        for leg in LEGS:  # warm: the build, the program, the device's tables
            call(leg, coeff, x[:, :4096])
        outs, secs = {}, {}
        for leg in LEGS:
            outs[leg], secs[leg] = call(leg, coeff, x)
        equal = all(np.array_equal(outs[leg], outs["numpy"]) for leg in LEGS)
        moved = x.nbytes  # GiB/s of stripe bytes in, as the crossover's classes count them
        agree.append({"case": label, "R": int(coeff.shape[0]), "C": int(coeff.shape[1]),
                      "S": int(shape[1]), "equal": equal,
                      "ms": {leg: secs[leg] * 1e3 for leg in LEGS},
                      "gib_s": {leg: moved / secs[leg] / 2**30 for leg in LEGS}})
        del x, outs

    # -- the crossover on this host and card, persisted --------------------
    kw = {} if sizes is None else {"sizes": sizes}
    table = engines.measure_crossover(device=dev, **kw)
    with open(engines._policy_path()) as f:
        saved = json.load(f)
    per_size = {size: {leg: {"s": t, "gib_s": int(size) / t / 2**30}
                       for leg, t in per.items()} for size, per in saved["timings_s"].items()}
    engines._policy = None  # what a later process loads
    loaded = engines._load_policy(dev)

    # -- routing, no drill ----------------------------------------------------
    auto = engines.AutoEngine(dev)
    golden_leg = engines.get_engine("cpp")
    small = rng.integers(0, 256, (6, table[0][0] // 6), dtype=np.uint8)
    big = rng.integers(0, 256, (6, beyond // 6), dtype=np.uint8)
    big_want = golden_leg.encode_parity(big, 3)
    routes = {}

    def routed(label: str, x: np.ndarray, want: np.ndarray, served: str, reps: int) -> None:
        a0 = _build.LAUNCHES["gf_apply"]
        got = auto.encode_parity(x, 3)
        a1 = _build.LAUNCHES["gf_apply"]
        disp = dict(engines.last_dispatch)
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            auto.encode_parity(x, 3)
            times.append((time.perf_counter() - t) * 1e3)
        routes[label] = {"bytes": int(x.nbytes), "last_dispatch": disp,
                         "served_want": served, "equal": bool(np.array_equal(got, want)),
                         "a_launches": a1 - a0, "ms": statistics.median(times), "ms_runs": times}

    small_leg = engines.resolve_leg(table[0][1])
    routed("stripe_64KiB", small, golden_leg.encode_parity(small, 3), small_leg, 5)
    routed("beyond_table_64MiB", big, big_want, "cuda", 3)

    # -- the drill ----------------------------------------------------------
    caught: list[str] = []

    class _Catch(logging.Handler):
        def emit(self, record):
            caught.append(record.getMessage())

    handler = _Catch(logging.WARNING)
    logging.getLogger("cubefs.codec").addHandler(handler)
    os.environ["CUBEFS_CODEC_DEAD"] = "cuda"
    try:
        routed("drill_dead_cuda_64MiB", big, big_want, "cpp", 1)
    finally:
        os.environ.pop("CUBEFS_CODEC_DEAD")
        logging.getLogger("cubefs.codec").removeHandler(handler)
    routed("drill_cleared_64MiB", big, big_want, "cuda", 1)
    drill_warned = [msg for msg in caught if "CUBEFS_CODEC_DEAD" in msg]
    del big, big_want

    # -- the batcher under auto: 32 threads of numpy PUTs ---------------------
    bc = BatchCodec(enabled=True)
    put_enc = new_encoder(CodecConfig(cm.CodeMode.EC12P4, engine="auto", device=dev))
    put_enc.engine = AdmittedEngine(bc, dev, engine="auto")
    put_s = put_enc.shard_size(put)
    n_puts = ENGINE_THREADS * ENGINE_PUTS
    payloads = rng.integers(0, 256, (n_puts, put), dtype=np.uint8)
    stripes = [None] * n_puts
    start = threading.Barrier(ENGINE_THREADS)

    def putter(i: int) -> None:
        start.wait(60.0)
        pend = []
        for j in range(ENGINE_PUTS):
            k = i * ENGINE_PUTS + j
            stripes[k] = put_enc.split(payloads[k].tobytes())
            pend.append(put_enc.encode_async(stripes[k]))
        for p in pend:
            p.wait()

    def steps_by_leg() -> dict[str, float]:
        return {leg: metrics.codec_batch_steps.value(op="encode", engine=leg) for leg in LEGS}

    s0 = steps_by_leg()
    t = time.perf_counter()
    with ThreadPoolExecutor(ENGINE_THREADS) as pool:
        for f in [pool.submit(putter, i) for i in range(ENGINE_THREADS)]:
            f.result()
    put_wall = time.perf_counter() - t
    s1 = steps_by_leg()
    got = np.stack(stripes)
    want = engines.get_engine("numpy").encode_parity(np.ascontiguousarray(got[:, :n]), m)
    batcher = {"threads": ENGINE_THREADS, "puts": n_puts, "shard_size": put_s,
               "steps": {leg: s1[leg] - s0[leg] for leg in LEGS if s1[leg] != s0[leg]},
               "submissions": bc.submissions, "seconds": put_wall,
               "gib_s": n_puts * put / put_wall / 2**30,
               "equal": bool(np.array_equal(got[:, n:], want))}
    del payloads, stripes, got, want

    # -- the service under auto: a second codec role -----------------------
    workdir = tempfile.mkdtemp(prefix="cubefs-smoke-auto-")
    proc, addr = start_server(root, server_cfg, workdir)
    service = {"server": addr, "cases": []}
    try:
        m0 = scrape(addr)
        status, meta, _ = rpc_post(addr, "engine", {})
        service["engine_reply"] = {"status": status, "meta": meta}
        blobs = rng.integers(0, 256, (4, n, blob_s), dtype=np.uint8)
        want_parity = engines.get_engine("numpy").encode_parity(blobs, m).tobytes()
        rows, block = crc_rows
        crc_body = rng.integers(0, 256, rows * block, dtype=np.uint8).tobytes()
        want_crc = np.asarray([zlib.crc32(crc_body[i:i + block])
                               for i in range(0, len(crc_body), block)], dtype="<u4").tobytes()
        for label, method, args, body, want_meta, want_payload in (
                ("encode_EC12P4_8MiB_blobs_B4", "encode",
                 {"n": n, "m": m, "shard_size": blob_s, "batch": 4}, blobs.tobytes(),
                 {"shape": [4, m, blob_s]}, want_parity),
                (f"crc32_{rows}x{block}", "crc32", {"block_len": block}, crc_body,
                 {"count": rows}, want_crc)):
            times, ok = [], True
            for _ in range(1 + SERVICE_REPS):
                t = time.perf_counter()
                status, meta, payload = rpc_post(addr, method, args, body)
                times.append((time.perf_counter() - t) * 1e3)
                ok = ok and (status, meta, payload) == (200, want_meta, want_payload)
            service["cases"].append({"case": label, "equal": ok, "ms_first": times[0],
                                     "ms": statistics.median(times[1:]), "ms_runs": times[1:],
                                     "bytes_in": len(body)})
        m1 = scrape(addr)
        service["delta"] = {k: m1[k] - m0.get(k, 0.0) for k in m1
                            if k.startswith(("cubefs_codec_batch_steps_total",
                                             "cubefs_codec_kernel_launches_total"))
                            and m1[k] != m0.get(k, 0.0)}
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            service["server_exit"] = proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)
            service["server_exit"] = None
        shutil.rmtree(workdir, ignore_errors=True)

    launches = dict(_build.LAUNCHES)
    d = service["delta"]
    checks = {
        **{f"agree.{c['case']}": c["equal"] for c in agree},
        "table_persisted": saved["table"] == table and saved["platform"] == "cuda"
        and loaded == table,
        "table_has_every_size": [row[0] for row in table] == list(
            sizes or engines._POLICY_SIZES),
        **{f"route.{k}": (r["equal"] and r["last_dispatch"]["served"] == r["served_want"])
           for k, r in routes.items()},
        "beyond_table_is_one_launch_of_a": routes["beyond_table_64MiB"]["a_launches"] == 1,
        "drill_launches_no_a": routes["drill_dead_cuda_64MiB"]["a_launches"] == 0,
        "drill_cleared_is_one_launch_of_a": routes["drill_cleared_64MiB"]["a_launches"] == 1,
        "drill_requested_cuda": routes["drill_dead_cuda_64MiB"]["last_dispatch"]["requested"]
        == "cuda",
        "drill_warned_once": drill_warned == ["CUBEFS_CODEC_DEAD=cuda: 'cuda' served by 'cpp'"],
        "batcher_equal": batcher["equal"] and batcher["submissions"] == n_puts,
        "batcher_fewer_steps_than_puts": 0 < sum(batcher["steps"].values()) < n_puts,
        "service_equal": all(c["equal"] for c in service["cases"]),
        "service_reports_auto": service["engine_reply"] == {
            "status": 200, "meta": {"engine": "auto", "shm": True}},
        "service_encode_on_cuda": d.get(
            'cubefs_codec_batch_steps_total{op="encode",engine="cuda"}', 0) > 0,
        "service_launched_a_and_b": d.get(
            'cubefs_codec_kernel_launches_total{kernel="gf_apply"}', 0) > 0
        and d.get('cubefs_codec_kernel_launches_total{kernel="crc32_blocks"}', 0) > 0,
        "server_exit_0": service["server_exit"] == 0,
        "launched_a_only": launches["gf_apply"] > 0
        and all(v == 0 for k, v in launches.items() if k != "gf_apply"),
    }
    return {"phase": "engines", "host": host, "seconds": time.perf_counter() - t_phase,
            "agree": agree, "table": table, "loaded": loaded,
            "device_crossover_bytes": saved["device_crossover_bytes"], "timings": per_size,
            "routes": routes, "drill_warnings": drill_warned, "batcher": batcher,
            "service": service, "launches": launches, "checks": checks}


def counter(metric, **want) -> dict[str, float]:
    """A registry metric's series matching ``want``, by their first other label."""
    names = [n for n in metric.label_names if n not in want]
    return {k[metric.label_names.index(names[0])]: v for k, v in metric.samples()
            if all(k[metric.label_names.index(a)] == b for a, b in want.items())}


def delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in after.items() if v != before.get(k, 0.0)}


def blob_phase(dev, card: str, *, put: int = BLOB_PUT, n_puts: int = BLOB_PUTS,
               msr_payload: int = BLOB_MSR, blob_size: int = BLOB, reps: int = 3) -> dict:
    """Phase ``blob``: the blob plane's erasure-coded data path, the
    reference's own test pattern (an in-process cluster, direct-call
    transport) at the reference's defaults: 6 blobnodes x 3 disks, 8 MiB
    blobs, the default codemode policies, no quorum override.

    ``n_puts`` PUTs of ``put`` bytes (EC12P4) through an access under
    ``auto`` and as many under ``cuda``, each read back; GETs with two of
    one volume's disks down under both engines; one of that volume's
    disks broken, the scheduler's tasks drained by the worker, every
    repointed unit's shards held against the shards written at PUT and
    every object read back; one EC6P6MSR object of ``msr_payload`` bytes
    repaired through the sub-shard path; and, for one stripe, the parity
    on disk against ``rs_kernel``'s plain version on the CPU. Each case
    records its wall-clock ms and GiB/s, kernel A's launches, the leg
    that served its codec steps (``codec_batch_steps`` by leg,
    ``repair_codec_leg``, ``last_dispatch``), and, for a step of its
    shapes measured alone afterwards, its whole time between CUDA events
    (host stripes in and out; A's own device time at these shapes is
    measured in phase ``gf_apply``). Returns the record with ``checks``
    and ``launches`` (the path's, measurement launches excluded)."""
    import torch

    from cubefs_tpu_torch.blob.access import AccessConfig, AccessHandler
    from cubefs_tpu_torch.blob.blobnode import BlobNode
    from cubefs_tpu_torch.blob.clustermgr import ClusterMgr
    from cubefs_tpu_torch.blob.mq import MessageQueue
    from cubefs_tpu_torch.blob.scheduler import Scheduler
    from cubefs_tpu_torch.blob.worker import RepairWorker
    from cubefs_tpu_torch.codec import codemode as cm
    from cubefs_tpu_torch.codec import engine as engines
    from cubefs_tpu_torch.codec import hostio
    from cubefs_tpu_torch.ops import _build, rs_kernel
    from cubefs_tpu_torch.utils import benchtime, metrics, rpc

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 10)
    print(json.dumps({"phase": "blob", "card": card, "policy": engines._load_policy(dev)}),
          flush=True)
    _build.reset_launches()
    workdir = tempfile.mkdtemp(prefix="cubefs-smoke-blob-")
    cases: dict[str, dict] = {}
    nodes: list = []
    acc: dict = {}

    def launches_a() -> int:
        return _build.LAUNCHES["gf_apply"]

    def steps() -> dict[str, float]:
        return counter(metrics.codec_batch_steps, op="encode")

    def timed_objects(label: str, fn, objs: list, nbytes: int) -> list:
        """Run ``fn(obj)`` per object, timing each; the case's record."""
        a0, s0 = launches_a(), steps()
        g0 = metrics.reconstruct_reads.value(path="global")
        out, ms = [], []
        for obj in objs:
            t = time.perf_counter()
            out.append(fn(obj))
            ms.append((time.perf_counter() - t) * 1e3)
        med = statistics.median(ms)
        cases[label] = {"count": len(objs), "bytes": nbytes, "ms": med,
                        "ms_runs": ms, "gib_s": nbytes / (med / 1e3) / 2**30,
                        "a_launches": launches_a() - a0, "encode_steps": delta(s0, steps()),
                        "degraded_blobs": metrics.reconstruct_reads.value(path="global") - g0,
                        "last_dispatch": dict(engines.last_dispatch)}
        return out

    def shards_on(disk_id: int) -> dict:
        """{(vid, unit index, bid): bytes} of every unit on a disk."""
        out = {}
        for vid, idx in cmgr.volumes_on_disk(disk_id):
            u = cmgr.get_volume(vid).units[idx]
            node = nodes[int(u.node_addr.removeprefix("node"))]
            for bid, _, _ in node.list_chunk(u.disk_id, u.chunk_id):
                out[(vid, idx, bid)] = node.get_shard(u.disk_id, u.chunk_id, bid)[0]
        return out

    def rebuilt_equal(original: dict, broken: int) -> bool:
        ok = True
        for (vid, idx, bid), blob in original.items():
            u = cmgr.get_volume(vid).units[idx]
            node = nodes[int(u.node_addr.removeprefix("node"))]
            ok = ok and u.disk_id != broken and \
                node.get_shard(u.disk_id, u.chunk_id, bid)[0] == blob
        return ok

    def drain() -> float:
        t = time.perf_counter()
        while wk.run_once():
            pass
        return time.perf_counter() - t

    try:
        cmgr = ClusterMgr()
        cmc, pool = rpc.Client(cmgr), rpc.NodePool()
        for i in range(BLOB_NODES):
            node = BlobNode(i, [os.path.join(workdir, f"n{i}d{d}") for d in range(BLOB_DISKS)],
                            cmc, addr=f"node{i}", device=dev)
            node.register()
            node.send_heartbeat()
            pool.bind(node.addr, node)
            nodes.append(node)
        repair_q, delete_q = MessageQueue(), MessageQueue()
        acc = {e: AccessHandler(cmc, pool, AccessConfig(blob_size=blob_size, engine=e,
                                                        device=dev),
                                repair_queue=repair_q, delete_queue=delete_q)
               for e in ("auto", "cuda")}
        sched = Scheduler(cmgr, repair_queue=repair_q, delete_queue=delete_q, node_pool=pool,
                          device=dev)
        wk = RepairWorker(rpc.Client(sched), cmc, pool, device=dev)

        # -- PUTs and GETs under both engines --------------------------------
        objs = {}
        for e in ("auto", "cuda"):
            payloads = [rng.integers(0, 256, put, dtype=np.uint8).tobytes()
                        for _ in range(n_puts)]
            locs = timed_objects(f"put_{e}", acc[e].put, payloads, put)
            objs[e] = list(zip(locs, payloads))
            got = timed_objects(f"get_{e}", lambda o, e=e: acc[e].get(o[0]), objs[e], put)
            cases[f"get_{e}"]["equal"] = all(g == d for g, (_, d) in zip(got, objs[e]))
        loc0 = objs["auto"][0][0]
        t12 = cm.tactic(loc0.codemode)
        vol0 = cmgr.get_volume(loc0.slices[0].vid)

        # -- the parity on disk against the plain version on the CPU --------
        bid0 = loc0.slices[0].min_bid
        stripe = np.stack([np.frombuffer(nodes[int(u.node_addr.removeprefix("node"))]
                                         .get_shard(u.disk_id, u.chunk_id, bid0)[0], np.uint8)
                           for u in vol0.units])
        plain = rs_kernel.encode_parity(torch.from_numpy(stripe[None, :t12.n].copy()), t12.m)
        disk_parity_equal = bool(np.array_equal(plain[0].numpy(), stripe[t12.n:]))

        # -- degraded GETs: two of vol0's disks down -------------------------
        down = [u for u in vol0.units[:2]]
        for u in down:
            nodes[int(u.node_addr.removeprefix("node"))].break_disk(u.disk_id)
        for e in ("auto", "cuda"):
            got = timed_objects(f"degraded_get_{e}", lambda o, e=e: acc[e].get(o[0]),
                                objs[e], put)
            cases[f"degraded_get_{e}"]["equal"] = all(g == d for g, (_, d) in zip(got, objs[e]))
            cases[f"degraded_get_{e}"]["down_disks"] = [u.disk_id for u in down]
        for u in down:
            nodes[int(u.node_addr.removeprefix("node"))]._broken.discard(u.disk_id)

        # -- one disk broken: the scheduler's tasks, drained -----------------
        victim = vol0.units[2]
        original = shards_on(victim.disk_id)
        a0, legs0 = launches_a(), counter(metrics.repair_codec_leg)
        nodes[int(victim.node_addr.removeprefix("node"))].break_disk(victim.disk_id)
        n_tasks = sched.mark_disk_broken(victim.disk_id)
        secs = drain()
        rebuilt = sum(len(b) for b in original.values())
        cases["repair_disk"] = {
            "disk": victim.disk_id, "tasks": n_tasks, "completed": wk.completed,
            "failed": wk.failed, "units": len({k[:2] for k in original}),
            "shards": len(original), "rebuilt_bytes": rebuilt, "seconds": secs,
            "gib_s": rebuilt / secs / 2**30, "a_launches": launches_a() - a0,
            "codec_legs": delta(legs0, counter(metrics.repair_codec_leg)),
            "equal": rebuilt_equal(original, victim.disk_id),
            "disk_status": int(cmgr.disks[victim.disk_id].status)}
        got = timed_objects("get_after_repair", lambda o: acc["auto"].get(o[0]),
                            objs["auto"] + objs["cuda"], put)
        cases["get_after_repair"]["equal"] = all(
            g == d for g, (_, d) in zip(got, objs["auto"] + objs["cuda"]))

        # -- one EC6P6MSR object, a unit repaired through the sub-shard path --
        msr_data = rng.integers(0, 256, msr_payload, dtype=np.uint8).tobytes()
        t = time.perf_counter()
        msr_loc = acc["auto"].put(msr_data, codemode=cm.CodeMode.EC6P6MSR)
        msr_put_ms = (time.perf_counter() - t) * 1e3
        msr_vol = cmgr.get_volume(msr_loc.slices[0].vid)
        mvictim = msr_vol.units[0]
        mnode = nodes[int(mvictim.node_addr.removeprefix("node"))]
        morig = {(msr_vol.vid, 0, bid): mnode.get_shard(mvictim.disk_id, mvictim.chunk_id,
                                                         bid)[0]
                 for bid, _, _ in mnode.list_chunk(mvictim.disk_id, mvictim.chunk_id)}
        sub0, fb0 = metrics.repair_subshard_reads.value(), counter(metrics.repair_msr_fallbacks)
        a0, legs0 = launches_a(), counter(metrics.repair_codec_leg)
        mnode.break_disk(mvictim.disk_id)
        sched.manual_migrate(msr_vol.vid, 0)
        msecs = drain()
        mt = cm.tactic(cm.CodeMode.EC6P6MSR)
        cases["repair_msr_unit"] = {
            "put_ms": msr_put_ms, "bids": len(morig), "seconds": msecs,
            "rebuilt_bytes": sum(len(b) for b in morig.values()),
            "subshard_reads": metrics.repair_subshard_reads.value() - sub0,
            "fallbacks": delta(fb0, counter(metrics.repair_msr_fallbacks)),
            "a_launches": launches_a() - a0,
            "codec_legs": delta(legs0, counter(metrics.repair_codec_leg)),
            "equal": rebuilt_equal(morig, mvictim.disk_id)
            and acc["auto"].get(msr_loc) == msr_data}
        launches = dict(_build.LAUNCHES)  # the path's; measurements follow

        # -- each case's codec step alone, a whole call between CUDA events --
        # (host numpy in and out: the staging, the copies and A; A's own
        # device time at these shapes is phase gf_apply's blob_* cases)
        s_blob = -(-blob_size // t12.n)
        nb = loc0.slices[0].count
        stack = rng.integers(0, 256, (nb, t12.total, s_blob), dtype=np.uint8)
        one = np.ascontiguousarray(stack[0])
        solve = [i for i in range(t12.total) if i != 2][:t12.n + 1]
        rows = rs_kernel.reconstruct_rows(t12.n, t12.total, solve[:t12.n], [2, solve[t12.n]])
        survivors = np.ascontiguousarray(stack[:, solve[:t12.n]])
        enc = {e: acc[e]._encoder(loc0.codemode) for e in ("auto", "cuda")}
        steps_alone = {
            "put_auto": lambda: enc["auto"].encode(stack),
            "put_cuda": lambda: enc["cuda"].encode(stack),
            "degraded_get_cuda": lambda: enc["cuda"].reconstruct_data(one, [0, 1]),
            "repair_disk": lambda: wk.codec.matrix_apply(rows, survivors),
        }
        for label, fn in steps_alone.items():
            cases[label]["step_alone_ms"] = benchtime.timed_ms(fn, reps)
        dev_stack = hostio.to_device(stack, stack.shape, enc["cuda"].device)
        cases["put_cuda"]["to_device_ms"] = benchtime.timed_ms(
            lambda: hostio.to_device(stack, stack.shape, enc["cuda"].device), reps)
        cases["put_cuda"]["to_host_ms"] = benchtime.timed_ms(
            lambda: hostio.to_host(dev_stack[:, t12.n:], out=stack[:, t12.n:]), reps)
        del dev_stack
    finally:
        for a in acc.values():  # hedged reads outlive a GET: drain them first
            a._pool.shutdown(wait=True)
        for node in nodes:
            node.stop()
        shutil.rmtree(workdir, ignore_errors=True)

    c = cases
    checks = {
        **{f"{k}.equal": v["equal"] for k, v in c.items() if "equal" in v},
        "disk_parity_equals_plain": disk_parity_equal,
        "put_auto_launched_a_each": c["put_auto"]["a_launches"] == n_puts,
        "put_auto_served_by_cuda": c["put_auto"]["encode_steps"] == {"cuda": n_puts},
        "put_cuda_launched_a_each": c["put_cuda"]["a_launches"] == n_puts,
        "degraded_gets_decoded": all(c[k]["degraded_blobs"] > 0
                                     for k in ("degraded_get_auto", "degraded_get_cuda")),
        "degraded_cuda_launched_a_per_blob": c["degraded_get_cuda"]["a_launches"]
        == c["degraded_get_cuda"]["degraded_blobs"],
        "repair_all_tasks_done": c["repair_disk"]["completed"] == c["repair_disk"]["tasks"] > 0
        and c["repair_disk"]["failed"] == 0,
        "repair_launched_a": c["repair_disk"]["a_launches"] > 0
        and c["repair_disk"]["codec_legs"].get("cuda", 0) > 0,
        "repair_disk_repaired": c["repair_disk"]["disk_status"] == 4,
        "msr_subshard_path": c["repair_msr_unit"]["subshard_reads"] >= mt.d * len(morig)
        and not c["repair_msr_unit"]["fallbacks"],
    }
    return {"phase": "blob", "card": card, "seconds": time.perf_counter() - t_phase,
            "cluster": {"nodes": BLOB_NODES, "disks_per_node": BLOB_DISKS,
                        "blob_size": blob_size, "put_bytes": put, "puts_per_engine": n_puts,
                        "codemode": cm.CodeMode(loc0.codemode).name, "blob_shard": s_blob},
            "cases": cases, "launches": launches, "checks": checks}


def roles_phase(dev, card: str, *, put: int = BLOB_PUT, n_puts: int = ROLES_PUTS,
                blob_size: int = BLOB, device: str | None = None) -> dict:
    """Phase ``roles``: the blob plane as its users start it, every role a
    process of its own (``deploy.Cluster``, ``python -m
    cubefs_tpu_torch.cmd``), driven only over HTTP: a clustermgr, 6
    blobnodes x 3 disks, a proxy, access (``ec_engine`` cuda, ``blob_size``
    8 MiB, its proxy) and a scheduler, all with audit logs. (Under
    ``auto`` the access role routes each decode by the crossover table
    phase ``engines`` measured, which may put an 8 MiB decode on the host
    leg, and then the degraded reads launch no A; phase ``engines`` holds
    ``auto`` itself.)

    ``n_puts`` PUTs of ``put`` bytes (EC12P4 by policy), each read back;
    the parity of two blobs, fetched from the blobnodes, against
    ``rs_kernel``'s plain version on the CPU; one blobnode process stopped
    (one that holds no more than M units of any volume) and every object
    read again. Kernel A's launches in the access process come from its
    ``/metrics`` before and after each case; one PUT's trace is read from
    the access and blobnode processes' ``/spans`` and ``/traces``; the
    access audit log must hold one record, code 200, per call; the
    scheduler answers ``role`` and ``stats``; every role exits 0 on
    SIGTERM. ``device`` is the roles' (None: the card). Returns the
    record with ``checks`` and ``launches`` (the access process's)."""
    from cubefs_tpu_torch.codec import codemode as cm
    from cubefs_tpu_torch.deploy.cluster import Cluster

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 11)
    workdir = tempfile.mkdtemp(prefix="cubefs-smoke-roles-")
    audit_path = os.path.join(workdir, "audit", "access.audit.log")
    cases: dict[str, dict] = {}

    def timed(label: str, calls: list, nbytes: int) -> list:
        cases[label], out = timed_case(acc, calls, nbytes)
        return out

    def get_json(addr: str, path: str):
        host, port = addr.rsplit(":", 1)
        conn = http.client.HTTPConnection(host, int(port), timeout=60)
        try:
            conn.request("GET", path)
            return json.loads(conn.getresponse().read())
        finally:
            conn.close()

    def spans(addr: str, tid: str) -> list[dict]:
        return get_json(addr, f"/spans?trace_id={tid}")

    def audit_records(n: int) -> list[dict]:
        """The access audit log once it holds ``n`` records (a server
        writes a call's record after its reply), or after 30 s."""
        deadline = time.perf_counter() + 30.0
        while True:
            with open(audit_path) as f:
                recs = [json.loads(ln) for ln in f]
            if len(recs) >= n or time.perf_counter() > deadline:
                return recs
            time.sleep(0.01)

    topo = {"blobnodes": BLOB_NODES, "disks_per_blobnode": BLOB_DISKS, "proxy": True,
            "access": True, "scheduler": True, "ec_engine": "cuda", "blob_size": blob_size,
            "audit_dir": os.path.join(workdir, "audit"), "device": device}
    c = Cluster(topo, workdir, timeout=300.0)
    codes = None
    try:
        t = time.perf_counter()
        state = c.up()
        startup_s = time.perf_counter() - t
        roles = state["roles"]
        acc, cmgr, sched = roles["access"][0], roles["clustermgr"][0], roles["scheduler"][0]

        # -- PUTs and GETs over HTTP ------------------------------------------
        payloads = [rng.integers(0, 256, put, dtype=np.uint8).tobytes() for _ in range(n_puts)]
        locs = [m["location"] for m, _ in timed("put", [("put", {}, d) for d in payloads], put)]
        got = timed("get", [("get", {"location": loc}, b"") for loc in locs], put)
        cases["get"]["equal"] = all(p == d for (_, p), d in zip(got, payloads))
        mode = cm.CodeMode(locs[0]["codemode"])
        t12 = cm.tactic(mode)

        # -- each PUT's spans in the access process: where its time goes ------
        put_tids = [r["trace"] for r in audit_records(2 * n_puts) if r["op"] == "put"]
        per_put = []
        for tid in put_tids:
            dur: dict[str, float] = {}
            for sp in spans(acc, tid):
                key = ("rpc:" if sp["parent_id"] is None else "") + sp["op"]
                dur[key] = dur.get(key, 0.0) + sp["duration"] * 1e3
            per_put.append(dur)
        cases["put"]["spans_ms"] = {k: statistics.median(d.get(k, 0.0) for d in per_put)
                                    for k in sorted({k for d in per_put for k in d})}

        # -- the stitched trace of one PUT ------------------------------------
        tid = put_tids[0]
        node_ops = {bn: {sp["op"] for sp in spans(bn, tid)} for bn in roles["blobnode"]}
        tree = get_json(acc, f"/traces?trace_id={tid}")
        trace = {"trace_id": tid, "access_ops": sorted({sp["op"] for sp in spans(acc, tid)}),
                 "blobnodes_with_put_shard": sum("blobnode.put_shard" in o
                                                 for o in node_ops.values()),
                 "render_lines": len(tree["render"].splitlines()),
                 "rendered_access_put": "access.put" in tree["render"],
                 "listed": tid in get_json(acc, "/traces")["trace_ids"]}

        # -- the parity of two blobs against the plain version on the CPU -----
        vols = {}
        for loc in locs:
            for sl in loc["slices"]:
                if sl["vid"] not in vols:
                    vols[sl["vid"]] = rpc_post(cmgr, "get_volume", {"vid": sl["vid"]})[1]["volume"]
        sl0 = locs[0]["slices"][0]
        parity_equal = [parity_equals_plain(vols[sl0["vid"]], bid, t12.n, t12.m)
                        for bid in (sl0["min_bid"], sl0["min_bid"] + 1)]

        # -- one blobnode process stopped: every object read again ------------
        def units_on(addr: str) -> dict[int, list[int]]:
            return {vid: [u["index"] for u in v["units"] if u["node_addr"] == addr]
                    for vid, v in vols.items()}
        held = {bn: units_on(bn) for bn in roles["blobnode"]}
        victim = max((bn for bn in roles["blobnode"]
                      if max(len(ix) for ix in held[bn].values()) <= t12.m),
                     key=lambda bn: sum(len(ix) for ix in held[bn].values()))
        proc = next(p for p in c.procs if p.addr == victim)
        proc.p.terminate()
        victim_exit = proc.p.wait(60)
        lost_data_blobs = sum(sl["count"] for loc in locs for sl in loc["slices"]
                              if any(i < t12.n for i in held[victim][sl["vid"]]))
        got = timed("degraded_get", [("get", {"location": loc}, b"") for loc in locs], put)
        cases["degraded_get"].update({
            "equal": all(p == d for (_, p), d in zip(got, payloads)),
            "stopped": proc.name, "stopped_exit": victim_exit,
            "units_lost": {str(v): ix for v, ix in held[victim].items()},
            "blobs_lost_a_data_unit": lost_data_blobs})

        # -- the access audit log and the scheduler ----------------------------
        audit = audit_records(3 * n_puts)
        audit_counts = {f'{r["op"]} {r["code"]}': 0 for r in audit}
        for r in audit:
            audit_counts[f'{r["op"]} {r["code"]}'] += 1
        sched_role = rpc_post(sched, "role", {})[:2]
        sched_stats = rpc_post(sched, "stats", {})[0]
        launches = {"gf_apply": scrape(acc).get(LAUNCH_A, 0.0)}
    finally:
        codes = c.down()
        shutil.rmtree(workdir, ignore_errors=True)

    k = cases
    checks = {
        "put_codemode_ec12p4": mode == cm.CodeMode.EC12P4,
        "get.equal": k["get"]["equal"],
        "degraded_get.equal": k["degraded_get"]["equal"],
        "parity_equals_plain": all(parity_equal),
        "put_launched_a_each": k["put"]["a_launches"] >= n_puts,
        "degraded_launched_a_per_lost_blob": lost_data_blobs > 0
        and k["degraded_get"]["a_launches"] >= lost_data_blobs,
        "trace_stitched": "access.put" in trace["access_ops"]
        and trace["blobnodes_with_put_shard"] > 0 and trace["rendered_access_put"]
        and trace["listed"],
        "audit_one_200_per_call": audit_counts == {"put 200": n_puts, "get 200": 2 * n_puts},
        "scheduler_answers": sched_role == (200, {"role": "scheduler"}) and sched_stats == 200,
        "every_role_exited_0": victim_exit == 0 and all(rc == 0 for rc in codes.values()),
    }
    return {"phase": "roles", "card": card, "seconds": time.perf_counter() - t_phase,
            "startup_s": startup_s,
            "cluster": {"nodes": BLOB_NODES, "disks_per_node": BLOB_DISKS,
                        "blob_size": blob_size, "put_bytes": put, "puts": n_puts,
                        "codemode": mode.name, "blob_shard": -(-blob_size // t12.n),
                        "roles": {r: len(a) for r, a in roles.items()}},
            "cases": cases, "trace": trace, "parity_equal": parity_equal,
            "audit_counts": audit_counts, "exit_codes": codes, "launches": launches,
            "checks": checks}


def raft_phase(dev, card: str, *, put: int = BLOB_PUT, n_puts: int = RAFT_PUTS,
               blob_size: int = BLOB, device: str | None = None) -> dict:
    """Phase ``raft``: the replicated blob plane as its users start it,
    every role a ``python -m cubefs_tpu_torch.cmd`` process with its audit
    log, driven only over HTTP: a clustermgr raft group of 3 on static
    ports, 6 blobnodes x 3 disks, 3 schedulers each hosting a member of
    the 2-partition ``repair`` and ``delete`` topics, a proxy, and access
    (``ec_engine`` cuda, as in phase ``roles``; ``blob_size`` 8 MiB, the
    proxy's volume lease)
    producing into that bus. Every role but the clustermgrs is pointed at
    a clustermgr follower, which redirects to the leader (421). (Without
    the proxy's lease every PUT allocates a volume of 16 units from the
    18 disks, and the disks the blobnodes quarantine as latency outliers
    under load leave fewer than 16 to allocate from.)

    ``n_puts`` PUTs of ``put`` bytes (EC12P4 by policy), each read back,
    and a blob's parity held against ``rs_kernel``'s plain version; the
    clustermgr leader killed (SIGKILL) and the election timed until a new
    leader answers ``raft_status``; ``n_puts`` more PUTs and every object
    read back; the killed member restarted from its directory until it
    reaches the leader's commit index, and its answers to the read routes
    held against the leader's; one blobnode process stopped (it holds at
    most M units of any volume) and every object read again: degraded
    GETs, whose failed reads put ``shard_repair`` events on the bus; the
    bus read from all three members, one member killed (SIGKILL) and the
    survivors' repair backlog held against what was put; every remaining
    role exits 0 on SIGTERM. Kernel A's launches in the access process
    come from its ``/metrics`` before and after each case. ``device`` is
    the roles' (None: the card). Returns the record with ``checks`` and
    ``launches`` (the access process's)."""
    from cubefs_tpu_torch.codec import codemode as cm
    from cubefs_tpu_torch.deploy.cluster import Proc

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 12)
    workdir = tempfile.mkdtemp(prefix="cubefs-smoke-raft-")
    cases: dict[str, dict] = {}
    procs: dict[str, Proc] = {}  # live roles by name
    codes: dict[str, int | None] = {}

    def start(name: str, role: str, cfg: dict) -> Proc:
        cfg = dict(cfg, name=name, audit_dir=os.path.join(workdir, "audit", name))
        if device is not None:
            cfg["device"] = device
        procs[name] = p = Proc(role, dict(cfg, role=role), workdir)
        return p

    def up(names: list[str]) -> list[str]:
        return [procs[n].wait_addr(300.0) for n in names]

    def kill(name: str) -> int:
        p = procs.pop(name)
        p.p.kill()
        return p.p.wait(60)

    def answer(addr: str, method: str, args: dict | None = None):
        """The route's reply meta, or None while the role is down."""
        try:
            st, meta, _ = rpc_post(addr, method, args or {})
        except OSError:
            return None
        return meta if st == 200 else None

    def wait_for(cond, what: str, timeout: float = 60.0):
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            got = cond()
            if got:
                return got
            time.sleep(0.02)
        raise AssertionError(f"phase raft: timed out waiting for {what}")

    def raft_series(addr: str) -> dict[str, float]:
        """The clustermgr group's proposal, batch and WAL-fsync counters."""
        return {k.split("{", 1)[0]: v for k, v in scrape(addr).items()
                if k.startswith(("cubefs_raft_proposals_total",
                                 "cubefs_raft_proposal_batches_total",
                                 "cubefs_raft_wal_fsyncs_total")) and 'group="cm"' in k}

    def leader_of(addrs: list[str]) -> str | None:
        leaders = [a for a in addrs if (answer(a, "raft_status") or {}).get("role") == "leader"]
        return leaders[0] if len(leaders) == 1 else None

    def on_leader(method: str, args: dict) -> dict:
        """A gated read's reply from whichever clustermgr leads when it is
        asked: under the machine's load a heartbeat can come later than a
        follower's election timeout (0.15-0.30 s), and a re-election moves
        the leader between finding it and asking it (421)."""
        return wait_for(lambda: next(filter(None, (answer(a, method, args)
                                                   for a in cm_addrs)), None),
                        f"the clustermgr leader's {method}")

    def group_series() -> dict[str, float]:
        """``raft_series`` summed over the live members: a proposal counts on
        the member that led when it was made."""
        total: dict[str, float] = {}
        for a in cm_addrs:
            for k, v in (raft_series(a) if answer(a, "raft_status") else {}).items():
                total[k] = total.get(k, 0.0) + v
        return total

    def timed(label: str, calls: list, nbytes: int) -> list:
        cases[label], out = timed_case(acc, calls, nbytes)
        return out

    def puts(label: str) -> tuple[list, list]:
        data = [rng.integers(0, 256, put, dtype=np.uint8).tobytes() for _ in range(n_puts)]
        return [m["location"] for m, _ in timed(label, [("put", {}, d) for d in data], put)], data

    def reads_equal(label: str, locs: list, payloads: list) -> bool:
        got = timed(label, [("get", {"location": loc}, b"") for loc in locs], put)
        cases[label]["equal"] = all(p == d for (_, p), d in zip(got, payloads))
        return cases[label]["equal"]

    def bus(addr: str):
        st = answer(addr, "mq_status")
        return None if st is None else {
            t: [(p["role"], p["backlog"]) for p in st[t]["partitions"]] for t in st}

    def backlog(addr: str, topic: str = "repair") -> int | None:
        st = bus(addr)
        return None if st is None else sum(b for _, b in st[topic])

    def bus_led(addrs: list[str]) -> bool:
        """Every partition of both topics has one leader among addrs."""
        views = [bus(a) for a in addrs]
        return all(v is not None for v in views) and all(
            sum(v[t][p][0] == "leader" for v in views) == 1
            for t in ("repair", "delete") for p in range(len(views[0][t])))

    cm_addrs = [f"127.0.0.1:{free_port()}" for _ in range(3)]
    sched_addrs = [f"127.0.0.1:{free_port()}" for _ in range(3)]
    cm_cfgs = {f"clustermgr{i}": {"listen_port": int(a.rsplit(":", 1)[1]), "me": a,
                                  "peers": cm_addrs, "data_dir": os.path.join(workdir, f"cm{i}")}
               for i, a in enumerate(cm_addrs)}
    try:
        t = time.perf_counter()
        for name, cfg in cm_cfgs.items():
            start(name, "clustermgr", cfg)
        up(list(cm_cfgs))
        leader = wait_for(lambda: leader_of(cm_addrs), "a clustermgr leader")
        follower = next(a for a in cm_addrs if a != leader)
        nodes = [f"blobnode{i}" for i in range(BLOB_NODES)]
        for i, name in enumerate(nodes):
            start(name, "blobnode", {
                "node_id": i, "clustermgr_addr": follower,
                "data_dirs": [os.path.join(workdir, f"bn{i}d{d}") for d in range(BLOB_DISKS)]})
        scheds = [f"scheduler{i}" for i in range(3)]
        for i, (name, a) in enumerate(zip(scheds, sched_addrs)):
            start(name, "scheduler", {
                "listen_port": int(a.rsplit(":", 1)[1]), "mq_me": a, "mq_peers": sched_addrs,
                "mq_dir": os.path.join(workdir, f"mq{i}"),
                "data_dir": os.path.join(workdir, f"sched{i}")})
        node_addrs = up(nodes)  # started together: each opens its own card context
        up(scheds)
        # a blobnode registers its disks after it prints its listening line
        wait_for(lambda: (answer(leader, "stat") or {}).get("disks") == BLOB_NODES * BLOB_DISKS,
                 "every disk registered with the leader")
        start("proxy", "proxy", {"clustermgr_addr": follower})
        proxy = up(["proxy"])[0]
        start("access", "access", {"clustermgr_addr": follower, "mq_members": sched_addrs,
                                   "proxy_addr": proxy, "ec_engine": "cuda",
                                   "blob_size": blob_size})
        acc = up(["access"])[0]
        wait_for(lambda: bus_led(sched_addrs), "the bus partitions to elect")
        startup_s = time.perf_counter() - t

        # -- PUTs and GETs through the replicated clustermgr -------------------
        locs, payloads = puts("put_before")
        reads_equal("get_before", locs, payloads)
        mode = cm.CodeMode(locs[0]["codemode"])
        tac = cm.tactic(mode)
        sl0 = locs[0]["slices"][0]
        vol0 = on_leader("get_volume", {"vid": sl0["vid"]})["volume"]
        parity_equal = parity_equals_plain(vol0, sl0["min_bid"], tac.n, tac.m)

        # -- the clustermgr leader killed: the election ------------------------
        # the leader as it stands now: the startup's load may have moved it
        first_leader = leader
        leader, old_term = wait_for(lambda: next(
            ((a, st["term"]) for a in cm_addrs
             if (st := answer(a, "raft_status")) and st["role"] == "leader"), None),
            "the clustermgr leader before the kill")
        old = next(n for n, c in cm_cfgs.items() if c["me"] == leader)
        raft_counters = {"leader_before_kill": raft_series(leader),
                         "group_before_kill": group_series()}
        t = time.perf_counter()
        kill(old)
        rest = [a for a in cm_addrs if a != leader]
        new_leader = wait_for(lambda: leader_of(rest), "a new clustermgr leader")
        election_s = time.perf_counter() - t
        new_term = answer(new_leader, "raft_status")["term"]

        more_locs, more = puts("put_after")
        locs, payloads = locs + more_locs, payloads + more
        reads_equal("get_after", locs, payloads)

        # -- the killed member back from its directory -------------------------
        t = time.perf_counter()
        start(old, "clustermgr", cm_cfgs[old])
        up([old])
        want = answer(new_leader, "raft_status")
        back = wait_for(lambda: (lambda s: s if s and s["applied"] >= want["commit"]
                                 and s["role"] == "follower" else None)(
            answer(leader, "raft_status")), "the restarted member to catch up")
        catch_up_s = time.perf_counter() - t
        reads = [("stat", {}), ("scope_watermark", {"name": "bid"}), ("list_config", {}),
                 ("kv_list", {}), ("get_service", {"name": "proxy"})]
        leader_now = wait_for(lambda: leader_of(cm_addrs), "the clustermgr leader")
        reads_equal_leader = all(answer(leader, m, a) == answer(leader_now, m, a)
                                 for m, a in reads)
        redirect = rpc_post(leader, "get_volume", {"vid": sl0["vid"]})[:2]

        # -- one blobnode process stopped: degraded GETs -----------------------
        vols = on_leader("list_volumes", {})["volumes"]
        held = {a: {vid: [u["index"] for u in v["units"] if u["node_addr"] == a]
                    for vid, v in vols.items()} for a in node_addrs}
        victim = max((a for a in node_addrs
                      if max(len(ix) for ix in held[a].values()) <= tac.m),
                     key=lambda a: sum(i < tac.n for ix in held[a].values() for i in ix))
        vname = nodes[node_addrs.index(victim)]
        vproc = procs.pop(vname)
        vproc.p.terminate()
        codes[vname] = vproc.p.wait(60)
        lost_reads = sum(sl["count"] * sum(i < tac.n for i in held[victim][str(sl["vid"])])
                         for loc in locs for sl in loc["slices"])
        lost_blobs = sum(sl["count"] for loc in locs for sl in loc["slices"]
                         if any(i < tac.n for i in held[victim][str(sl["vid"])]))
        reads_equal("degraded_get", locs, payloads)

        # -- the bus: every member's backlog, then one member killed -----------
        put_events = wait_for(lambda: (lambda b: b[0] if b[0] and len(set(b)) == 1 else None)(
            [backlog(a) for a in sched_addrs]), "the repair events on every bus member")
        views_before = wait_for(lambda: (lambda v: v if all(v.values()) and any(
            v[a]["repair"][0][0] == "leader" for a in v) else None)(
            {a: bus(a) for a in sched_addrs}), "the repair topic's leader")
        bus_leader = next(a for a in sched_addrs if views_before[a]["repair"][0][0] == "leader")
        killed_sched = scheds[sched_addrs.index(bus_leader)]
        codes[killed_sched] = kill(killed_sched)
        survivors = [a for a in sched_addrs if a != bus_leader]
        wait_for(lambda: bus_led(survivors), "the bus to re-elect among the survivors")
        survivor_backlogs = [backlog(a) for a in survivors]
        polled = answer(survivors[0], "mq_status")

        raft_counters["leader_at_end"] = raft_series(new_leader)
        launches = {"gf_apply": scrape(acc).get(LAUNCH_A, 0.0)}
    finally:
        for name, p in procs.items():
            p.p.terminate()
        for name, p in procs.items():
            try:
                codes[name] = p.p.wait(30)
            except subprocess.TimeoutExpired:
                p.p.kill()
                codes[name] = p.p.wait()
        shutil.rmtree(workdir, ignore_errors=True)

    k = cases
    checks = {
        "put_codemode_ec12p4": mode == cm.CodeMode.EC12P4,
        "get_before.equal": k["get_before"]["equal"],
        "get_after.equal": k["get_after"]["equal"],
        "degraded_get.equal": k["degraded_get"]["equal"],
        "parity_equals_plain": parity_equal,
        "new_leader_elected": new_leader in rest and new_term > old_term,
        "put_before_launched_a_each": k["put_before"]["a_launches"] >= n_puts,
        "put_after_launched_a_each": k["put_after"]["a_launches"] >= n_puts,
        "degraded_launched_a_per_lost_blob": lost_blobs > 0
        and k["degraded_get"]["a_launches"] >= lost_blobs,
        "restarted_member_caught_up": back["applied"] >= want["commit"]
        and back["role"] == "follower",
        "restarted_member_reads_equal_leader": reads_equal_leader,
        "restarted_member_redirects": redirect == (421, {"error": f"leader={leader_now}"}),
        "repair_events_put": 0 < put_events <= lost_reads,
        "survivors_hold_every_event": survivor_backlogs == [put_events] * 2,
        "raft_counters_scraped": len(raft_counters["group_before_kill"]) == 3
        and raft_counters["group_before_kill"]["cubefs_raft_proposals_total"]
        >= BLOB_NODES * BLOB_DISKS
        and raft_counters["leader_at_end"].get("cubefs_raft_wal_fsyncs_total", 0) > 0,
        "every_role_exited_0": all(rc == 0 for n, rc in codes.items()
                                   if n not in (killed_sched,)),
        "killed_exited_by_sigkill": codes[killed_sched] == -signal.SIGKILL,
    }
    return {"phase": "raft", "card": card, "seconds": time.perf_counter() - t_phase,
            "startup_s": startup_s,
            "cluster": {"clustermgrs": 3, "nodes": BLOB_NODES, "disks_per_node": BLOB_DISKS,
                        "schedulers": 3, "mq_partitions": 2, "proxy": 1,
                        "blob_size": blob_size,
                        "put_bytes": put, "puts": 2 * n_puts, "codemode": mode.name,
                        "blob_shard": -(-blob_size // tac.n)},
            "cases": cases, "election_s": election_s, "catch_up_s": catch_up_s,
            "leaders": {"first": first_leader, "before": leader, "after": new_leader,
                        "at_catch_up": leader_now, "follower_pointed_at": follower,
                        "terms": [old_term, new_term]},
            "restarted": {"status": back, "leader_commit": want["commit"]},
            "raft_counters": raft_counters,
            "bus": {"repair_events": put_events, "failed_data_reads": lost_reads,
                    "killed": killed_sched, "survivor_backlogs": survivor_backlogs,
                    "survivor_view": polled},
            "degraded": {"stopped": vname, "blobs_lost_a_data_unit": lost_blobs},
            "exit_codes": codes, "launches": launches, "checks": checks}


def integrity_phase(dev, card: str, *, put: int = BLOB_PUT, n_objects: int = INTEGRITY_OBJECTS,
                    blob_size: int = BLOB, n_gets: int = INTEGRITY_GETS) -> dict:
    """Phase ``integrity``: the blob plane's integrity sweep on the card,
    in process, with the cluster of phase ``blob`` (6 blobnodes x 3 disks,
    8 MiB blobs, EC12P4 by policy) and access, the scheduler and the
    repair worker on engine ``cuda``, so every parity recompute of the
    scrub is one step of kernel A (``StagedEngine``: the group's stripes
    copied to the card, A, the parity copied back).

    ``n_objects`` PUTs of ``put`` bytes; a clean full pass
    (``Scheduler.make_scrubber().run_full_pass()``): its wall seconds, the
    shard bytes it verified per second, the stripes it checked, A's
    launches and the leg that served its steps, the outcomes it counted;
    4 bitflips planted (``faultinject.FaultPlan.plant_rot``) in stripes of
    different volumes where there are enough, 2 in data units and 2 in
    parity units, a pass that must name exactly the volumes with rot and
    queue repairs of exactly the planted units, the worker's drain, each
    rebuilt unit held against what the PUT wrote, and a second pass that
    must be clean; read-repair of a data shard whose read refuses (its
    GET exact, the shard rewritten, healed by ``read``), then the same
    with ``CUBEFS_VERIFY_READS=0`` (detected, not rewritten); the doors
    (``CUBEFS_SCRUB=0``, a pinned brownout, the brownout under
    ``CUBEFS_QOS=0``); and ``n_gets`` GETs alone and while a full pass
    runs in another thread (medians only). The QoS gate's burn signal is
    pinned quiet for the phase (the brownout is pinned where it is
    tested), as the tests pin it: the earlier phases' slow calls would
    otherwise shed the scrub. Returns the record with ``checks`` and
    ``launches`` (the path's)."""
    from cubefs_tpu_torch.blob.access import AccessConfig, AccessHandler
    from cubefs_tpu_torch.blob.blobnode import BlobNode
    from cubefs_tpu_torch.blob.clustermgr import ClusterMgr
    from cubefs_tpu_torch.blob.mq import MessageQueue
    from cubefs_tpu_torch.blob.scheduler import Scheduler
    from cubefs_tpu_torch.blob.worker import RepairWorker
    from cubefs_tpu_torch.codec import codemode as cm
    from cubefs_tpu_torch.codec import engine as engines
    from cubefs_tpu_torch.ops import _build
    from cubefs_tpu_torch.utils import faultinject as fi
    from cubefs_tpu_torch.utils import metrics, qos, rpc

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 13)
    print(json.dumps({"phase": "integrity", "card": card}), flush=True)
    _build.reset_launches()
    workdir = tempfile.mkdtemp(prefix="cubefs-smoke-integrity-")
    doors = ("CUBEFS_SCRUB", "CUBEFS_QOS", "CUBEFS_VERIFY_READS")
    env = {v: os.environ.pop(v, None) for v in doors}
    gate = (qos.DEFAULT._tracker, qos.DEFAULT._levels, qos.DEFAULT._last_refresh)
    qos.DEFAULT._tracker, qos.DEFAULT._levels = Quiet(), {}
    qos.DEFAULT._last_refresh = float("-inf")
    cases: dict[str, dict] = {}
    nodes: list = []
    acc = None
    verdicts: dict = {}

    def node_of(u):
        return nodes[int(u.node_addr.removeprefix("node"))]

    def unit_shards(vid: int, idx: int) -> dict:
        u = cmgr.get_volume(vid).units[idx]
        n = node_of(u)
        return {bid: n.get_shard(u.disk_id, u.chunk_id, bid)[0]
                for bid, _, _ in n.list_chunk(u.disk_id, u.chunk_id)}

    def detected(source: str) -> float:
        return metrics.integrity_corruptions_detected.value(plane="blob", source=source)

    def healed(source: str) -> float:
        return metrics.integrity_corruptions_healed.value(plane="blob", source=source)

    def scrub_pass(label: str, s) -> dict:
        a0, steps0 = _build.LAUNCHES["gf_apply"], counter(metrics.codec_batch_steps, op="encode")
        items0, det0 = counter(metrics.scrub_items, plane="blob"), detected("scrub")
        verdicts.clear()
        t = time.perf_counter()
        res = s.run_full_pass()
        secs = time.perf_counter() - t
        cases[label] = {"result": res, "seconds": secs, "stripes": stripes,
                        "at_rest_bytes": at_rest, "gib_s": at_rest / secs / 2**30,
                        "a_launches": _build.LAUNCHES["gf_apply"] - a0,
                        "encode_steps": delta(steps0, counter(metrics.codec_batch_steps,
                                                              op="encode")),
                        "last_dispatch": dict(engines.last_dispatch),
                        "items": delta(items0, counter(metrics.scrub_items, plane="blob")),
                        "detected": detected("scrub") - det0, "verdicts": dict(verdicts)}
        return cases[label]

    def gets(label: str, objs: list) -> list:
        ms, out = [], []
        for loc, _ in objs:
            t = time.perf_counter()
            out.append(acc.get(loc))
            ms.append((time.perf_counter() - t) * 1e3)
        cases[label] = {"count": len(objs), "median_ms": statistics.median(ms),
                        "equal": all(g == d for g, (_, d) in zip(out, objs))}
        return out

    try:
        cmgr = ClusterMgr()
        cmc, pool = rpc.Client(cmgr), rpc.NodePool()
        for i in range(BLOB_NODES):
            node = BlobNode(i, [os.path.join(workdir, f"n{i}d{d}") for d in range(BLOB_DISKS)],
                            cmc, addr=f"node{i}", device=dev, engine="cuda")
            node.register()
            node.send_heartbeat()
            pool.bind(node.addr, node)
            nodes.append(node)
        repair_q = MessageQueue()
        acc = AccessHandler(cmc, pool, AccessConfig(blob_size=blob_size, engine="cuda",
                                                    device=dev), repair_queue=repair_q)
        sched = Scheduler(cmgr, repair_queue=repair_q, node_pool=pool, device=dev,
                          engine="cuda")
        wk = RepairWorker(rpc.Client(sched), cmc, pool, engine="cuda", device=dev)

        # -- the objects, and what the scrub has to read ----------------------
        payloads = [rng.integers(0, 256, put, dtype=np.uint8).tobytes()
                    for _ in range(n_objects)]
        t = time.perf_counter()
        objs = [(acc.put(p), p) for p in payloads]
        put_s = time.perf_counter() - t
        mode = cm.CodeMode(objs[0][0].codemode)
        tac = cm.tactic(mode)
        vids = sorted({sl.vid for loc, _ in objs for sl in loc.slices})
        bids = {vid: sorted(b for b, _, _ in node_of(cmgr.get_volume(vid).units[0]).list_chunk(
            cmgr.get_volume(vid).units[0].disk_id, cmgr.get_volume(vid).units[0].chunk_id))
            for vid in vids}
        stripes = sum(min(len(b), 4096) for b in bids.values())
        at_rest = sum(size for vid in vids for u in cmgr.get_volume(vid).units
                      for _, size, _ in node_of(u).list_chunk(u.disk_id, u.chunk_id))
        s = sched.make_scrubber()
        unit = s.scrub_unit
        s.scrub_unit = lambda vid: verdicts.setdefault(vid, unit(vid))

        # -- a clean pass ------------------------------------------------------
        clean = scrub_pass("clean_pass", s)

        # -- 4 bitflips: 2 data units, 2 parity units, in 4 stripes -----------
        targets = [(vids[i % len(vids)], idx) for i, idx in enumerate((2, 7, tac.n, tac.n + 3))]
        planted = []
        originals = {}
        plan = fi.FaultPlan(seed=SEED + 13)
        fi.install(plan)
        for i, (vid, idx) in enumerate(targets):
            originals[(vid, idx)] = unit_shards(vid, idx)
            bid = bids[vid][(i // len(vids)) % len(bids[vid])]  # another stripe per volume
            u = cmgr.get_volume(vid).units[idx]
            plan.plant_rot(u.node_addr, u.disk_id, f"c{u.chunk_id}:b{bid}", kind="bitflip")
            planted.append({"vid": vid, "unit": idx, "bid": bid, "disk": u.disk_id})
        rot = scrub_pass("rot_pass", s)
        queued = sorted((t["vid"], t["unit_index"]) for t in sched.tasks.values()
                        if t["state"] == "pending")
        a0, t = _build.LAUNCHES["gf_apply"], time.perf_counter()
        while wk.run_once():
            pass
        cases["repair"] = {"tasks": len(queued), "completed": wk.completed, "failed": wk.failed,
                           "seconds": time.perf_counter() - t,
                           "a_launches": _build.LAUNCHES["gf_apply"] - a0,
                           "rebuilt_bytes": sum(len(b) for d in originals.values()
                                                for b in d.values())}
        rebuilt_equal = all(
            unit_shards(vid, idx) == want and cmgr.get_volume(vid).units[idx].disk_id
            != next(p["disk"] for p in planted if (p["vid"], p["unit"]) == (vid, idx))
            for (vid, idx), want in originals.items())
        second = scrub_pass("second_pass", s)
        gets("get_after_repair", objs)
        fi.uninstall()

        # -- read-repair, then the same with CUBEFS_VERIFY_READS=0 ------------
        sl = objs[0][0].slices[0]
        rr = {}
        for door, idx in (("1", 3), ("0", 4)):
            os.environ["CUBEFS_VERIFY_READS"] = door
            plan = fi.FaultPlan(seed=SEED + 14)
            fi.install(plan)
            want = unit_shards(sl.vid, idx)[sl.min_bid]
            u = cmgr.get_volume(sl.vid).units[idx]
            plan.plant_rot(u.node_addr, u.disk_id, f"c{u.chunk_id}:b{sl.min_bid}",
                           kind="stale_crc")
            d0, h0, a0 = detected("read"), healed("read"), _build.LAUNCHES["gf_apply"]
            got = acc.get(objs[0][0])
            rr[door] = {"equal": got == objs[0][1], "detected": detected("read") - d0,
                        "healed": healed("read") - h0, "rot_left": plan.rot_remaining(),
                        "a_launches": _build.LAUNCHES["gf_apply"] - a0}
            fi.uninstall()
            rr[door]["shard_equal"] = unit_shards(sl.vid, idx)[sl.min_bid] == want
            del os.environ["CUBEFS_VERIFY_READS"]
        cases["read_repair"], cases["read_repair_door_off"] = rr["1"], rr["0"]

        # -- foreground GETs alone, then under a full pass --------------------
        fg = objs[:n_gets]
        gets("gets_alone", fg)
        under: dict = {}
        runner = threading.Thread(target=lambda: under.update(scrub_pass("pass_under_gets", s)))
        runner.start()
        gets("gets_under_scrub", fg)
        runner.join()

        # -- the doors --------------------------------------------------------
        os.environ["CUBEFS_SCRUB"] = "0"
        door_scrub = s.run_once()
        del os.environ["CUBEFS_SCRUB"]
        qos.DEFAULT.force_level("blob.get", 1)
        door_brownout = s.run_once(max_units=1)
        os.environ["CUBEFS_QOS"] = "0"
        door_qos_off = s.run_once(max_units=1)
        del os.environ["CUBEFS_QOS"]
        qos.DEFAULT.force_level("blob.get", None)
        status = sched.rpc_scrub_status({}, None)["scrub"]
        launches = dict(_build.LAUNCHES)
    finally:
        fi.uninstall()
        qos.DEFAULT.force_level("blob.get", None)
        qos.DEFAULT._tracker, qos.DEFAULT._levels, qos.DEFAULT._last_refresh = gate
        for v, old in env.items():
            if old is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = old
        if acc is not None:
            acc._pool.shutdown(wait=True)
        for node in nodes:
            node.stop()
        shutil.rmtree(workdir, ignore_errors=True)

    rot_vids = sorted({vid for vid, _ in targets})
    scrub_launches = sum(cases[k]["a_launches"]
                         for k in ("clean_pass", "rot_pass", "second_pass", "pass_under_gets"))
    checks = {
        "put_codemode_ec12p4": mode == cm.CodeMode.EC12P4,
        "clean_pass_all_clean": clean["result"]["completed_pass"]
        and clean["result"]["scanned"] == len(vids) == clean["items"].get("clean")
        and clean["result"]["corrupt"] == clean["result"]["skipped"] == 0,
        "clean_pass_launched_a_on_cuda": clean["a_launches"] > 0
        and clean["encode_steps"].get("cuda", 0) > 0
        and clean["last_dispatch"].get("served") == "cuda",
        "rot_pass_names_the_volumes": sorted(v for v, o in rot["verdicts"].items()
                                             if o == "corrupt") == rot_vids
        and rot["result"]["corrupt"] == len(rot_vids),
        "rot_detected_4": rot["detected"] == 4,
        "rot_tasks_name_the_planted_units": queued == sorted(targets),
        "repair_all_done": cases["repair"]["completed"] == len(queued) == 4
        and cases["repair"]["failed"] == 0,
        "rebuilt_equal_put": rebuilt_equal,
        "second_pass_clean": second["result"]["corrupt"] == 0
        and second["result"]["skipped"] == 0 and second["result"]["completed_pass"],
        "get_after_repair.equal": cases["get_after_repair"]["equal"],
        "read_repair_heals": rr["1"]["equal"] and rr["1"]["healed"] == 1
        and rr["1"]["detected"] >= 1 and rr["1"]["rot_left"] == 0 and rr["1"]["shard_equal"],
        "verify_reads_off_detects_only": rr["0"]["equal"] and rr["0"]["healed"] == 0
        and rr["0"]["detected"] >= 1 and rr["0"]["rot_left"] == 1,
        "gets_equal": cases["gets_alone"]["equal"] and cases["gets_under_scrub"]["equal"],
        "scrub_door_closed": door_scrub.get("door") == "closed" and door_scrub["scanned"] == 0,
        "brownout_sheds": door_brownout.get("suppressed") is True
        and door_brownout["scanned"] == 0,
        "qos_off_does_not_shed": "suppressed" not in door_qos_off
        and door_qos_off["scanned"] == 1,
        "scrub_launched_a": scrub_launches > 0,
    }
    return {"phase": "integrity", "card": card, "seconds": time.perf_counter() - t_phase,
            "cluster": {"nodes": BLOB_NODES, "disks_per_node": BLOB_DISKS,
                        "blob_size": blob_size, "put_bytes": put, "objects": n_objects,
                        "codemode": mode.name, "blob_shard": -(-blob_size // tac.n),
                        "volumes": len(vids), "stripes": stripes, "at_rest_bytes": at_rest},
            "put_s": put_s, "planted": planted, "queued": queued, "cases": cases,
            "doors": {"scrub_off": door_scrub, "brownout": door_brownout,
                      "brownout_qos_off": door_qos_off},
            "status": status, "scrub_launches": scrub_launches, "launches": launches,
            "checks": checks}


def shardnode_phase(dev, card: str, *, items: int = SN_ITEMS, value: int = SN_VALUE,
                    threads: int = SN_THREADS, n_shards: int = 4) -> dict:
    """Phase ``shardnode``: the blob plane's metadata shards, on the host
    (no kernel; the native KV store, ``csrc/host/kvstore.cc``, is built
    and run on this machine). 3 ``ShardNode``s, each behind its own
    ``RpcServer`` on 127.0.0.1 with a data directory, and a spare; a
    clustermgr catalog space of ``n_shards`` shards, each a raft group on
    the 3. The clients call the nodes over HTTP; raft between the nodes
    and the scheduler's worker ride direct calls on one ``NodePool``, as
    the reference's shardnode tests wire them: over HTTP a raft message
    travels in one header, which Python's HTTP server caps at 64 KiB, and
    a new replica's catch-up here (thousands of 1 KiB entries, or a
    snapshot of them) is one message (ROADMAP.md §3). ``threads``
    clients put ``items`` values of ``value`` bytes through a
    leader-following client routed by the catalog, then get
    every item and list a prefix; one shard splits at its median and the
    catalog registers it (``route_key`` sends the upper half to the
    child; every group's term stays flat for 5 s after); one node stops
    (its server, the connections it accepted and its groups: a process's
    death), the clustermgr suspects it after its heartbeat window, the
    scheduler queues a ``shard_repair`` per shard it held, and the
    worker's swaps move its replicas to the spare; every item is read
    from the new replica sets, the live nodes restart from their
    directories, and every item is read again. ``dev`` is the
    scheduler's and the worker's codec device (they run no kernel
    here). Returns the record with ``checks``."""
    import socket

    from cubefs_tpu_torch.blob.clustermgr import ClusterMgr
    from cubefs_tpu_torch.blob.scheduler import Scheduler
    from cubefs_tpu_torch.blob.shardnode import ShardNode
    from cubefs_tpu_torch.blob.worker import RepairWorker
    from cubefs_tpu_torch.utils import rpc

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 15)
    print(json.dumps({"phase": "shardnode", "card": card}), flush=True)
    workdir = tempfile.mkdtemp(prefix="cubefs-smoke-shardnode-")
    served: dict[str, tuple] = {}  # addr -> (ShardNode, RpcServer, accepted sockets)
    leaders: dict[int, str] = {}
    cases: dict[str, dict] = {}
    hb_stop = threading.Event()

    addrs = [f"127.0.0.1:{free_port()}" for _ in range(4)]  # 3 replicas and a spare
    replicas, spare = addrs[:3], addrs[3]
    pool = rpc.NodePool()  # raft's transport between the nodes, and the worker's

    def start(addr: str) -> None:
        i = addrs.index(addr)
        sn = ShardNode(i, addr=addr, node_pool=pool, data_dir=os.path.join(workdir, f"sn{i}"))
        pool.bind(addr, sn)
        srv = rpc.RpcServer(sn, port=int(addr.rsplit(":", 1)[1]), service="shardnode")
        conns: list = []
        accept = srv._httpd.process_request

        def tracked(request, client_address):
            conns.append(request)
            accept(request, client_address)

        srv._httpd.process_request = tracked
        served[addr] = (sn, srv.start(), conns)

    def stop(addr: str) -> None:
        """A process's death: its server, the connections it accepted (whose
        handler threads would go on serving the stopped node) and its groups."""
        sn, srv, conns = served.pop(addr)
        srv.stop()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass  # its peer closed it
        pool.bind(addr, object())  # a dead target: every call to it fails
        sn.stop()

    def heartbeats() -> None:
        while not hb_stop.wait(1.0):
            for sn, _, _ in list(served.values()):
                sn.send_heartbeat(cmc)

    def wait_for(cond, what: str, timeout: float = 60.0):
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            got = cond()
            if got:
                return got
            time.sleep(0.05)
        raise AssertionError(f"phase shardnode: timed out waiting for {what}")

    ambiguous = collections.Counter()  # method -> retried raft commit timeouts

    def kv(method: str, shard: dict, args: dict, body: bytes = b"", timeout: float = 60.0):
        """One call on the shard's leader: a 421 names it, a member that is
        down or not yet elected passes the call to the next. A ``kv_put``
        whose raft entry was not committed within the proposal timeout
        (a 500 ``TimeoutError``: its outcome is unknown, as when a leader
        change dropped the entry and no later entry reached its index) is
        sent again, since putting the same bytes twice is one put; the
        retries are counted in the record."""
        sid, members = shard["shard_id"], shard["addrs"]
        addr = leaders.get(sid, members[0])
        deadline = time.perf_counter() + timeout
        for i in itertools.count(1):
            leader = ""
            try:
                out = rpc.Client(addr, follow_redirects=False).call(
                    method, dict(args, shard_id=sid), body, timeout=10.0)
                leaders[sid] = addr
                return out
            except rpc.RpcError as e:
                unknown = (e.code == 500 and method == "kv_put"
                           and "not committed in time" in e.message)
                if e.code not in (421, 404, 503) and not unknown:
                    raise
                ambiguous[method] += unknown
                leader = e.message.removeprefix("leader=").strip() if e.code == 421 else ""
            except OSError:
                pass
            if time.perf_counter() > deadline:
                raise TimeoutError(f"phase shardnode: {method} on shard {sid}")
            addr = leader if leader in members else members[i % len(members)]
            if not leader:
                time.sleep(0.05)

    def route(key: str) -> dict:
        return cmgr.route_key("meta", key)

    def timed_ops(label: str, fn) -> list:
        lat = [0.0] * items

        def one(j: int):
            t = time.perf_counter()
            out = fn(j)
            lat[j] = (time.perf_counter() - t) * 1e3
            return out

        t = time.perf_counter()
        with ThreadPoolExecutor(threads) as ex:
            out = list(ex.map(one, range(items)))
        wall = time.perf_counter() - t
        ranked = sorted(lat)
        cases[label] = {"ops": items, "threads": threads, "seconds": wall,
                        "ops_s": items / wall, "p50_ms": statistics.median(lat),
                        "p99_ms": ranked[int(0.99 * (items - 1))], "max_ms": ranked[-1]}
        return out

    def get_all(label: str) -> bool:
        got = timed_ops(label, lambda j: kv("kv_get", route(keys[j]), {"key": keys[j]})[1])
        cases[label]["equal"] = all(g == values[j * value:(j + 1) * value].tobytes()
                                    for j, g in enumerate(got))
        return cases[label]["equal"]

    def terms() -> dict:
        return {(a, sid): r.status()["term"] for a, (sn, _, _) in served.items()
                for sid, r in sn.rafts.items()}

    def newest_terms(by_member: dict) -> dict:
        """Each shard's newest term over its members: the terms (elections,
        won or not) that the group has begun."""
        out: dict = {}
        for (_, sid), term in by_member.items():
            out[sid] = max(out.get(sid, 0), term)
        return out

    keys = [f"{int(h):04x}/obj{j:05d}" for j, h in enumerate(rng.integers(0, 1 << 16, items))]
    values = rng.integers(0, 256, items * value, dtype=np.uint8)
    hb = threading.Thread(target=heartbeats, daemon=True)
    try:
        t = time.perf_counter()
        cmgr = ClusterMgr()
        cmc = rpc.Client(cmgr)
        for a in addrs:
            start(a)
            cmgr.register_service("shardnode", a)
            cmgr.shardnode_heartbeat(a)
        hb.start()
        space = cmgr.create_space("meta", n_shards, replicas)
        for sh in space:
            for a in replicas:
                rpc.Client(a, follow_redirects=False).call("create_shard", {
                    "shard_id": sh["shard_id"], "start": sh["start"], "end": sh["end"],
                    "peers": replicas})
        for sh in space:
            kv("shard_stat", sh, {})
            wait_for(lambda sh=sh: any(served[a][0].rafts[sh["shard_id"]].status()["role"]
                                       == "leader" for a in replicas), "every shard's leader")
        startup_s = time.perf_counter() - t

        # -- puts, gets, a prefix ---------------------------------------------
        terms_before_put = terms()
        timed_ops("put", lambda j: kv("kv_put", route(keys[j]), {"key": keys[j]},
                                      values[j * value:(j + 1) * value].tobytes()))
        cases["put"]["new_terms"] = sum(newest_terms(terms()).values()) - sum(
            newest_terms(terms_before_put).values())
        cases["put"]["unknown_outcome_retries"] = ambiguous["kv_put"]
        get_all("get")
        prefix = keys[0][:2]
        listed = kv("kv_list", route(prefix), {"prefix": prefix, "limit": items})[0]["keys"]
        list_equal = listed == sorted(k for k in keys if k.startswith(prefix))

        # -- a split, registered with the catalog -----------------------------
        parent = space[0]
        child = cmgr.alloc_shard_id()
        t = time.perf_counter()
        split = kv("shard_split", parent, {"child_id": child})[0]
        cmgr.register_split("meta", parent["shard_id"], child, split["split_key"])
        wait_for(lambda: all(child in served[a][0].shards and served[a][0].shards[
            parent["shard_id"]].end == split["split_key"] for a in replicas),
            "the split on every replica")
        wait_for(lambda: any(served[a][0].rafts[child].status()["role"] == "leader"
                             for a in replicas), "the child's leader")
        split_s = time.perf_counter() - t
        upper = [k for k in keys if split["split_key"] <= k
                 and (not parent["end"] or k < parent["end"])]
        lower = [k for k in keys if parent["start"] <= k < split["split_key"]]
        routed = ({route(k)["shard_id"] for k in upper} == {child}
                  and {route(k)["shard_id"] for k in lower} == {parent["shard_id"]})
        terms_after_split = terms()
        time.sleep(5.0)
        terms_flat = terms() == terms_after_split

        # -- one node stopped: the shard tasks move its replicas -------------
        victim = replicas[1]
        held = sorted(sid for sid in served[victim][0].rafts)
        t_stop = time.perf_counter()
        stop(victim)
        suspected = wait_for(lambda: cmgr.suspect_dead_shardnodes(), "the stopped node suspected",
                             timeout=cmgr.HEARTBEAT_TIMEOUT + 30)
        sched = Scheduler(cmgr, node_pool=pool, device=dev)
        wk = RepairWorker(rpc.Client(sched), cmc, pool, device=dev)
        collected = sched.collect_dead_shardnodes()
        requeued = sched.repair_shardnode(victim)  # idempotent: the same tasks
        tasks = [t_ for t_ in sched.tasks.values() if t_["type"] == "shard_repair"]
        while wk.run_once():
            pass
        swap_s = time.perf_counter() - t_stop
        live = [spare if a == victim else a for a in replicas]
        catalog = cmgr.snapshot_spaces()["meta"]
        repointed = all(sh["addrs"] == live for sh in catalog)
        leaders.clear()
        get_all("get_after_swap")

        def caught_up() -> bool:
            counts = {a: {sid: served[a][0].shards[sid].count() for sid in held}
                      for a in live}
            return all(c == counts[live[0]] for c in counts.values()) and \
                sum(counts[spare].values()) == items

        wait_for(caught_up, "the spare to hold every item")

        # -- every live node restarted from its directory --------------------
        t = time.perf_counter()
        for a in live:
            stop(a)
        for a in live:
            start(a)
        leaders.clear()
        restart_s = time.perf_counter() - t
        get_all("get_after_restart")
    finally:
        hb_stop.set()
        for a in list(served):
            stop(a)
        shutil.rmtree(workdir, ignore_errors=True)

    checks = {
        "get.equal": cases["get"]["equal"],
        "list_prefix_equal": list_equal,
        "split_registered_and_routed": routed and split["child_id"] == child,
        "terms_flat_after_split": terms_flat,
        "suspected_the_stopped_node": suspected == [victim] and collected == [victim],
        "one_task_per_shard_held": len(tasks) == len(held) > 0 and requeued == len(held),
        "swaps_done": wk.completed == len(tasks) and wk.failed == 0,
        "catalog_repointed_to_spare": repointed,
        "get_after_swap.equal": cases["get_after_swap"]["equal"],
        "get_after_restart.equal": cases["get_after_restart"]["equal"],
    }
    return {"phase": "shardnode", "card": card, "seconds": time.perf_counter() - t_phase,
            "cluster": {"nodes": 3, "spare": 1, "shards": n_shards, "items": items,
                        "value_bytes": value, "threads": threads,
                        "item_bytes": items * value, "replicated_bytes": 3 * items * value},
            "startup_s": startup_s, "cases": cases, "split": dict(split, seconds=split_s),
            "stopped": victim, "shards_held": held, "stop_to_last_swap_s": swap_s,
            "restart_s": restart_s, "catalog": catalog,
            "checks": checks}


def fs_phase(dev, card: str, *, files: int = FS_FILES, file_size: int = FS_FILE,
             writers: int = FS_WRITERS, meta_threads: int = FS_META_THREADS,
             meta_files: int = FS_META_FILES, meta_size: int = FS_META_SIZE,
             tier: int = FS_TIER, blob_size: int = BLOB, device: str | None = None) -> dict:
    """Phase ``fs``: the file-system plane as its users start it. The
    launcher (``deploy.Cluster``) starts a master, 3 metanodes and 4
    datanodes (replicas 3), the volume ``vol1`` (3 meta and 4 data
    partitions) and, beside them, a clustermgr and 6 blobnodes x 3 disks,
    each a ``python -m cubefs_tpu_torch.cmd`` process. The client, a
    ``FileSystem`` with ``CUBEFS_TIERING=1``, runs in this process; its
    ``blob_client`` is a ``BlobClient`` whose ``AccessHandler`` runs
    engine ``cuda`` on ``dev`` (8 MiB blobs, EC12P4 by policy), so kernel
    A launches here.

    Data path: ``files`` files of ``file_size`` bytes written from
    ``writers`` threads over the packet plane (chunk trains past
    ``CUBEFS_PKT_CHUNK``) and read back through the datanodes' native
    read plane. Metadata path: ``meta_threads`` threads each create and
    write ``meta_files`` files of ``meta_size`` bytes, then a ``readdir``,
    a ``stat`` of each, a rename of each and an unlink of half, timed per
    op; group commit is read from the metanodes' ``/metrics``. Cold tier:
    the first ``tier`` files, aged, are tiered by one ``LcNode`` scan;
    each must be ``cold.location``-only, each tiered blob's parity
    (fetched from the blobnodes) equal the plain version, each cold read
    equal the hot bytes, healthy and with one blobnode process stopped
    (A reconstructs); a re-heated file untiers, and the reap empties the
    blob freelist. Last, one datanode process is stopped and every file
    is read again (replica failover). Every role must exit 0 on SIGTERM.
    ``device`` is the roles' (None: the card). Returns the record with
    ``checks`` and ``launches`` (this process's)."""
    from cubefs_tpu_torch.blob.access import AccessConfig
    from cubefs_tpu_torch.blob.sdk import BlobClient
    from cubefs_tpu_torch.codec import codemode as cm
    from cubefs_tpu_torch.deploy.cluster import Cluster
    from cubefs_tpu_torch.fs.client import FileSystem
    from cubefs_tpu_torch.fs.lcnode import LcNode, LifecycleRule
    from cubefs_tpu_torch.ops import _build
    from cubefs_tpu_torch.runtime import fsnative
    from cubefs_tpu_torch.utils import metrics, packet, qos, rpc

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 17)
    print(json.dumps({"phase": "fs", "card": card}), flush=True)
    t = time.perf_counter()
    fsnative.load()  # the extent store and both read planes, built once for every role
    native_build_s = time.perf_counter() - t
    workdir = tempfile.mkdtemp(prefix="cubefs-smoke-fs-")
    gate = (qos.DEFAULT._tracker, qos.DEFAULT._levels, qos.DEFAULT._last_refresh)
    qos.DEFAULT._tracker, qos.DEFAULT._levels = Quiet(), {}
    qos.DEFAULT._last_refresh = float("-inf")
    saved_env = {v: os.environ.pop(v, None) for v in ("CUBEFS_TIERING", "CUBEFS_UNTIER_HOT")}
    cases: dict[str, dict] = {}
    topo = {"metanodes": 3, "datanodes": 4, "replicas": 3,
            "volume": {"name": "vol1", "mp_count": 3, "dp_count": 4},
            "blobnodes": BLOB_NODES, "disks_per_blobnode": BLOB_DISKS, "access": False,
            "device": device}
    c = Cluster(topo, workdir, timeout=300.0)
    fs = None
    codes: dict = {}

    def a_launches() -> int:
        return _build.LAUNCHES["gf_apply"]

    def wait_for(cond, what: str, timeout: float = 120.0):
        deadline = time.perf_counter() + timeout
        while True:
            try:
                got = cond()
                if got:
                    return got
            except Exception as e:  # an election in progress
                err = e
            else:
                err = None
            if time.perf_counter() > deadline:
                raise AssertionError(f"phase fs: timed out waiting for {what}: {err}")
            time.sleep(0.1)

    def reads(label: str, paths: list, want: list, threads: int) -> None:
        got = [None] * len(paths)

        def one(i):
            for j in range(i, len(paths), threads):
                got[j] = fs.read_file(paths[j])
        secs = run_threads(threads, one)
        nbytes = sum(len(w) for w in want)
        cases[label] = {"files": len(paths), "bytes": nbytes, "seconds": secs,
                        "gib_s": nbytes / secs / 2**30,
                        "equal": all(g == w for g, w in zip(got, want))}

    def pkt_client() -> dict:
        return {d: metrics.pkt_frames.value(dir=d, side="client") for d in ("tx", "rx")}

    def scrape_sum(addrs: list, prefix: str) -> float:
        return sum(v for a in addrs for k, v in scrape(a).items() if k.startswith(prefix))

    def native_ops(addrs: list) -> int:
        return sum(rpc_post(a, "stat", {})[1]["native_read_ops"] for a in addrs)

    try:
        t = time.perf_counter()
        state = c.up()
        startup_s = time.perf_counter() - t
        roles = state["roles"]
        master, cmgr = roles["master"][0], roles["clustermgr"][0]
        metas, datas = roles["metanode"], roles["datanode"]
        view = rpc.call(master, "client_view", {"name": state["volume"]})[0]["volume"]
        pool = rpc.NodePool()
        acfg = AccessConfig(blob_size=blob_size, engine="cuda", device=dev)
        blob = BlobClient(cmgr, pool, acfg)
        os.environ["CUBEFS_TIERING"] = "1"
        try:
            fs = FileSystem(view, pool, blob_client=blob)
        finally:
            os.environ.pop("CUBEFS_TIERING", None)
        # per-partition raft groups elect their leaders first
        t = time.perf_counter()
        for d in ("/data", "/cold", "/meta"):
            wait_for(lambda d=d: fs.mkdir(d), f"mkdir {d}")
        election_s = time.perf_counter() - t

        # -- data path: 4 writers over the packet plane -------------------------
        _build.reset_launches()
        paths = [f"/cold/f{i}" if i < tier else f"/data/f{i}" for i in range(files)]
        payloads = [rng.integers(0, 256, file_size, dtype=np.uint8).tobytes()
                    for _ in range(files)]
        f0, dn0 = pkt_client(), native_ops(datas)

        def write(i):
            for j in range(i, files, writers):
                fs.write_file(paths[j], payloads[j])
        secs = run_threads(writers, write)
        f1 = pkt_client()
        cases["write"] = {"files": files, "bytes": files * file_size, "seconds": secs,
                          "gib_s": files * file_size / secs / 2**30,
                          "client_frames": {k: f1[k] - f0[k] for k in f1}}
        reads("read", paths, payloads, writers)
        cases["read"]["native_read_ops"] = native_ops(datas) - dn0

        # -- metadata path: 8 threads of small files ----------------------------
        lat: dict[str, list] = {k: [] for k in ("create_write", "stat", "rename", "unlink")}
        lock = threading.Lock()
        small = [rng.integers(0, 256, meta_size, dtype=np.uint8).tobytes()
                 for _ in range(meta_threads)]
        batched0 = scrape_sum(metas, "cubefs_meta_batched_ops_total")
        entries0 = scrape_sum(metas, "cubefs_meta_batch_entries_total")

        def timed_ops(kind: str, n: int, fn) -> None:
            def work(i):
                mine = []
                for j in range(i, n, meta_threads):
                    t = time.perf_counter()
                    fn(j)
                    mine.append((time.perf_counter() - t) * 1e3)
                with lock:
                    lat[kind].extend(mine)
            cases[f"meta_{kind}"] = op_stats(lat[kind], run_threads(meta_threads, work))

        n_meta = meta_threads * meta_files
        timed_ops("create_write", n_meta,
                  lambda j: fs.write_file(f"/meta/s{j}", small[j % meta_threads]))
        t = time.perf_counter()
        listing = fs.readdir("/meta")
        cases["meta_readdir"] = {"entries": len(listing),
                                 "ms": (time.perf_counter() - t) * 1e3}
        sizes = [0] * n_meta

        def stat(j):
            sizes[j] = fs.stat(f"/meta/s{j}")["size"]
        timed_ops("stat", n_meta, stat)
        timed_ops("rename", n_meta, lambda j: fs.rename(f"/meta/s{j}", f"/meta/r{j}"))
        timed_ops("unlink", n_meta // 2, lambda j: fs.unlink(f"/meta/r{2 * j}"))
        left = fs.readdir("/meta")
        meta_read = fs.read_file(f"/meta/r{n_meta - 1}")
        batched = scrape_sum(metas, "cubefs_meta_batched_ops_total") - batched0
        batch_entries = scrape_sum(metas, "cubefs_meta_batch_entries_total") - entries0

        # -- cold tier: one LcNode scan tiers the aged files --------------------
        now = time.time()
        for p in paths[:tier]:
            fs.meta.set_attr(fs.resolve(p), mtime=now - 7200)
        lc = LcNode(fs, engine=fs.tiering)
        lc.set_rules([LifecycleRule("tier", prefix="/cold/", transition_after_s=3600)])
        a0 = a_launches()
        t = time.perf_counter()
        rep = lc.scan_once()
        migrate_s = time.perf_counter() - t
        inodes = [fs.meta.inode_get(fs.resolve(p)) for p in paths[:tier]]
        locs = [json.loads(i["xattr"]["cold.location"]) if i["xattr"].get("cold.location")
                else None for i in inodes]
        cases["migrate"] = {"files": tier, "bytes": tier * file_size, "seconds": migrate_s,
                            "transitioned": rep.transitioned, "errors": rep.errors,
                            "a_launches": a_launches() - a0, "engine": acfg.engine,
                            "cold_only": all(not i["extents"] and loc is not None
                                             and "tiering.state" not in i["xattr"]
                                             for i, loc in zip(inodes, locs))}
        mode = cm.CodeMode(locs[0]["codemode"])
        tac = cm.tactic(mode)
        vols = tiered_volumes(cmgr, locs)
        parity_equal = tiered_parity_equal(vols, locs, tac.n, tac.m)

        def cold_reads(label: str) -> None:
            a0, ms, got = a_launches(), [], []
            for p in paths[:tier]:
                t = time.perf_counter()
                got.append(fs.read_file(p))
                ms.append((time.perf_counter() - t) * 1e3)
            cases[label] = {"files": tier, "ms_runs": ms, "ms": statistics.median(ms),
                            "a_launches": a_launches() - a0,
                            "equal": all(g == w for g, w in zip(got, payloads[:tier]))}
        cold_reads("cold_read")

        # -- one blobnode process stopped: degraded cold reads -------------------
        stopped, blob_victim_exit, lost_data_blobs = stop_a_blobnode(
            c, roles["blobnode"], vols, locs, tac.n, tac.m)
        cold_reads("degraded_cold_read")
        cases["degraded_cold_read"].update({"stopped": stopped,
                                            "blobs_lost_a_data_unit": lost_data_blobs})

        # -- re-heat: one more read crosses the threshold; the scan untiers -----
        fs.read_file(paths[0])
        rep2 = lc.scan_once()
        hot0 = fs.meta.inode_get(fs.resolve(paths[0]))
        reheat = {"untiered": rep2.untiered, "reaped": rep2.reaped,
                  "extents_back": bool(hot0["extents"]),
                  "cold_location_cleared": not hot0["xattr"].get("cold.location"),
                  "equal": fs.read_file(paths[0]) == payloads[0]}
        freelist = fs.meta.blob_freelist_all()
        if freelist:
            lc.scan_once()  # a reap that met the stopped blobnode retries
            freelist = fs.meta.blob_freelist_all()

        # -- one datanode process stopped: every file read again ----------------
        dproc = next(p for p in c.procs if p.role == "datanode")
        dproc.p.terminate()
        data_victim_exit = dproc.p.wait(60)
        reads("failover_read", paths, payloads, writers)
        cases["failover_read"]["stopped"] = dproc.name
        launches = {"gf_apply": a_launches()}
    finally:
        if fs is not None:
            for cl in (*fs.meta._packet_clients.values(), *fs.data._packet_clients.values()):
                cl.close()
        codes = c.down()
        shutil.rmtree(workdir, ignore_errors=True)
        qos.DEFAULT._tracker, qos.DEFAULT._levels, qos.DEFAULT._last_refresh = gate
        for k, v in saved_env.items():
            if v is not None:
                os.environ[k] = v

    k = cases
    checks = {
        # a frame per CUBEFS_PKT_CHUNK of payload, at least: chunk trains
        "write_chunk_trains": k["write"]["client_frames"]["tx"]
        >= files * file_size // packet.chunk_size(),
        "read.equal": k["read"]["equal"],
        "read_native_plane": k["read"]["native_read_ops"] > 0,
        "meta_readdir_all": k["meta_readdir"]["entries"] == n_meta,
        "meta_stat_sizes": all(sz == meta_size for sz in sizes),
        "meta_left_half": sorted(left) == sorted(f"r{2 * j + 1}" for j in range(n_meta // 2)),
        "meta_read_back": meta_read == small[(n_meta - 1) % meta_threads],
        "group_commit_engaged": batched > 0,
        "tier_codemode_ec12p4": mode == cm.CodeMode.EC12P4,
        "migrated_all": k["migrate"]["transitioned"] == tier and not k["migrate"]["errors"],
        "cold_location_only": k["migrate"]["cold_only"],
        "tier_launched_a_per_file": k["migrate"]["a_launches"] >= tier,
        "parity_equals_plain": bool(parity_equal) and all(parity_equal),
        "cold_read.equal": k["cold_read"]["equal"],
        "degraded_cold_read.equal": k["degraded_cold_read"]["equal"],
        "degraded_launched_a_per_lost_blob": lost_data_blobs > 0
        and k["degraded_cold_read"]["a_launches"] >= lost_data_blobs,
        "reheat_untiers_one": reheat["untiered"] == 1 and reheat["extents_back"]
        and reheat["cold_location_cleared"] and reheat["equal"],
        "freelist_empty_after_reap": freelist == {},
        "failover_read.equal": k["failover_read"]["equal"],
        "every_role_exited_0": blob_victim_exit == 0 and data_victim_exit == 0
        and all(rc == 0 for rc in codes.values()),
    }
    return {"phase": "fs", "card": card, "seconds": time.perf_counter() - t_phase,
            "native_build_s": native_build_s, "startup_s": startup_s,
            "election_s": election_s,
            "cluster": {"roles": {r: len(a) for r, a in roles.items()}, "replicas": 3,
                        "mp_count": 3, "dp_count": 4, "files": files, "file_size": file_size,
                        "writers": writers, "meta_threads": meta_threads,
                        "meta_files": n_meta, "meta_size": meta_size, "tiered": tier,
                        "blob_size": blob_size, "codemode": mode.name,
                        "blob_shard": -(-blob_size // tac.n)},
            "cases": cases, "group_commit": {"batched_ops": batched,
                                             "batch_entries": batch_entries},
            "reheat": reheat, "parity_blobs": len(parity_equal),
            "exit_codes": {**codes}, "launches": launches, "checks": checks}


def s3_phase(dev, card: str, *, objects: int = S3_OBJECTS, obj_size: int = S3_OBJECT,
             writers: int = S3_WRITERS, multipart: int = S3_MULTIPART, part: int = S3_PART,
             small_threads: int = S3_SMALL_THREADS, small: int = S3_SMALL,
             small_size: int = S3_SMALL_SIZE, page: int = S3_PAGE, tier: int = S3_TIER,
             blob_size: int = BLOB, device: str | None = None) -> dict:
    """Phase ``s3``: the S3 gateway as its users start it. The launcher
    starts what phase ``fs`` starts (a master, 3 metanodes, 4 datanodes at
    replicas 3, the volume ``vol1`` of 3 meta and 4 data partitions, a
    clustermgr and 6 blobnodes x 3 disks) and the ``objectnode`` role,
    which serves ``vol1`` as bucket ``bkt`` to an owner (``rw``) and a
    stranger with no grant, each a ``python -m cubefs_tpu_torch.cmd``
    process. Every request is SigV4-signed by the port's
    ``s3auth.sign_v4`` over ``http.client`` (one keep-alive connection a
    thread).

    Large objects: ``objects`` of ``obj_size`` bytes PUT from ``writers``
    threads, each read back (bytes and MD5 ETag) and read in three ranges
    (the first MiB, the last, one in the middle). Multipart: one object of
    ``multipart`` bytes in parts of ``part`` bytes from ``writers``
    threads, the completion (which reads every part and writes the body
    again) timed alone; its ETag is the MD5 of the whole object. Small
    objects: ``small_threads`` threads x ``small`` objects of
    ``small_size`` bytes, PUT, HEAD and GET timed per op;
    ListObjectsV2 of them in pages of ``page`` keys, with and without a
    delimiter; DeleteObjects in batches of ``page``, then an empty
    listing. Refusals: anonymous and stranger PUTs and a bad signature
    each answer 403. Cold tier: ``tier`` objects of ``obj_size`` bytes PUT
    under ``cold/`` and a ``Transition`` rule of 1 day PUT on ``cold/``,
    both through the role; the objects aged through a ``FileSystem`` in
    this process with ``CUBEFS_TIERING=1`` whose ``BlobClient``'s
    ``AccessHandler`` runs engine ``cuda`` on ``dev`` (8 MiB blobs);
    ``LcNode.load_rules_from_bucket`` adopts the rule and one scan tiers
    the objects (kernel A encodes each tier PUT stack here); each tiered
    blob's parity, fetched from the blobnodes, must equal the plain
    version. An ``ObjectNode`` in this process over that ``FileSystem``
    with the same users serves cold GETs, timed healthy and with one
    blobnode process stopped (A rebuilds each blob that lost a data
    unit). What the role answers for a tiered object (its
    ``FileSystem`` has no blob client: the object's size in zero bytes,
    a limit shared with the reference) is recorded and checked. Every
    role must exit 0 on SIGTERM. ``device`` is the roles' (None: the
    card). Returns the record with ``checks`` and ``launches`` (this
    process's)."""
    import hashlib
    import xml.etree.ElementTree as ET

    from cubefs_tpu_torch.blob.access import AccessConfig
    from cubefs_tpu_torch.blob.sdk import BlobClient
    from cubefs_tpu_torch.codec import codemode as cm
    from cubefs_tpu_torch.deploy.cluster import Cluster
    from cubefs_tpu_torch.fs import authnode, s3auth
    from cubefs_tpu_torch.fs.client import FileSystem
    from cubefs_tpu_torch.fs.lcnode import LcNode
    from cubefs_tpu_torch.fs.objectnode import ObjectNode
    from cubefs_tpu_torch.ops import _build
    from cubefs_tpu_torch.runtime import fsnative
    from cubefs_tpu_torch.utils import qos, rpc

    class S3:
        """SigV4-signed requests to one gateway, one keep-alive
        ``http.client`` connection per thread."""

        def __init__(self, addr: str):
            self.addr = addr
            self.local = threading.local()

        def req(self, method: str, path: str, body: bytes = b"", query: str = "",
                headers: dict | None = None, cred: dict | None = S3_OWNER,
                bad_signature: bool = False) -> tuple[int, bytes, dict]:
            hdrs = {k.lower(): v for k, v in (headers or {}).items()}
            if cred is not None:
                amz = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
                hdrs.update({"host": self.addr, "x-amz-date": amz,
                             "x-amz-content-sha256": hashlib.sha256(body).hexdigest()})
                auth = s3auth.sign_v4(method, path, query, hdrs, body, cred["access_key"],
                                      cred["secret_key"], amz)
                if bad_signature:
                    auth = auth[:-1] + ("0" if auth[-1] != "0" else "1")
                hdrs["authorization"] = auth
            conn = getattr(self.local, "conn", None)
            if conn is None:
                host, port = self.addr.rsplit(":", 1)
                conn = self.local.conn = http.client.HTTPConnection(host, int(port), timeout=600)
            try:
                conn.request(method, path + (f"?{query}" if query else ""), body=body or None,
                             headers=hdrs)
                resp = conn.getresponse()
                data = resp.read()
            except (http.client.HTTPException, OSError):
                conn.close()
                self.local.conn = None
                raise
            return resp.status, data, {k.lower(): v for k, v in resp.getheaders()}

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 19)
    print(json.dumps({"phase": "s3", "card": card}), flush=True)
    fsnative.load()  # built once for every role
    workdir = tempfile.mkdtemp(prefix="cubefs-smoke-s3-")
    gate = (qos.DEFAULT._tracker, qos.DEFAULT._levels, qos.DEFAULT._last_refresh)
    qos.DEFAULT._tracker, qos.DEFAULT._levels = Quiet(), {}
    qos.DEFAULT._last_refresh = float("-inf")
    saved_env = {v: os.environ.pop(v, None) for v in ("CUBEFS_TIERING", "CUBEFS_UNTIER_HOT")}
    users = [{"access_key": S3_OWNER["access_key"], "secret_key": S3_OWNER["secret_key"],
              "grants": {"vol1": "rw"}},
             {"access_key": S3_STRANGER["access_key"], "secret_key": S3_STRANGER["secret_key"]}]
    topo = {"metanodes": 3, "datanodes": 4, "replicas": 3,
            "volume": {"name": "vol1", "mp_count": 3, "dp_count": 4},
            "blobnodes": BLOB_NODES, "disks_per_blobnode": BLOB_DISKS, "access": False,
            "objectnode": True, "bucket": "bkt", "users": users, "device": device}
    c = Cluster(topo, workdir, timeout=300.0)
    cases: dict[str, dict] = {}
    fs = node = None
    codes: dict = {}

    def a_launches() -> int:
        return _build.LAUNCHES["gf_apply"]

    def timed_ops(kind: str, n: int, nthreads: int, fn, nbytes: int = 0) -> list:
        """``fn(j)`` for j < n from ``nthreads`` threads; returns each
        answer, records the case."""
        got, ms, lock = [None] * n, [], threading.Lock()

        def work(i):
            mine = []
            for j in range(i, n, nthreads):
                t = time.perf_counter()
                got[j] = fn(j)
                mine.append((time.perf_counter() - t) * 1e3)
            with lock:
                ms.extend(mine)
        cases[kind] = op_stats(ms, run_threads(nthreads, work))
        if nbytes:
            cases[kind].update(bytes=nbytes, gib_s=nbytes / cases[kind]["seconds"] / 2**30)
        return got

    def etag(h: dict) -> str:
        return h.get("etag", "").strip('"')

    def xml_texts(body: bytes, tag: str) -> list[str]:
        return [e.text or "" for e in ET.fromstring(body).iter()
                if e.tag.rsplit("}", 1)[-1] == tag]

    def list_v2(s3: S3, prefix: str, delimiter: str | None) -> dict:
        keys, prefixes, pages, token = [], [], 0, None
        t = time.perf_counter()
        while True:
            q = {"list-type": "2", "max-keys": str(page), "prefix": prefix}
            if delimiter:
                q["delimiter"] = delimiter
            if token:
                q["continuation-token"] = token
            st, body, _ = s3.req("GET", "/bkt", query=urllib.parse.urlencode(q))
            if st != 200:
                raise AssertionError(f"phase s3: ListObjectsV2 answered {st}: {body[:300]}")
            pages += 1
            keys += [k for k in xml_texts(body, "Key")]
            prefixes += xml_texts(body, "Prefix")[1:]  # the first is the request's
            if xml_texts(body, "IsTruncated") != ["true"]:
                break
            token = xml_texts(body, "NextContinuationToken")[0]
        return {"keys": len(keys), "distinct": len(set(keys)), "pages": pages,
                "ms": (time.perf_counter() - t) * 1e3, "sorted": keys == sorted(keys)}

    try:
        t = time.perf_counter()
        state = c.up()
        startup_s = time.perf_counter() - t
        roles = state["roles"]
        master, cmgr, gw = roles["master"][0], roles["clustermgr"][0], roles["objectnode"][0]
        s3 = S3(gw)

        # per-partition raft groups elect their leaders first
        t = time.perf_counter()
        deadline = time.perf_counter() + 120
        while s3.req("PUT", "/bkt/warmup", b"w")[0] != 200:
            if time.perf_counter() > deadline:
                raise AssertionError("phase s3: the first PUT never succeeded")
            time.sleep(0.2)
        election_s = time.perf_counter() - t

        # -- large objects: 4 writers ---------------------------------------------
        big = [rng.integers(0, 256, obj_size, dtype=np.uint8).tobytes() for _ in range(objects)]
        md5 = [hashlib.md5(b).hexdigest() for b in big]
        puts = timed_ops("put_large", objects, writers,
                         lambda j: s3.req("PUT", f"/bkt/big/o{j:02d}", big[j]),
                         nbytes=objects * obj_size)
        gets = timed_ops("get_large", objects, writers,
                         lambda j: s3.req("GET", f"/bkt/big/o{j:02d}"), nbytes=objects * obj_size)
        cases["put_large"]["etag_md5"] = all(st == 200 and etag(h) == md5[j]
                                             for j, (st, _, h) in enumerate(puts))
        cases["get_large"]["equal"] = all(st == 200 and b == big[j] and etag(h) == md5[j]
                                          for j, (st, b, h) in enumerate(gets))
        del gets
        spans = [(0, MIB), (obj_size - MIB, MIB), (obj_size // 2 - MIB // 2, MIB)]
        rgot = timed_ops("get_range", 3 * objects, writers, lambda j: s3.req(
            "GET", f"/bkt/big/o{j // 3:02d}",
            headers={"range": f"bytes={spans[j % 3][0]}-{sum(spans[j % 3]) - 1}"}))
        cases["get_range"]["equal"] = all(
            st == 206 and b == big[j // 3][spans[j % 3][0]:sum(spans[j % 3])]
            for j, (st, b, _) in enumerate(rgot))
        del rgot

        # -- multipart: 32 parts of 8 MiB from 4 threads -------------------------------
        whole = rng.integers(0, 256, multipart, dtype=np.uint8).tobytes()
        n_parts = -(-multipart // part)
        st, body, _ = s3.req("POST", "/bkt/multi/whole.bin", query="uploads")
        upload = xml_texts(body, "UploadId")[0]
        part_etags = timed_ops("multipart_parts", n_parts, writers, lambda j: s3.req(
            "PUT", "/bkt/multi/whole.bin", whole[j * part:(j + 1) * part],
            query=f"partNumber={j + 1}&uploadId={upload}"), nbytes=multipart)
        doc = "".join(f"<Part><PartNumber>{j + 1}</PartNumber><ETag>{h['etag']}</ETag></Part>"
                      for j, (_, _, h) in enumerate(part_etags))
        t = time.perf_counter()
        st_c, body_c, _ = s3.req("POST", "/bkt/multi/whole.bin", query=f"uploadId={upload}",
                                 body=f"<CompleteMultipartUpload>{doc}"
                                      f"</CompleteMultipartUpload>".encode())
        complete_s = time.perf_counter() - t
        t = time.perf_counter()
        st_g, got, h = s3.req("GET", "/bkt/multi/whole.bin")
        get_s = time.perf_counter() - t
        cases["multipart"] = {
            "bytes": multipart, "parts": n_parts, "part": part,
            "parts_ok": all(st == 200 for st, _, _ in part_etags),
            "complete_s": complete_s, "complete_gib_s": multipart / complete_s / 2**30,
            "get_s": get_s, "get_gib_s": multipart / get_s / 2**30,
            "etag_md5_whole": st_c == 200 and etag(h) == hashlib.md5(whole).hexdigest()
            and xml_texts(body_c, "ETag")[0].strip('"') == etag(h),
            "equal": st_g == 200 and got == whole}
        del whole, got, part_etags

        # -- small objects: 8 threads x 128 of 4 KiB ----------------------------------
        n_small = small_threads * small
        bodies = [rng.integers(0, 256, small_size, dtype=np.uint8).tobytes()
                  for _ in range(small_threads)]
        key = lambda j: f"/bkt/small/o{j:05d}"  # noqa: E731
        put = timed_ops("put_small", n_small, small_threads,
                        lambda j: s3.req("PUT", key(j), bodies[j % small_threads]))
        head = timed_ops("head_small", n_small, small_threads, lambda j: s3.req("HEAD", key(j)))
        got = timed_ops("get_small", n_small, small_threads, lambda j: s3.req("GET", key(j)))
        for label, replies in (("put_small", put), ("head_small", head), ("get_small", got)):
            # every status, and the first refusals' bodies (S3 error documents)
            cases[label]["statuses"] = dict(collections.Counter(str(r[0]) for r in replies))
            cases[label]["refusals"] = [(key(j), st, bytes(b[:300]).decode("latin-1"))
                                        for j, (st, b, _) in enumerate(replies)
                                        if st != 200][:4]
        cases["put_small"]["all_200"] = all(st == 200 for st, _, _ in put)
        cases["head_small"]["sizes"] = all(st == 200 and h.get("content-length") == str(small_size)
                                           for st, _, h in head)
        cases["get_small"]["equal"] = all(st == 200 and b == bodies[j % small_threads]
                                          for j, (st, b, _) in enumerate(got))
        del put, head, got
        cases["list_v2"] = list_v2(s3, "small/", None)
        cases["list_v2_delimiter"] = list_v2(s3, "small/", "/")
        deleted, t = 0, time.perf_counter()
        for lo in range(0, n_small, page):
            doc = "".join(f"<Object><Key>{key(j)[5:]}</Key></Object>"
                          for j in range(lo, min(n_small, lo + page)))
            st, body, _ = s3.req("POST", "/bkt", query="delete",
                                 body=f"<Delete>{doc}</Delete>".encode())
            deleted += body.count(b"<Deleted>") if st == 200 else 0
        cases["delete_objects"] = {"keys": n_small, "deleted": deleted, "batch": page,
                                   "seconds": time.perf_counter() - t}
        cases["list_after_delete"] = list_v2(s3, "small/", None)

        # -- refusals ---------------------------------------------------------------
        refusals = {
            "anonymous_put": s3.req("PUT", "/bkt/refused", b"x", cred=None)[0],
            "stranger_put": s3.req("PUT", "/bkt/refused", b"x", cred=S3_STRANGER)[0],
            "bad_signature": s3.req("PUT", "/bkt/refused", b"x", bad_signature=True)[0],
            "refused_key_absent": s3.req("GET", "/bkt/refused")[0],
        }

        # -- cold tier: the bucket's own lifecycle rule ----------------------------
        cold = [rng.integers(0, 256, obj_size, dtype=np.uint8).tobytes() for _ in range(tier)]
        cold_keys = [f"cold/c{i}" for i in range(tier)]
        for k, b in zip(cold_keys, cold):
            if s3.req("PUT", f"/bkt/{k}", b)[0] != 200:
                raise AssertionError(f"phase s3: PUT {k} refused")
        rule = (b"<LifecycleConfiguration><Rule><ID>cold-after-a-day</ID><Filter><Prefix>cold/"
                b"</Prefix></Filter><Status>Enabled</Status><Transition><Days>1</Days>"
                b"<StorageClass>EC_COLD</StorageClass></Transition></Rule>"
                b"</LifecycleConfiguration>")
        lifecycle_put = s3.req("PUT", "/bkt", rule, query="lifecycle")[0]
        view = rpc.call(master, "client_view", {"name": state["volume"]})[0]["volume"]
        pool = rpc.NodePool()
        acfg = AccessConfig(blob_size=blob_size, engine="cuda", device=dev)
        os.environ["CUBEFS_TIERING"] = "1"
        try:
            fs = FileSystem(view, pool, blob_client=BlobClient(cmgr, pool, acfg))
        finally:
            os.environ.pop("CUBEFS_TIERING", None)
        now = time.time()
        for k in cold_keys:
            fs.meta.set_attr(fs.resolve(f"/{k}"), mtime=now - 2 * 86400)
        lc = LcNode(fs, engine=fs.tiering)
        rules = lc.load_rules_from_bucket()
        _build.reset_launches()
        t = time.perf_counter()
        rep = lc.scan_once()
        migrate_s = time.perf_counter() - t
        inodes = [fs.meta.inode_get(fs.resolve(f"/{k}")) for k in cold_keys]
        locs = [json.loads(i["xattr"]["cold.location"]) if i["xattr"].get("cold.location")
                else None for i in inodes]
        cases["migrate"] = {"objects": tier, "bytes": tier * obj_size, "seconds": migrate_s,
                            "rules": rules, "transitioned": rep.transitioned,
                            "errors": [list(e) for e in rep.errors],
                            "a_launches": a_launches(), "engine": acfg.engine,
                            "cold_only": all(not i["extents"] and loc is not None
                                             for i, loc in zip(inodes, locs))}
        mode = cm.CodeMode(locs[0]["codemode"])
        tac = cm.tactic(mode)
        vols = tiered_volumes(cmgr, locs)
        parity_equal = tiered_parity_equal(vols, locs, tac.n, tac.m)

        store = authnode.UserStore()
        for u in users:
            store.users[u["access_key"]] = {"user_id": u["access_key"], "sk": u["secret_key"],
                                            "volumes": dict(u.get("grants", {}))}
        node = ObjectNode({"bkt": fs}, authenticator=s3auth.S3V4Authenticator(
            store, {"bkt": state["volume"]})).start()
        local = S3(node.addr)

        def cold_gets(label: str) -> None:
            a0, ms, ok = a_launches(), [], []
            for k, want in zip(cold_keys, cold):
                t = time.perf_counter()
                st, b, _ = local.req("GET", f"/bkt/{k}")
                ms.append((time.perf_counter() - t) * 1e3)
                ok.append(st == 200 and b == want)
            cases[label] = {"objects": tier, "ms_runs": ms, "ms": statistics.median(ms),
                            "a_launches": a_launches() - a0, "equal": all(ok)}
        cold_gets("cold_get")

        # -- one blobnode process stopped: degraded cold GETs ----------------------
        stopped, blob_victim_exit, lost_data_blobs = stop_a_blobnode(
            c, roles["blobnode"], vols, locs, tac.n, tac.m)
        cold_gets("degraded_cold_get")
        cases["degraded_cold_get"].update({"stopped": stopped,
                                           "blobs_lost_a_data_unit": lost_data_blobs})

        # -- the role's answer for a tiered object: the shared limit -------------------
        st, b, h = s3.req("GET", f"/bkt/{cold_keys[0]}")
        role_tiered = {"status": st, "bytes": len(b), "zeros": b == bytes(obj_size),
                       "content_length": h.get("content-length")}
        launches = {"gf_apply": a_launches()}
    finally:
        if node is not None:
            node.stop()
        if fs is not None:
            for cl in (*fs.meta._packet_clients.values(), *fs.data._packet_clients.values()):
                cl.close()
        codes = c.down()
        shutil.rmtree(workdir, ignore_errors=True)
        qos.DEFAULT._tracker, qos.DEFAULT._levels, qos.DEFAULT._last_refresh = gate
        for k, v in saved_env.items():
            if v is not None:
                os.environ[k] = v

    k = cases
    checks = {
        "put_large_etag_md5": k["put_large"]["etag_md5"],
        "get_large.equal": k["get_large"]["equal"],
        "get_range.equal": k["get_range"]["equal"],
        "multipart_parts_ok": k["multipart"]["parts_ok"],
        "multipart_etag_md5_whole": k["multipart"]["etag_md5_whole"],
        "multipart.equal": k["multipart"]["equal"],
        "put_small_all_200": k["put_small"]["all_200"],
        "head_small_sizes": k["head_small"]["sizes"],
        "get_small.equal": k["get_small"]["equal"],
        "list_v2_all": k["list_v2"]["keys"] == k["list_v2"]["distinct"] == n_small
        and k["list_v2"]["pages"] == -(-n_small // page) and k["list_v2"]["sorted"],
        "list_v2_delimiter_all": k["list_v2_delimiter"]["keys"] == n_small
        and k["list_v2_delimiter"]["pages"] == -(-n_small // page),
        "delete_objects_all": k["delete_objects"]["deleted"] == n_small,
        "list_after_delete_empty": k["list_after_delete"]["keys"] == 0,
        "refusals_403": all(refusals[r] == 403 for r in ("anonymous_put", "stranger_put",
                                                          "bad_signature"))
        and refusals["refused_key_absent"] == 404,
        "lifecycle_put_200": lifecycle_put == 200,
        "lcnode_adopted_the_rule": k["migrate"]["rules"] == 1,
        "tier_codemode_ec12p4": mode == cm.CodeMode.EC12P4,
        "migrated_all": k["migrate"]["transitioned"] == tier and not k["migrate"]["errors"],
        "cold_location_only": k["migrate"]["cold_only"],
        "tier_launched_a_per_object": k["migrate"]["a_launches"] >= tier,
        "parity_equals_plain": bool(parity_equal) and all(parity_equal),
        "cold_get.equal": k["cold_get"]["equal"],
        "cold_get_launched_no_a": k["cold_get"]["a_launches"] == 0,
        "degraded_cold_get.equal": k["degraded_cold_get"]["equal"],
        "degraded_launched_a_per_lost_blob": lost_data_blobs > 0
        and k["degraded_cold_get"]["a_launches"] >= lost_data_blobs,
        "role_tiered_get_is_the_shared_limit": role_tiered["status"] == 200
        and role_tiered["zeros"],
        "every_role_exited_0": blob_victim_exit == 0 and all(rc == 0 for rc in codes.values()),
    }
    return {"phase": "s3", "card": card, "seconds": time.perf_counter() - t_phase,
            "startup_s": startup_s, "election_s": election_s,
            "cluster": {"roles": {r: len(a) for r, a in roles.items()}, "replicas": 3,
                        "mp_count": 3, "dp_count": 4, "objects": objects, "obj_size": obj_size,
                        "writers": writers, "multipart": multipart, "part": part,
                        "small_threads": small_threads, "small": n_small,
                        "small_size": small_size, "page": page, "tiered": tier,
                        "blob_size": blob_size, "codemode": mode.name,
                        "blob_shard": -(-blob_size // tac.n)},
            "cases": cases, "refusals": refusals, "role_tiered_get": role_tiered,
            "parity_blobs": len(parity_equal), "exit_codes": {**codes},
            "launches": launches, "checks": checks}


def fs_doors_phase(dev, card: str, *, files: int = DOORS_FILES, file_size: int = DOORS_FILE,
                   writers: int = DOORS_WRITERS, tier: int = DOORS_TIER,
                   racers: int = DOORS_RACERS, race_files: int = DOORS_RACE_FILES,
                   race_size: int = DOORS_RACE_SIZE, flash_node: int | None = None,
                   flash_small: int = FLASH_SMALL_FILES, flash_big: int = FLASH_BIG_FILES,
                   geo_records: int = GEO_RECORDS,
                   blob_size: int = BLOB, device: str | None = None) -> dict:
    """Phase ``fs_doors``: the file-system plane's three doors. Phase
    ``fs``'s cluster (a master, 3 metanodes, 4 datanodes at replicas 3,
    ``vol1`` of 3 meta and 4 data partitions, a clustermgr and 6
    blobnodes x 3 disks, started by the launcher) with a
    ``flashgroupmanager`` and two flash groups, ``az-a`` and ``az-b``, of
    2 ``flashnode`` processes each (``flash_node`` bytes, None: the
    role's default of 256 MiB), every one a ``python -m
    cubefs_tpu_torch.cmd`` process; the master runs with
    ``CUBEFS_META_SPLIT=1``. The client runs in this process with
    ``CUBEFS_TIERING=1``; its ``BlobClient``'s ``AccessHandler`` runs
    engine ``cuda`` on ``dev`` (8 MiB blobs, EC12P4), so kernel A
    launches here.

    Case ``split``: ``files`` files of ``file_size`` bytes from
    ``writers`` threads, the last ``tier`` of them written last (their
    inodes in the used upper half of the root's partition) and tiered by
    one ``LcNode`` scan (A encodes the tier PUT stacks). The operator
    reads the partition's fill and pins the midpoint of its used range;
    ``racers`` threads then create and write files of ``race_size``
    bytes in a directory of that partition (at most ``race_files``
    each), and ``meta_split`` moves the upper half while they run. Then
    ``meta_merge`` moves it back, and ``meta_balance`` (``auto``, the
    door open) runs one action. Every racing create must land exactly
    once; every replica of every partition give the same ``mp_digest``;
    ``mp_version`` bump once per commit; every hot file read back
    equal; each tiered file keep its ``cold.location`` and read back
    equal through the blob plane, healthy and with one blobnode process
    stopped (A rebuilds each blob that lost a data unit).

    Case ``flash``: a client in ``az-a`` with ``CUBEFS_READ_CACHE=1``
    (``CUBEFS_READ_HOT`` at its default of 2: a block is cached on its
    second miss) reads a working set of ``flash_small`` files, half the
    local group's capacity at most, three times: the third pass must be
    all hits. Then ``flash_big`` files, twice that bound, twice: a fill
    lands on the first live member of the elected group, so that member
    holds twice its capacity's worth and evicts. It is killed mid-read:
    the reads stay exact, its breaker opens, and misses fall back to the
    datanodes and refill the group's other member. A file
    cached in both AZs is overwritten: no live flashnode of either AZ
    serves a key of its old extents afterwards, and both AZs' clients
    read the new bytes.

    Case ``geo``: two regions in this process (``CUBEFS_GEO=1``), each
    a standalone partition behind a ``GeoGateway``, as
    ``tests/test_georepl.py`` builds them: ``geo_records`` inode records
    shipped; a third, empty follower bootstrapped from a snapshot over
    the packet mux (a multi-MB image in chunk trains); fence, promote,
    demote (the old primary bootstrapped from the new), failback (drain,
    fence both, promote, demote); equal digests on both sides and a
    follower mutation refused with 452. ``device`` is the roles' (None:
    the card). Returns the record with ``checks`` and ``launches`` (this
    process's)."""
    from types import SimpleNamespace

    from cubefs_tpu_torch.blob.access import AccessConfig
    from cubefs_tpu_torch.blob.sdk import BlobClient
    from cubefs_tpu_torch.codec import codemode as cm
    from cubefs_tpu_torch.deploy.cluster import Cluster, Proc
    from cubefs_tpu_torch.fs import georepl as fsgeo
    from cubefs_tpu_torch.fs.client import FileSystem, FsError
    from cubefs_tpu_torch.fs.lcnode import LcNode, LifecycleRule
    from cubefs_tpu_torch.fs.metanode import FILE, MetaPartition
    from cubefs_tpu_torch.fs.remotecache import CachedReader, FlashGroupManager
    from cubefs_tpu_torch.ops import _build
    from cubefs_tpu_torch.runtime import fsnative
    from cubefs_tpu_torch.utils import georepl as geo
    from cubefs_tpu_torch.utils import metrics, packet, qos, rpc

    class RoleRing(FlashGroupManager):
        """The ``flashgroupmanager`` role's ring as a client holds it: the
        reference's AZ-local election over the role's ``ring`` reply (live
        members only), read again at most once a second."""

        def __init__(self, addr: str):
            super().__init__()
            self.addr, self._at, self._ring = addr, float("-inf"), {}

        def ring_info(self) -> dict:
            if time.monotonic() - self._at > 1.0:
                st, meta, _ = rpc_post(self.addr, "ring", {})
                if st != 200:
                    raise AssertionError(f"ring answered {st} {meta}")
                self._ring = {int(g): {"addrs": a, "az": meta["azs"][g]}
                              for g, a in meta["groups"].items()}
                self._at = time.monotonic()
            return self._ring

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 23)
    print(json.dumps({"phase": "fs_doors", "card": card}), flush=True)
    fsnative.load()
    workdir = tempfile.mkdtemp(prefix="cubefs-smoke-doors-")
    gate = (qos.DEFAULT._tracker, qos.DEFAULT._levels, qos.DEFAULT._last_refresh)
    qos.DEFAULT._tracker, qos.DEFAULT._levels = Quiet(), {}
    qos.DEFAULT._last_refresh = float("-inf")
    doors = ("CUBEFS_TIERING", "CUBEFS_UNTIER_HOT", "CUBEFS_META_SPLIT", "CUBEFS_READ_CACHE",
             "CUBEFS_READ_HOT", "CUBEFS_GEO")
    saved_env = {v: os.environ.pop(v, None) for v in doors}
    cases: dict[str, dict] = {}
    checks: dict[str, bool] = {}
    topo = {"metanodes": 3, "datanodes": 4, "replicas": 3,
            "volume": {"name": "vol1", "mp_count": 3, "dp_count": 4},
            "blobnodes": BLOB_NODES, "disks_per_blobnode": BLOB_DISKS, "access": False,
            "device": device}
    c = Cluster(topo, workdir, timeout=300.0)
    clients: list = []
    geo_gws: list = []
    codes: dict = {}
    killed: set = set()

    def a_launches() -> int:
        return _build.LAUNCHES["gf_apply"]

    def wait_for(cond, what: str, timeout: float = 120.0):
        deadline = time.perf_counter() + timeout
        while True:
            try:
                got = cond()
                if got:
                    return got
            except Exception as e:  # an election in progress
                err = e
            else:
                err = None
            if time.perf_counter() > deadline:
                raise AssertionError(f"phase fs_doors: timed out waiting for {what}: {err}")
            time.sleep(0.1)

    def call(addr: str, method: str, args: dict) -> dict:
        st, meta, _ = rpc_post(addr, method, args)
        if st != 200:
            raise AssertionError(f"{method} answered {st} {meta}")
        return meta

    def read_all(fs, paths: list, want: list, threads: int) -> dict:
        got = [None] * len(paths)

        def one(i):
            for j in range(i, len(paths), threads):
                got[j] = fs.read_file(paths[j])
        secs = run_threads(threads, one)
        nbytes = sum(len(w) for w in want)
        return {"files": len(paths), "bytes": nbytes, "seconds": secs,
                "gib_s": nbytes / secs / 2**30,
                "equal": all(g == w for g, w in zip(got, want))}

    try:
        os.environ["CUBEFS_META_SPLIT"] = "1"  # the master's automatic sweep door
        t = time.perf_counter()
        try:
            state = c.up()
            fgm_proc = Proc("flashgroupmanager", {
                "role": "flashgroupmanager", "name": "flashgroupmanager", "listen_port": 0,
                "data_dir": os.path.join(workdir, "fgm")}, workdir)
            c.procs.append(fgm_proc)
            fgm = fgm_proc.wait_addr(300.0)
            flash_procs = {}
            for az in ("az-a", "az-b"):
                for i in range(2):
                    cfg = {"role": "flashnode", "name": f"flashnode-{az}{i}", "listen_port": 0,
                           "fgm_addr": fgm}
                    if flash_node is not None:
                        cfg["capacity_bytes"] = flash_node
                    flash_procs[(az, i)] = Proc("flashnode", cfg, workdir)
            c.procs.extend(flash_procs.values())
            flash = {k: p.wait_addr(300.0) for k, p in flash_procs.items()}
        finally:
            os.environ.pop("CUBEFS_META_SPLIT", None)
        startup_s = time.perf_counter() - t
        for gid, az in ((1, "az-a"), (2, "az-b")):
            call(fgm, "register_group", {"group_id": gid, "az": az,
                                         "addrs": [flash[(az, 0)], flash[(az, 1)]]})
        roles = state["roles"]
        master, cmgr = roles["master"][0], roles["clustermgr"][0]
        vol = state["volume"]

        def view() -> dict:
            return call(master, "client_view", {"name": vol})["volume"]

        pool = rpc.NodePool()
        acfg = AccessConfig(blob_size=blob_size, engine="cuda", device=dev)
        blob = BlobClient(cmgr, pool, acfg)
        os.environ["CUBEFS_TIERING"] = "1"
        try:
            fs = FileSystem(view(), pool, blob_client=blob, master_addr=master)
        finally:
            os.environ.pop("CUBEFS_TIERING", None)
        clients.append(fs)
        for d in ("/data", "/cold", "/split", "/flash"):
            wait_for(lambda d=d: fs.mkdir(d), f"mkdir {d}")

        # == case split: tiered files held across a live split =================
        _build.reset_launches()
        t_case = time.perf_counter()
        hot = [f"/data/f{i}" for i in range(files - tier)]
        cold = [f"/cold/c{i}" for i in range(tier)]
        payload = {p: rng.integers(0, 256, file_size, dtype=np.uint8).tobytes()
                   for p in hot + cold}

        def write(paths: list):
            def one(i):
                for j in range(i, len(paths), writers):
                    fs.write_file(paths[j], payload[paths[j]])
            return run_threads(writers, one)
        secs = write(hot) + write(cold)  # the tiered inodes are the last allocated
        cases["split_write"] = {"files": files, "bytes": files * file_size, "seconds": secs,
                                "gib_s": files * file_size / secs / 2**30}
        now = time.time()
        for p in cold:
            fs.meta.set_attr(fs.resolve(p), mtime=now - 7200)
        lc = LcNode(fs, engine=fs.tiering)
        lc.set_rules([LifecycleRule("tier", prefix="/cold/", transition_after_s=3600)])
        a0, t = a_launches(), time.perf_counter()
        rep = lc.scan_once()
        inodes = {p: fs.meta.inode_get(fs.resolve(p)) for p in cold}
        locations = {p: i["xattr"].get("cold.location") for p, i in inodes.items()}
        cases["split_tier"] = {"files": tier, "bytes": tier * file_size,
                               "seconds": time.perf_counter() - t,
                               "transitioned": rep.transitioned, "errors": rep.errors,
                               "a_launches": a_launches() - a0}
        locs = [json.loads(v) for v in locations.values() if v]
        mode = cm.CodeMode(locs[0]["codemode"]) if locs else None
        checks["split_tiered_all"] = (rep.transitioned == tier and not rep.errors
                                      and len(locs) == tier
                                      and all(not i["extents"] for i in inodes.values()))
        checks["split_tier_launched_a_per_file"] = cases["split_tier"]["a_launches"] >= tier

        # the operator's plan: the root partition, split at the midpoint of
        # its used range (read before the racers start)
        v0 = view()
        donor = next(m for m in v0["mps"] if m["start"] <= 1 < m["end"])
        fill = rpc.call_replicas(pool, donor.get("addrs") or [donor["addr"]], "mp_fill",
                                 {"pid": donor["pid"]})[0]
        split_ino = donor["start"] + (min(fill["next_ino"], donor["end"]) - donor["start"]) // 2
        tiered_inos = [i["ino"] for i in inodes.values()]
        checks["split_moves_the_tiered_inodes"] = all(i >= split_ino for i in tiered_inos)

        done: list = []
        errors: list = []
        retries = [0]
        stop = threading.Event()
        small = rng.integers(0, 256, race_size, dtype=np.uint8).tobytes()
        lock = threading.Lock()

        def racer(i):
            k = 0
            while not stop.is_set() and k < race_files:
                name = f"t{i}-{k}"
                try:
                    fs.write_file(f"/split/{name}", small)
                except FsError as e:
                    if e.errno == 28:  # alloc range migrating: the SDK retries
                        with lock:
                            retries[0] += 1
                        time.sleep(0.01)
                        continue
                    with lock:
                        errors.append((name, e.errno, str(e)))
                    return
                with lock:
                    done.append(name)
                k += 1

        ex = ThreadPoolExecutor(racers)
        futs = [ex.submit(racer, i) for i in range(racers)]
        t = time.perf_counter()
        try:
            st, res, _ = rpc_post(master, "meta_split", {"name": vol, "pid": donor["pid"],
                                                          "split_ino": split_ino})
        finally:
            split_s = time.perf_counter() - t
            stop.set()
            for f in futs:
                f.result()
            ex.shutdown()
        if st != 200:
            raise AssertionError(f"meta_split answered {st} {res}")
        v1 = view()
        names = fs.readdir("/split")
        race_paths = [f"/split/{n}" for n in sorted(done)]
        race_back = read_all(fs, race_paths, [small] * len(race_paths), 8)
        cases["split"] = {"seconds": split_s, "split_ino": split_ino,
                          "donor_pid": donor["pid"], "target_pid": res["target_pid"],
                          "copied_inodes": res["copied_inodes"],
                          "delta_applied": res["delta_applied"],
                          "delta_failed": res["delta_failed"],
                          "racing_creates": len(done), "racing_retries": retries[0],
                          "racing_errors": errors[:8],
                          "racing_creates_s": len(done) / split_s,
                          "mp_version": [v0.get("mp_version", 0), v1.get("mp_version", 0)],
                          "mps": len(v1["mps"])}
        checks["split_racing_creates_exactly_once"] = (
            not errors and len(done) > 0 and sorted(names) == sorted(done)
            and len(names) == len(set(names)) and race_back["equal"])
        checks["split_copied_the_upper_half"] = res["copied_inodes"] > 0 and res["split_ino"] == split_ino

        def digests() -> dict:
            """{pid: [each replica's mp_digest]} once every replica agrees."""
            def agree():
                out = {}
                for m in view()["mps"]:
                    out[m["pid"]] = [call(a, "mp_digest", {"pid": m["pid"]})["digest"]
                                     for a in m.get("addrs") or [m["addr"]]]
                return out if all(len(set(d)) == 1 for d in out.values()) else None
            return wait_for(agree, "every replica's digest to agree", 60.0)

        def cold_ok() -> bool:
            now_locs = {p: fs.meta.inode_get(fs.resolve(p))["xattr"].get("cold.location")
                        for p in cold}
            return now_locs == locations

        digest_split = digests()
        checks["split_replicas_equal"] = bool(digest_split)
        checks["split_cold_location_kept"] = cold_ok()
        checks["split_mp_version_once"] = v1["mp_version"] == v0.get("mp_version", 0) + 1

        t = time.perf_counter()
        st, mres, _ = rpc_post(master, "meta_merge", {"name": vol,
                                                      "donor_pid": res["target_pid"]})
        if st != 200:
            raise AssertionError(f"meta_merge answered {st} {mres}")
        merge_s = time.perf_counter() - t
        # a table that still names the merged-away partition answers 404
        # for its inodes in both packages: the client re-reads its view
        fs.meta.refresh_view(force=True)
        v2 = view()
        digest_merge = digests()
        checks["merge_mp_version_once"] = v2["mp_version"] == v1["mp_version"] + 1
        checks["merge_restores_the_table"] = sorted(
            (m["pid"], m["start"], m["end"]) for m in v2["mps"]) == sorted(
            (m["pid"], m["start"], m["end"]) for m in v0["mps"])
        checks["merge_cold_location_kept"] = cold_ok()

        t = time.perf_counter()
        bal = call(master, "meta_balance", {"max_moves": 1, "auto": True})
        balance_s = time.perf_counter() - t
        fs.meta.refresh_view(force=True)
        v3 = view()
        digest_balance = digests()
        status = call(master, "meta_status", {"name": vol})
        checks["balance_ran_behind_the_door"] = (
            "skipped" not in bal and status["door"] and not bal["failed"]
            and not status["in_flight"])
        checks["balance_mp_version_per_action"] = (
            v3["mp_version"] == v2["mp_version"] + len(bal["actions"]))
        checks["balance_cold_location_kept"] = cold_ok()
        cases["merge"] = {"seconds": merge_s, "copied_inodes": mres["copied_inodes"],
                          "delta_applied": mres["delta_applied"],
                          "mp_version": v2["mp_version"], "mps": len(v2["mps"])}
        cases["balance"] = {"seconds": balance_s,
                            "actions": [(a["kind"], a["pid"]) for a in bal["actions"]],
                            "imbalance": bal["imbalance"], "mp_version": v3["mp_version"],
                            "mps": len(v3["mps"])}
        checks["split_namespace_kept"] = sorted(fs.readdir("/split")) == sorted(done)
        cases["split_hot_read"] = read_all(fs, hot, [payload[p] for p in hot], writers)
        checks["split_hot_read.equal"] = cases["split_hot_read"]["equal"]

        def cold_reads(label: str) -> None:
            a0, ms, got = a_launches(), [], []
            for p in cold:
                t = time.perf_counter()
                got.append(fs.read_file(p))
                ms.append((time.perf_counter() - t) * 1e3)
            cases[label] = {"files": tier, "ms_runs": ms, "ms": statistics.median(ms),
                            "a_launches": a_launches() - a0,
                            "equal": all(g == payload[p] for g, p in zip(got, cold))}
        cold_reads("split_cold_read")
        tac = cm.tactic(mode)
        vols = tiered_volumes(cmgr, locs)
        parity_equal = tiered_parity_equal(vols, locs, tac.n, tac.m)
        stopped, blob_exit, lost = stop_a_blobnode(c, roles["blobnode"], vols, locs,
                                                   tac.n, tac.m)
        killed.add(stopped)
        cold_reads("split_degraded_cold_read")
        cases["split_degraded_cold_read"].update({"stopped": stopped, "exit": blob_exit,
                                                  "blobs_lost_a_data_unit": lost})
        checks.update({
            "split_tier_codemode_ec12p4": mode == cm.CodeMode.EC12P4,
            "split_parity_equals_plain": bool(parity_equal) and all(parity_equal),
            "split_cold_read.equal": cases["split_cold_read"]["equal"],
            "split_degraded_cold_read.equal": cases["split_degraded_cold_read"]["equal"],
            "split_degraded_launched_a_per_lost_blob": lost > 0 and
            cases["split_degraded_cold_read"]["a_launches"] >= lost,
            "split_blobnode_exit_0": blob_exit == 0,
        })
        cases["split_case_seconds"] = time.perf_counter() - t_case
        split_launches = a_launches()

        # == case flash: the AZ-local read tier =================================
        t_case = time.perf_counter()
        ring_a, ring_b = RoleRing(fgm), RoleRing(fgm)
        os.environ["CUBEFS_READ_CACHE"] = "1"
        try:
            fsa = FileSystem(view(), pool, master_addr=master, flash_fgm=ring_a,
                             client_az="az-a")
            fsb = FileSystem(view(), pool, master_addr=master, flash_fgm=ring_b,
                             client_az="az-b")
        finally:
            os.environ.pop("CUBEFS_READ_CACHE", None)
        clients.extend((fsa, fsb))
        rca, rcb = fsa.read_cache, fsb.read_cache
        checks["flash_reader_is_the_door"] = (isinstance(rca, CachedReader)
                                              and rca.hotness_threshold == 2)
        node_cap = call(flash[("az-a", 0)], "stats", {})["capacity"]

        def fills() -> dict:
            return {o: metrics.readcache_fills.value(outcome=o)
                    for o in ("populated", "skipped_cold", "failed", "suppressed")}

        def flash_pass(label: str, fsx, paths: list, threads: int = 4) -> dict:
            rc = fsx.read_cache
            h0, m0, f0 = rc.hits, rc.misses, fills()
            s0 = {s: metrics.readcache_serves.value(scope=s) for s in ("az_local", "cross_az")}
            rec = read_all(fsx, paths, [payload[p] for p in paths], threads)
            f1 = fills()
            rec.update({"hits": rc.hits - h0, "misses": rc.misses - m0,
                        "fills": {k: f1[k] - f0[k] for k in f1},
                        "serves": {s: metrics.readcache_serves.value(scope=s) - s0[s]
                                   for s in s0}})
            cases[label] = rec
            return rec

        small_set = hot[:flash_small]
        group_cap = 2 * node_cap
        checks["flash_small_set_fits_half_the_group"] = (
            len(small_set) * file_size <= group_cap // 2)
        for n in (1, 2, 3):
            flash_pass(f"flash_small_pass{n}", fsa, small_set)
        p3 = cases["flash_small_pass3"]
        checks["flash_third_pass_all_hits"] = (p3["equal"] and p3["misses"] == 0
                                               and p3["hits"] > 0)
        checks["flash_first_passes_exact"] = all(
            cases[f"flash_small_pass{n}"]["equal"] for n in (1, 2))
        big_set = hot[flash_small:flash_small + flash_big]
        checks["flash_big_set_twice_the_small_bound"] = (
            len(big_set) * file_size >= group_cap and len(big_set) == flash_big)
        for n in (1, 2):
            flash_pass(f"flash_big_pass{n}", fsa, big_set)
        stats_a = {i: call(flash[("az-a", i)], "stats", {}) for i in (0, 1)}
        populated = cases["flash_big_pass2"]["fills"]["populated"]
        checks["flash_big_evicts"] = (
            cases["flash_big_pass1"]["equal"] and cases["flash_big_pass2"]["equal"]
            and populated * (128 << 10) > node_cap
            and all(s["bytes"] <= s["capacity"] for s in stats_a.values()))
        cases["flash_big_node_stats"] = stats_a

        # the az-a flashnode holding the fills, killed mid-read
        victim = max((0, 1), key=lambda i: stats_a[i]["items"])
        vaddr, vproc = flash[("az-a", victim)], flash_procs[("az-a", victim)]
        resident = big_set[-2:]  # among the last files filled: the LRU kept them
        # a quarter of the way into the pass (128 KiB cache blocks)
        at_kill = rca.hits + rca.misses + max(1, len(resident) * file_size // (128 << 10) // 4)

        def killer():
            deadline = time.perf_counter() + 60
            while rca.hits + rca.misses < at_kill and time.perf_counter() < deadline:
                time.sleep(0.001)
            vproc.p.kill()
        kt = threading.Thread(target=killer)
        kt.start()
        flash_pass("flash_kill_pass", fsa, resident, threads=1)
        kt.join()
        vproc.p.wait(60)
        killed.add(vproc.name)
        flash_pass("flash_after_kill_pass", fsa, resident, threads=1)
        survivor = flash[("az-a", 1 - victim)]
        surv_stats = call(survivor, "stats", {})
        k1, k2 = cases["flash_kill_pass"], cases["flash_after_kill_pass"]
        checks["flash_kill_reads_exact"] = k1["equal"] and k2["equal"]
        checks["flash_kill_breaker_open"] = rca.breaker.state(vaddr) != "closed"
        checks["flash_kill_falls_back_and_refills"] = (
            k1["misses"] > 0 and k1["fills"]["populated"] > 0 and surv_stats["items"] > 0
            and k2["hits"] > 0)
        cases["flash_kill"] = {"killed": vproc.name, "survivor_items": surv_stats["items"]}

        # a file cached in both AZs, overwritten
        target = small_set[0]
        for n in (1, 2):
            flash_pass(f"flash_az_a_pass{n}", fsa, [target], threads=1)
            flash_pass(f"flash_az_b_pass{n}", fsb, [target], threads=1)
        old_keys = CachedReader.keys_for_extents(
            fs.meta.inode_get(fs.resolve(target))["extents"])
        live = [a for k, a in flash.items() if a != vaddr]

        def cached(keys) -> int:
            return sum(rpc_post(a, "cache_get", {"key": k})[0] == 200
                       for a in live for k in keys)
        cached_before = cached(old_keys)
        new = rng.integers(0, 256, file_size, dtype=np.uint8).tobytes()
        inv0 = metrics.readcache_invalidations.value()
        t = time.perf_counter()
        fsa.write_file(target, new)
        overwrite_s = time.perf_counter() - t
        payload[target] = new
        cached_after = cached(old_keys)
        both = {"az-a": fsa.read_file(target) == new, "az-b": fsb.read_file(target) == new}
        cases["flash_overwrite"] = {"seconds": overwrite_s, "old_keys": len(old_keys),
                                    "cached_before": cached_before,
                                    "cached_after": cached_after,
                                    "invalidated": metrics.readcache_invalidations.value() - inv0,
                                    "read_new": both}
        checks["flash_overwrite_invalidates_every_az"] = (
            cached_before > len(old_keys) and cached_after == 0 and all(both.values()))
        cases["flash_case_seconds"] = time.perf_counter() - t_case

        # == case geo: two regions in this process ==============================
        t_case = time.perf_counter()
        os.environ["CUBEFS_GEO"] = "1"
        try:
            gpool = rpc.NodePool()

            def region(name: str, role: str, peer: str | None):
                mp = MetaPartition(1, 100, 10**7)
                gw = fsgeo.GeoGateway(name, gpool, f"geo-{name}", peer_addr=peer, role=role)
                gw.attach_metanode(SimpleNamespace(partitions={1: mp}, rafts={}),
                                   primaries={1: "mn-r1"})
                geo_gws.append(gw)
                return mp, gw

            mp1, gw1 = region("r1", "primary", "geo-r2")
            mp2, gw2 = region("r2", "follower", "geo-r1")

            def mk(mp, ino: int) -> None:
                mp.submit({"op": "mk_inode", "ino": ino, "type": FILE, "mode": 0o644,
                           "target": f"smoke-{ino:08d}", "ts": float(ino),
                           "op_id": f"mk-{ino}"})

            def drain(gw) -> int:
                n = 0
                while gw._parts["mp:1"].shipper.pending_bytes():
                    out = gw.pump(max_records=1024)["mp:1"]
                    if "error" in out:
                        raise AssertionError(f"geo pump failed: {out}")
                    n += 1
                return n

            t = time.perf_counter()
            for ino in range(1000, 1000 + geo_records):
                mk(mp1, ino)
            submit_s = time.perf_counter() - t
            t = time.perf_counter()
            pumps = drain(gw1)
            ship_s = time.perf_counter() - t
            cases["geo_ship"] = {"records": geo_records, "submit_s": submit_s,
                                 "ship_s": ship_s, "records_s": geo_records / ship_s,
                                 "pumps": pumps,
                                 "applied_seq": gw2._parts["mp:1"].applier.applied_seq}
            checks["geo_ship_converges"] = (
                geo.fsm_digest(mp1) == geo.fsm_digest(mp2)
                and gw2._parts["mp:1"].applier.applied_seq == geo_records)

            # a third region joins empty: bootstrapped over the packet mux
            mp3, gw3 = region("r3", "follower", "geo-r1")
            gw1.serve_packets()
            gw3._parts["mp:1"].needs_bootstrap = True
            gw1.peer_addr = "geo-r3"
            image = len(mp1.state_bytes())
            rx0 = metrics.pkt_frames.value(dir="rx", side="client")
            t = time.perf_counter()
            boot = gw1.pump()["mp:1"]
            boot_s = time.perf_counter() - t
            frames = metrics.pkt_frames.value(dir="rx", side="client") - rx0
            gw1.peer_addr = "geo-r2"
            cases["geo_bootstrap"] = {"image_bytes": image, "seconds": boot_s,
                                      "mib_s": image / boot_s / MIB, "frames": frames,
                                      "applied_seq": boot.get("applied_seq")}
            checks["geo_bootstrap_over_the_mux"] = (
                boot.get("applied_seq") == geo_records and geo.fsm_digest(mp3) == geo.fsm_digest(mp1)
                and image > 2 * MIB and frames >= image // packet.chunk_size()
                and bool(gw3._wires))

            # fence -> promote -> the old primary demoted and bootstrapped
            t = time.perf_counter()
            gw2.transition("fence", op_id="smoke-fence")
            promo = gw2.transition("promote", op_id="smoke-promote")
            again = gw2.transition("promote", op_id="smoke-promote")
            gw1.transition("demote", op_id="smoke-demote")
            gw2.serve_packets()
            for ino in range(100, 100 + 512):
                mk(mp2, ino)
            drain(gw2)
            after_failover = geo.fsm_digest(mp1) == geo.fsm_digest(mp2)
            # failback: drain under FAILBACK_SYNC, quiesce both, swap
            gw2.transition("failback_sync", op_id="smoke-fb")
            for ino in range(700, 700 + 256):
                mk(mp2, ino)
            drain(gw2)
            gw2.transition("fence", op_id="smoke-fence2")
            gw1.transition("fence", op_id="smoke-fence3")
            back = gw1.transition("promote", op_id="smoke-promote2")
            gw2.transition("demote", op_id="smoke-demote2")
            for ino in range(50000, 50000 + 256):
                mk(mp1, ino)
            drain(gw1)
            cycle_s = time.perf_counter() - t
            try:
                mk(mp2, 99999)
                refused = None
            except rpc.RpcError as e:
                refused = e.code
            cases["geo_cycle"] = {"seconds": cycle_s, "epochs": [gw1.controller.epoch,
                                                                 gw2.controller.epoch],
                                  "states": [gw1.controller.state, gw2.controller.state],
                                  "follower_refused": refused,
                                  "inodes": [len(mp1.inodes), len(mp2.inodes)]}
            checks.update({
                "geo_promote_once": (promo["epoch"], promo["replayed"]) == (1, False)
                and (again["epoch"], again["replayed"]) == (1, True),
                "geo_failover_converges": after_failover,
                "geo_failback_epoch_2": back["epoch"] == 2,
                "geo_states": cases["geo_cycle"]["states"] == ["PROMOTED", "FOLLOWING"],
                "geo_digests_equal": geo.fsm_digest(mp1) == geo.fsm_digest(mp2)
                and sorted(mp1.inodes) == sorted(mp2.inodes),
                "geo_follower_refused_452": refused == rpc.GEO_REDIRECT,
            })
        finally:
            os.environ.pop("CUBEFS_GEO", None)
        cases["geo_case_seconds"] = time.perf_counter() - t_case
        launches = {"gf_apply": a_launches()}
    finally:
        for gw in geo_gws:
            gw.close()
        for fsx in clients:
            for cl in (*fsx.meta._packet_clients.values(), *fsx.data._packet_clients.values()):
                cl.close()
        codes = c.down()
        shutil.rmtree(workdir, ignore_errors=True)
        qos.DEFAULT._tracker, qos.DEFAULT._levels, qos.DEFAULT._last_refresh = gate
        for k, v in saved_env.items():
            if v is not None:
                os.environ[k] = v
    checks["every_role_exited_0"] = all(rc == 0 for name, rc in codes.items()
                                        if name not in killed)
    return {"phase": "fs_doors", "card": card, "seconds": time.perf_counter() - t_phase,
            "startup_s": startup_s,
            "cluster": {"roles": {r: len(a) for r, a in roles.items()},
                        "flashgroupmanager": 1, "flashnodes": len(flash),
                        "flash_node_bytes": node_cap, "replicas": 3, "mp_count": 3,
                        "dp_count": 4, "files": files, "file_size": file_size,
                        "writers": writers, "tiered": tier, "racers": racers,
                        "flash_small_files": flash_small, "geo_records": geo_records,
                        "blob_size": blob_size, "codemode": mode.name if mode else None},
            "cases": cases, "digests": {"split": digest_split, "merge": digest_merge,
                                        "balance": digest_balance},
            "exit_codes": {**codes}, "split_launches": split_launches,
            "launches": launches, "checks": checks}


def clients_phase(dev, card: str, *, objects: int = CLIENT_OBJECTS, obj_size: int = CLIENT_OBJECT,
                  files: int = CLIENT_FILES, file_size: int = CLIENT_FILE,
                  writers: int = CLIENT_WRITERS, call_size: int = CLIENT_CALL,
                  tier: int = CLIENT_TIER, fuse_files: int = CLIENT_FUSE_FILES,
                  shard: int = SHARD, blob_size: int = BLOB,
                  crc_blocks: int = CLIENT_CRC_BLOCKS, crc_block: int = CLIENT_CRC_BLOCK,
                  device: str | None = None) -> dict:
    """Phase ``clients``: the clients and mounts, through the port's C ABI
    (``runtime/nativeclient``, built here from ``csrc/host/native_client.cc``).
    The launcher starts a master, 3 metanodes, 4 datanodes at replicas 3
    and ``vol1`` of 3 meta and 4 data partitions, a clustermgr with 6
    blobnodes x 3 disks, a proxy, access (engine ``cuda``, ``blob_size``
    blobs, EC12P4), a ``codec`` role (engine ``cuda``), an ``fsgateway``
    and a ``console``, and then a ``fuseclient`` mounting ``vol1``, each a
    ``python -m cubefs_tpu_torch.cmd`` process.

    Case ``native_codec``: ``cfs_codec_encode_shm`` on EC12P4 stripes of
    ``shard``-byte shards, B = 4; ``cfs_codec_encode`` on ``blob_size``
    blobs over the body, B = 4; ``cfs_codec_crc32`` on ``crc_blocks``
    blocks of ``crc_block`` bytes. Every reply is held against the plain
    version on the card and zlib, and A's and B's launches are read from
    the codec role's ``/metrics``.

    Case ``native_blob``: ``cfs_blob_put`` of ``objects`` objects of
    ``obj_size`` bytes, ``cfs_blob_get`` healthy, the parity on the
    blobnodes held against the plain version, and later, with a blobnode
    process stopped, again (A rebuilds in the access process, its
    launches read from its ``/metrics``), then ``cfs_blob_delete``.

    Case ``native_posix``: ``tests/c/fs_abi_test.c`` compiled with gcc
    against the library and run against the launched gateway; ``files``
    files of ``file_size`` bytes written by ``cfs_pwrite`` from
    ``writers`` threads in ``call_size`` calls, read back by
    ``cfs_pread`` and by the SDK's ``FileSystem``. Then an ``FsGateway``
    in this process over a ``FileSystem`` with a ``BlobClient`` (engine
    ``cuda`` on ``dev``) and ``CUBEFS_TIERING=1``: the first ``tier``
    files tiered by one ``LcNode`` scan (A encodes the tier PUT stacks
    here), read through the C ABI healthy and, later, with the blobnode
    stopped (A rebuilds here each blob that lost a data unit). The
    launched gateway, whose ``FileSystem`` has no blob client, reads a
    tiered file as its size in zero bytes (the limit shared with the
    reference).

    Case ``fuse``: the tiered ``FileSystem`` mounted in this process:
    ``cp`` of ``fuse_files`` files of ``file_size`` bytes in and out,
    ``ls``, ``stat``, ``rename``, ``truncate`` and the xattr calls through
    the kernel, and ``cat`` of the tiered files, healthy and with the
    blobnode stopped (A rebuilds here); a file written through the
    launched ``fuseclient``'s mount reads back equal through the SDK.
    Every kernel-facing call runs in a child process under a timeout, and
    a watchdog detaches this process's mount if the case outlives its
    deadline. No ``fuse`` mount is left in ``/proc/mounts``.

    Case ``console_sdk``: the typed clients against the launched roles
    (``MasterClient.stat``/``node_list``, ``ClusterMgrClient.stat``, a
    ``ConsoleClient`` login, ``users``, ``create_user`` and
    ``create_volume``), and the console's ``/api/nodes`` equal to the
    master's ``node_list``. ``device`` is the roles' (None: the card).
    Returns the record with ``checks`` and ``launches`` per process."""
    import ctypes
    import glob
    import hashlib

    import torch

    from cubefs_tpu_torch.blob.access import AccessConfig
    from cubefs_tpu_torch.blob.sdk import BlobClient
    from cubefs_tpu_torch.codec import codemode as cm
    from cubefs_tpu_torch.deploy.cluster import Cluster, Proc
    from cubefs_tpu_torch.fs import fuse
    from cubefs_tpu_torch.fs.client import FileSystem
    from cubefs_tpu_torch.fs.fsgateway import FsGateway
    from cubefs_tpu_torch.fs.lcnode import LcNode, LifecycleRule
    from cubefs_tpu_torch.ops import _build, gf256, rs_kernel
    from cubefs_tpu_torch.runtime import fsnative, nativeclient
    from cubefs_tpu_torch.sdk import ClusterMgrClient, ConsoleClient, MasterClient
    from cubefs_tpu_torch.utils import qos, rpc

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 29)
    print(json.dumps({"phase": "clients", "card": card}), flush=True)
    if not os.path.exists("/dev/fuse") or os.geteuid() != 0:
        raise AssertionError("phase clients: case fuse needs /dev/fuse and root")
    t = time.perf_counter()
    lib = nativeclient.load()
    fsnative.load()
    lib_build_s = time.perf_counter() - t
    workdir = tempfile.mkdtemp(prefix="cubefs-smoke-clients-")
    gate = (qos.DEFAULT._tracker, qos.DEFAULT._levels, qos.DEFAULT._last_refresh)
    qos.DEFAULT._tracker, qos.DEFAULT._levels = Quiet(), {}
    qos.DEFAULT._last_refresh = float("-inf")
    doors = ("CUBEFS_TIERING", "CUBEFS_UNTIER_HOT", "CUBEFS_READ_CACHE", "CUBEFS_META_SPLIT")
    saved_env = {v: os.environ.pop(v, None) for v in doors}
    cases: dict[str, dict] = {}
    checks: dict[str, bool] = {}
    topo = {"metanodes": 3, "datanodes": 4, "replicas": 3,
            "volume": {"name": "vol1", "mp_count": 3, "dp_count": 4},
            "blobnodes": BLOB_NODES, "disks_per_blobnode": BLOB_DISKS, "access": True,
            "proxy": True, "codec": True, "ec_engine": "cuda", "blob_size": blob_size,
            "fsgateway": True, "console": True, "device": device}
    c = Cluster(topo, workdir, timeout=300.0)
    clients: list = []
    mounts: list = []
    gw_srv = None
    codes: dict = {}
    killed: set = set()
    fired = threading.Event()
    mnt, role_mnt = os.path.join(workdir, "mnt"), os.path.join(workdir, "role-mnt")

    def a_launches() -> int:
        return _build.LAUNCHES["gf_apply"]

    def hp(addr: str) -> tuple[bytes, int]:
        host, port = addr.rsplit(":", 1)
        return host.encode(), int(port)

    def wait_for(cond, what: str, timeout: float = 120.0):
        deadline = time.perf_counter() + timeout
        while True:
            try:
                got = cond()
                if got:
                    return got
            except Exception as e:  # an election in progress
                err = e
            else:
                err = None
            if time.perf_counter() > deadline:
                raise AssertionError(f"phase clients: timed out waiting for {what}: {err}")
            time.sleep(0.1)

    def kernel_call(argv: list, timeout: float = 300.0) -> subprocess.CompletedProcess:
        """A call through the kernel, in a child process under a timeout."""
        run = subprocess.run(argv, capture_output=True, text=True, timeout=timeout)
        if run.returncode:
            raise AssertionError(f"{argv[:3]} exited {run.returncode}: {run.stderr[-2000:]}")
        return run

    def sha(path: str) -> str:
        return kernel_call(["sha256sum", path]).stdout.split()[0]

    def fuse_mounts() -> list[str]:
        with open("/proc/mounts") as f:
            return [ln.strip() for ln in f if ln.split()[2].startswith("fuse")
                    and ln.split()[1].startswith(workdir)]

    def c_open(h, path: str, flags: int, mode: int = 0o644) -> int:
        fd = lib.cfs_open(h, path.encode(), flags, mode)
        if fd < 0:
            raise AssertionError(f"cfs_open {path}: {fd} {lib.cfs_last_error()}")
        return fd

    def c_read(addr: str, path: str, size: int) -> bytes:
        h = lib.cfs_mount(*hp(addr))
        try:
            fd = c_open(h, path, 0)
            buf = ctypes.create_string_buffer(size + 1)
            n = lib.cfs_pread(h, fd, buf, size + 1, 0)
            lib.cfs_close(h, fd)
            return buf.raw[:max(n, 0)]
        finally:
            lib.cfs_unmount(h)

    try:
        t = time.perf_counter()
        state = c.up()
        roles = state["roles"]
        master, cmgr = roles["master"][0], roles["clustermgr"][0]
        fc = Proc("fuseclient", {"role": "fuseclient", "name": "fuseclient",
                                 "master_addr": master, "vol": state["volume"],
                                 "mountpoint": role_mnt, **({"device": device} if device else {})},
                  workdir)
        c.procs.append(fc)
        checks["fuseclient_mounted"] = fc.wait_addr(300.0) == role_mnt
        startup_s = time.perf_counter() - t
        n, m = 12, 4
        enc_rows = gf256.parity_matrix(n, m)
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 29)

        def rand(*shape) -> torch.Tensor:
            return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)

        def plain(x: torch.Tensor) -> np.ndarray:
            return rs_kernel.gf_apply_bits(torch.from_numpy(rs_kernel.coeff_bits(enc_rows)),
                                           x).cpu().numpy()

        # == case native_codec: the C ABI against the codec role =============
        codec = roles["codec"][0]
        m0 = scrape(codec)
        need = 4 * (n + m) * shard
        shm_fs = os.statvfs("/dev/shm")
        free = shm_fs.f_bavail * shm_fs.f_frsize
        if free < need:
            raise AssertionError(f"/dev/shm has {free} bytes free; cfs_codec_encode_shm needs {need}")

        def timed(fn, reps: int = 3) -> tuple[list, list]:
            outs, ms = [], []
            for _ in range(reps):
                t = time.perf_counter()
                outs.append(fn())
                ms.append((time.perf_counter() - t) * 1e3)
            return outs, ms

        x = rand(4, n, shard)
        data = np.ascontiguousarray(x.cpu().numpy())
        want = plain(x)
        parity = np.zeros((4, m, shard), np.uint8)
        rcs, ms = timed(lambda: lib.cfs_codec_encode_shm(
            *hp(codec), n, m, shard, 4, data.ctypes.data_as(ctypes.c_void_p),
            parity.ctypes.data_as(ctypes.c_void_p)))
        cases["codec_encode_shm"] = {"shape": [4, n, shard], "bytes": data.nbytes,
                                     "ms_runs": ms, "ms": statistics.median(ms),
                                     "gib_s": data.nbytes / (statistics.median(ms) / 1e3) / 2**30,
                                     "equal": rcs == [0] * 3 and np.array_equal(parity, want)}
        checks["codec_encode_shm.equal"] = cases["codec_encode_shm"]["equal"]
        checks["codec_encode_shm_no_leak"] = not glob.glob(f"/dev/shm/cubefs-codec-{os.getpid()}-*")
        blob_s = -(-blob_size // n)
        x = rand(4, n, blob_s)
        body = x.cpu().numpy().tobytes()
        want = plain(x)
        parity = np.zeros((4, m, blob_s), np.uint8)
        rcs, ms = timed(lambda: lib.cfs_codec_encode(
            *hp(codec), n, m, blob_s, 4, body, parity.ctypes.data_as(ctypes.c_void_p)))
        cases["codec_encode"] = {"shape": [4, n, blob_s], "bytes": len(body), "ms_runs": ms,
                                 "ms": statistics.median(ms),
                                 "gib_s": len(body) / (statistics.median(ms) / 1e3) / 2**30,
                                 "equal": rcs == [0] * 3 and np.array_equal(parity, want)}
        checks["codec_encode.equal"] = cases["codec_encode"]["equal"]
        blocks = rand(crc_blocks, crc_block).cpu().numpy()
        body = blocks.tobytes()
        want_crc = [zlib.crc32(r) for r in blocks]
        crcs = np.zeros(crc_blocks, np.uint32)
        cnts, ms = timed(lambda: lib.cfs_codec_crc32(
            *hp(codec), crc_block, body, len(body), crcs.ctypes.data_as(ctypes.c_void_p)))
        cases["codec_crc32"] = {"blocks": crc_blocks, "block": crc_block, "bytes": len(body),
                                "ms_runs": ms, "ms": statistics.median(ms),
                                "gib_s": len(body) / (statistics.median(ms) / 1e3) / 2**30,
                                "equal": cnts == [crc_blocks] * 3 and crcs.tolist() == want_crc}
        checks["codec_crc32.equal"] = cases["codec_crc32"]["equal"]
        del x, data, body, blocks
        m1 = scrape(codec)
        codec_launches = {"gf_apply": m1.get(LAUNCH_A, 0.0) - m0.get(LAUNCH_A, 0.0),
                          "crc32_blocks": m1.get(LAUNCH_B, 0.0) - m0.get(LAUNCH_B, 0.0)}
        checks["codec_role_launched_a_and_b"] = all(v > 0 for v in codec_launches.values())

        # == case native_blob: the C ABI against the access role =============
        acc = roles["access"][0]
        objs = [rng.bytes(obj_size) for _ in range(objects)]
        a0 = a0_access = scrape(acc).get(LAUNCH_A, 0.0)
        locs, ms = [], []
        for obj in objs:
            loc_buf = ctypes.create_string_buffer(1 << 16)
            t = time.perf_counter()
            rc = lib.cfs_blob_put(*hp(acc), obj, len(obj), loc_buf, len(loc_buf))
            ms.append((time.perf_counter() - t) * 1e3)
            if rc != 0:
                raise AssertionError(f"cfs_blob_put: {rc} {lib.cfs_last_error()}")
            locs.append(json.loads(loc_buf.value)["location"])
        put_a = scrape(acc).get(LAUNCH_A, 0.0) - a0
        cases["blob_put"] = {"objects": objects, "bytes": objects * obj_size, "ms_runs": ms,
                             "ms": statistics.median(ms),
                             "gib_s": obj_size / (statistics.median(ms) / 1e3) / 2**30,
                             "access_a_launches": put_a}
        getbuf = ctypes.create_string_buffer(obj_size + 16)

        def blob_gets(label: str) -> None:
            a0, ms, equal = scrape(acc).get(LAUNCH_A, 0.0), [], []
            for loc, obj in zip(locs, objs):
                args = json.dumps({"location": loc}).encode()
                t = time.perf_counter()
                got = lib.cfs_blob_get(*hp(acc), args, getbuf, len(getbuf))
                ms.append((time.perf_counter() - t) * 1e3)
                equal.append(got == len(obj) and getbuf.raw[:got] == obj)
            cases[label] = {"objects": objects, "ms_runs": ms, "ms": statistics.median(ms),
                            "gib_s": obj_size / (statistics.median(ms) / 1e3) / 2**30,
                            "access_a_launches": scrape(acc).get(LAUNCH_A, 0.0) - a0,
                            "equal": all(equal)}
            checks[f"{label}.equal"] = all(equal)
        blob_gets("blob_get")
        blob_mode = cm.CodeMode(locs[0]["codemode"])
        blob_vols = tiered_volumes(cmgr, locs)
        tac = cm.tactic(blob_mode)
        blob_parity = tiered_parity_equal(blob_vols, locs, tac.n, tac.m)
        checks["blob_codemode_ec12p4"] = blob_mode == cm.CodeMode.EC12P4
        checks["blob_parity_equals_plain"] = bool(blob_parity) and all(blob_parity)
        # the access role encodes a PUT's blobs as one stack: A once a PUT
        checks["blob_put_launched_a_per_object"] = put_a >= objects

        # == case native_posix: the C ABI against the fsgateway ===============
        gw = roles["fsgateway"][0]
        exe = os.path.join(workdir, "fs_abi_test")
        root = os.path.dirname(os.path.abspath(__file__))
        t = time.perf_counter()
        kernel_call(["gcc", "-o", exe, os.path.join(root, "tests", "c", "fs_abi_test.c"),
                     nativeclient.lib_path()])
        abi = subprocess.run([exe, *gw.rsplit(":", 1)], capture_output=True, text=True,
                             timeout=300, env={**os.environ, "LD_LIBRARY_PATH":
                                               os.path.dirname(nativeclient.lib_path())})
        cases["fs_abi_test"] = {"seconds": time.perf_counter() - t, "rc": abi.returncode,
                                "stdout": abi.stdout[-200:], "stderr": abi.stderr[-400:]}
        checks["fs_abi_test_ok"] = abi.returncode == 0 and "fs_abi_test OK" in abi.stdout
        paths = [f"/posix/f{i:02d}" for i in range(files)]
        payload = {p: rng.bytes(file_size) for p in paths}
        h = lib.cfs_mount(*hp(gw))
        wait_for(lambda: lib.cfs_mkdirs(h, b"/posix") == 0, "mkdirs /posix")
        lib.cfs_unmount(h)

        def pwrite_files(i):
            h = lib.cfs_mount(*hp(gw))
            try:
                for p in paths[i::writers]:
                    fd = c_open(h, p, 0o1 | 0o100)  # O_WRONLY | O_CREAT
                    base = np.frombuffer(payload[p], np.uint8).ctypes.data
                    for off in range(0, file_size, call_size):
                        k = min(call_size, file_size - off)
                        got = lib.cfs_pwrite(h, fd, ctypes.c_char_p(base + off), k, off)
                        if got != k:
                            raise AssertionError(f"cfs_pwrite {p}@{off}: {got} "
                                                 f"{lib.cfs_last_error()}")
                    lib.cfs_close(h, fd)
            finally:
                lib.cfs_unmount(h)
        secs = run_threads(writers, pwrite_files)
        cases["posix_pwrite"] = {"files": files, "bytes": files * file_size, "call": call_size,
                                 "threads": writers, "seconds": secs,
                                 "gib_s": files * file_size / secs / 2**30}
        back: dict = {}

        def pread_files(i):
            for p in paths[i::writers]:
                back[p] = c_read(gw, p, file_size)
        secs = run_threads(writers, pread_files)
        cases["posix_pread"] = {"files": files, "seconds": secs,
                                "gib_s": files * file_size / secs / 2**30,
                                "equal": all(back.get(p) == payload[p] for p in paths)}
        checks["posix_pread.equal"] = cases["posix_pread"]["equal"]
        del back

        def view() -> dict:
            return rpc.call(master, "client_view", {"name": state["volume"]})[0]["volume"]

        pool = rpc.NodePool()
        # through the proxy, as the access role: its volume lease was taken
        # while every disk was healthy, and a disk the blobnodes quarantine
        # for latency after case blob_put (30 s at least) leaves 14 of 18
        # normal, too few for a new EC12P4 volume
        blob = BlobClient(cmgr, pool, AccessConfig(blob_size=blob_size, engine="cuda", device=dev),
                          proxy=roles["proxy"][0])
        os.environ["CUBEFS_TIERING"] = "1"
        try:
            fs = FileSystem(view(), pool, blob_client=blob, master_addr=master)
        finally:
            os.environ.pop("CUBEFS_TIERING", None)
        clients.append(fs)
        t = time.perf_counter()
        sdk_equal = all(fs.read_file(p) == payload[p] for p in paths)
        cases["posix_sdk_read"] = {"files": files, "seconds": time.perf_counter() - t,
                                   "equal": sdk_equal}
        checks["posix_sdk_read.equal"] = sdk_equal
        cold = paths[:tier]
        now = time.time()
        for p in cold:
            fs.meta.set_attr(fs.resolve(p), mtime=now - 7200)
        lc = LcNode(fs, engine=fs.tiering)
        lc.set_rules([LifecycleRule("tier", prefix="/posix/", transition_after_s=3600)])
        a0, t = a_launches(), time.perf_counter()
        rep = lc.scan_once()
        inodes = {p: fs.meta.inode_get(fs.resolve(p)) for p in cold}
        tiered = [json.loads(i["xattr"]["cold.location"]) for i in inodes.values()
                  if i["xattr"].get("cold.location")]
        cases["posix_tier"] = {"files": tier, "seconds": time.perf_counter() - t,
                               "transitioned": rep.transitioned, "errors": rep.errors,
                               "a_launches": a_launches() - a0}
        checks["posix_tiered_all"] = (rep.transitioned == tier and not rep.errors
                                      and len(tiered) == tier
                                      and all(not i["extents"] for i in inodes.values()))
        checks["posix_tier_launched_a_per_file"] = cases["posix_tier"]["a_launches"] >= tier
        tier_vols = tiered_volumes(cmgr, tiered)
        tier_tac = cm.tactic(cm.CodeMode(tiered[0]["codemode"]))
        tier_parity = tiered_parity_equal(tier_vols, tiered, tier_tac.n, tier_tac.m)
        checks["posix_tier_codemode_ec12p4"] = tier_tac.n == n and tier_tac.m == m
        checks["posix_tier_parity_equals_plain"] = bool(tier_parity) and all(tier_parity)
        gw_srv = rpc.RpcServer(rpc.expose(FsGateway(fs)), service="fsgateway").start()

        def cold_reads(label: str) -> None:
            a0, ms, equal = a_launches(), [], []
            for p in cold:
                t = time.perf_counter()
                equal.append(c_read(gw_srv.addr, p, file_size) == payload[p])
                ms.append((time.perf_counter() - t) * 1e3)
            cases[label] = {"files": tier, "ms_runs": ms, "ms": statistics.median(ms),
                            "a_launches": a_launches() - a0, "equal": all(equal)}
            checks[f"{label}.equal"] = all(equal)
        cold_reads("posix_cold_read")
        checks["launched_gateway_reads_tiered_as_zeros"] = (
            c_read(gw, cold[0], file_size) == bytes(file_size))

        # == case fuse: the tiered volume and the fuseclient through the kernel
        def detach():
            fired.set()
            for mt in mounts:
                mt.unmount()
        watchdog = threading.Timer(600.0, detach)
        watchdog.daemon = True
        watchdog.start()
        t = time.perf_counter()
        mounts.append(fuse.mount(fs, mnt))
        kernel_call([sys.executable, "-c", f"import os; os.listdir({mnt!r})"], timeout=30)
        cases["fuse_mount_s"] = time.perf_counter() - t
        local = os.path.join(workdir, "local")
        os.makedirs(local)
        names = [f"g{i}" for i in range(fuse_files)]
        for name, p in zip(names, paths[tier:]):
            with open(os.path.join(local, name), "wb") as f:
                f.write(payload[p])
        kernel_call(["mkdir", f"{mnt}/fuse"])
        t = time.perf_counter()
        kernel_call(["cp", *[os.path.join(local, x) for x in names], f"{mnt}/fuse/"])
        cp_in = time.perf_counter() - t
        os.makedirs(os.path.join(workdir, "out"))
        t = time.perf_counter()
        kernel_call(["cp", *[f"{mnt}/fuse/{x}" for x in names], os.path.join(workdir, "out")])
        cp_out = time.perf_counter() - t
        out_equal = all(open(os.path.join(workdir, "out", x), "rb").read() == payload[p]
                        for x, p in zip(names, paths[tier:]))
        sdk_equal = all(fs.read_file(f"/fuse/{x}") == payload[p]
                        for x, p in zip(names, paths[tier:]))
        nbytes = fuse_files * file_size
        cases["fuse_cp"] = {"files": fuse_files, "bytes": nbytes, "in_s": cp_in, "out_s": cp_out,
                            "in_gib_s": nbytes / cp_in / 2**30, "out_gib_s": nbytes / cp_out / 2**30,
                            "equal": out_equal, "sdk_equal": sdk_equal}
        checks["fuse_cp.equal"] = out_equal and sdk_equal
        posix = json.loads(kernel_call([sys.executable, "-c", r'''
import json, os, subprocess, sys
d = f"{sys.argv[1]}/fuse"
out = {}

def op(name, fn, *args):
    try:
        out[name] = fn(*args)
    except OSError as e:
        out[name] = {"errno": e.errno}

op("ls", lambda: subprocess.run(["ls", "-1", d], capture_output=True, text=True,
                                check=True).stdout.split())
op("stat", lambda: [os.stat(f"{d}/g0").st_size, oct(os.stat(f"{d}/g0").st_mode),
                    os.stat(f"{d}/g0").st_nlink])
op("rename", os.rename, f"{d}/g0", f"{d}/renamed")
op("after_rename", lambda: sorted(os.listdir(d)))
op("truncate", os.truncate, f"{d}/renamed", 4096)
op("truncated", lambda: os.stat(f"{d}/renamed").st_size)
op("setxattr", os.setxattr, f"{d}/g1", "user.smoke", b"clients")
op("getxattr", lambda: os.getxattr(f"{d}/g1", "user.smoke").decode())
op("listxattr", os.listxattr, f"{d}/g1")
op("removexattr", os.removexattr, f"{d}/g1", "user.smoke")
op("listxattr_after", os.listxattr, f"{d}/g1")
op("rmdir_nonempty", os.rmdir, d)
print(json.dumps(out))
''', mnt], timeout=120).stdout)
        cases["fuse_posix"] = posix
        checks["fuse_posix"] = (
            posix["ls"] == sorted(names) and posix["stat"] == [file_size, oct(0o100644), 1]
            and posix["rename"] is None
            and posix["after_rename"] == sorted(["renamed", *names[1:]])
            and posix["truncate"] is None and posix["truncated"] == 4096
            and posix["rmdir_nonempty"] == {"errno": 39}
            and fs.read_file("/fuse/renamed") == payload[paths[tier]][:4096])
        # xattrs through the kernel: a round trip, or refused by the kernel
        # itself where its FUSE client has no xattr calls (a gVisor kernel:
        # EOPNOTSUPP, and an empty list)
        xattrs = [posix[k] for k in ("setxattr", "getxattr", "listxattr", "removexattr",
                                     "listxattr_after")]
        refused = xattrs == [{"errno": 95}, {"errno": 95}, [], {"errno": 95}, []]
        cases["fuse_xattr_refused_by_kernel"] = refused
        checks["fuse_xattr"] = refused or xattrs == [None, "clients", ["user.smoke"], None, []]

        def fuse_cold(label: str) -> None:
            a0, ms, equal = a_launches(), [], []
            for p in cold:
                t = time.perf_counter()
                equal.append(sha(f"{mnt}{p}") == hashlib.sha256(payload[p]).hexdigest())
                ms.append((time.perf_counter() - t) * 1e3)
            cases[label] = {"files": tier, "ms_runs": ms, "ms": statistics.median(ms),
                            "a_launches": a_launches() - a0, "equal": all(equal)}
            checks[f"{label}.equal"] = all(equal)
        fuse_cold("fuse_cold_cat")
        role_file = os.path.join(local, names[0])
        t = time.perf_counter()
        kernel_call(["cp", role_file, f"{role_mnt}/from_fuseclient"])
        cases["fuseclient_cp_s"] = time.perf_counter() - t
        checks["fuseclient_write_reads_back_through_the_sdk"] = (
            fs.read_file("/from_fuseclient") == payload[paths[tier]])

        # == case console_sdk: the typed clients and the console ================
        t = time.perf_counter()
        mc = MasterClient(master)
        mstat, nodes = mc.stat(), mc.node_list()
        cstat = ClusterMgrClient(cmgr).stat()
        root_user = mc.create_user("root")
        cc = ConsoleClient(roles["console"][0])
        cc.login(root_user["access_key"], root_user["secret_key"])
        carol = cc.create_user("smoke-carol")
        newvol = cc.create_volume("smokevol", mp_count=1, dp_count=1)
        users = cc.users()
        st_, con_nodes = 0, {}
        host, port = roles["console"][0].rsplit(":", 1)
        conn = http.client.HTTPConnection(host, int(port), timeout=60)
        try:
            conn.request("GET", "/api/nodes")
            resp = conn.getresponse()
            st_, con_nodes = resp.status, json.loads(resp.read())
        finally:
            conn.close()
        cases["console_sdk"] = {"seconds": time.perf_counter() - t,
                                "master_volumes": sorted(mc.stat()["volumes"]),
                                "metanodes": len(nodes["metanodes"]),
                                "datanodes": len(nodes["datanodes"]),
                                "clustermgr_stat_keys": sorted(cstat)[:12]}
        checks["console_sdk"] = (
            "vol1" in mstat["volumes"] and len(nodes["metanodes"]) == 3
            and len(nodes["datanodes"]) == 4 and bool(cstat)
            and newvol["name"] == "smokevol" and "smokevol" in mc.stat()["volumes"]
            and carol["access_key"] in users and root_user["access_key"] in users)
        checks["console_nodes_equal_the_masters"] = (
            st_ == 200 and {k: len(v) for k, v in con_nodes.items()}
            == {k: len(v) for k, v in mc.node_list().items()})

        # == with one blobnode process stopped: A rebuilds ====================
        vols = {**blob_vols, **tier_vols}
        stopped, blob_exit, _ = stop_a_blobnode(c, roles["blobnode"], vols, locs + tiered,
                                                min(tac.n, tier_tac.n), min(tac.m, tier_tac.m))
        killed.add(stopped)
        victim = next(p.addr for p in c.procs if p.name == stopped)

        def lost_in(group: list, k: int) -> int:  # blobs of ``group`` that lost a data unit
            return sum(sl["count"] for loc in group for sl in loc["slices"]
                       if any(u["index"] < k and u["node_addr"] == victim
                              for u in vols[sl["vid"]]["units"]))
        lost_blob, lost_tier = lost_in(locs, tac.n), lost_in(tiered, tier_tac.n)
        blob_gets("blob_degraded_get")
        cold_reads("posix_degraded_cold_read")
        fuse_cold("fuse_degraded_cold_cat")
        cases["degraded"] = {"stopped": stopped, "exit": blob_exit,
                             "blob_blobs_lost_a_data_unit": lost_blob,
                             "tiered_blobs_lost_a_data_unit": lost_tier}
        checks["degraded_stop_lost_data_units"] = lost_blob > 0 and lost_tier > 0
        checks["blob_degraded_launched_a_per_lost_blob"] = (
            cases["blob_degraded_get"]["access_a_launches"] >= lost_blob)
        checks["posix_degraded_launched_a_per_lost_blob"] = (
            cases["posix_degraded_cold_read"]["a_launches"] >= lost_tier)
        checks["fuse_degraded_launched_a_per_lost_blob"] = (
            cases["fuse_degraded_cold_cat"]["a_launches"] >= lost_tier)
        deleted = []
        for loc in locs:
            args = json.dumps({"location": loc}).encode()
            deleted.append((lib.cfs_blob_delete(*hp(acc), args),
                            lib.cfs_blob_get(*hp(acc), args, getbuf, len(getbuf))))
        checks["blob_delete_then_get_fails"] = all(d == 0 and g < 0 for d, g in deleted)
        watchdog.cancel()
        launches = {"this_process": {"gf_apply": a_launches(),
                                     "crc32_blocks": _build.LAUNCHES["crc32_blocks"]},
                    "codec_role": codec_launches,
                    "access_role": {"gf_apply": scrape(acc).get(LAUNCH_A, 0.0) - a0_access}}
    except BaseException:
        print(json.dumps({"phase": "clients", "failed_after": cases, "checks": checks},
                         default=str), file=sys.stderr, flush=True)
        raise
    finally:
        for mt in mounts:
            mt.unmount()
        if gw_srv is not None:
            gw_srv.stop()
        for fsx in clients:
            for cl in (*fsx.meta._packet_clients.values(), *fsx.data._packet_clients.values()):
                cl.close()
        codes = c.down()
        left = fuse_mounts()
        shutil.rmtree(workdir, ignore_errors=True)
        qos.DEFAULT._tracker, qos.DEFAULT._levels, qos.DEFAULT._last_refresh = gate
        for k, v in saved_env.items():
            if v is not None:
                os.environ[k] = v
    checks["no_fuse_mount_left"] = not left
    checks["watchdog_quiet"] = not fired.is_set()
    checks["every_role_exited_0"] = all(rc == 0 for name, rc in codes.items()
                                        if name not in killed)
    return {"phase": "clients", "card": card, "seconds": time.perf_counter() - t_phase,
            "kernel": " ".join(os.uname()[2:4]), "startup_s": startup_s,
            "library_build_s": lib_build_s,
            "cluster": {"roles": {r: len(a) for r, a in roles.items()}, "fuseclient": 1,
                        "replicas": 3, "mp_count": 3, "dp_count": 4, "blob_size": blob_size,
                        "codemode": blob_mode.name, "objects": objects, "object": obj_size,
                        "files": files, "file_size": file_size, "writers": writers,
                        "call": call_size, "tiered": tier, "fuse_files": fuse_files},
            "cases": cases, "exit_codes": codes, "mounts_left": left,
            "launches": launches, "checks": checks}


def flip_shard_byte(disk_path: str, chunk_id: int, shard: bytes) -> tuple[str, int]:
    """Flip one bit of a stored shard in its chunk's data file on disk
    (the chunk store writes a shard's payload contiguously, behind its
    CRC): the file and offset flipped. The window searched for must occur
    exactly once."""
    mid = len(shard) // 2
    window = shard[mid:mid + 256]
    hits = []
    prefix = f"chunk_{chunk_id:016x}"
    for name in sorted(os.listdir(disk_path)):
        if not (name.startswith(prefix) and name.endswith(".data")):
            continue
        path = os.path.join(disk_path, name)
        with open(path, "rb") as f:
            raw = f.read()
        at = raw.find(window)
        while at >= 0:
            hits.append((path, at))
            at = raw.find(window, at + 1)
    if len(hits) != 1:
        raise AssertionError(f"shard window found {len(hits)} times in {disk_path}")
    path, at = hits[0]
    with open(path, "r+b") as f:
        f.seek(at)
        b = f.read(1)
        f.seek(at)
        f.write(bytes([b[0] ^ 0x01]))
    return path, at


def operators_phase(dev, card: str, *, files: int = OPS_FILES, file_size: int = OPS_FILE,
                    objects: int = OPS_OBJECTS, obj_size: int = OPS_OBJECT,
                    bitflips: int = OPS_BITFLIPS, bench_count: int = OPS_BENCH_COUNT,
                    bench_size: int = OPS_BENCH_SIZE, bench_conc: int = OPS_BENCH_CONC,
                    submitters: int = OPS_SUBMITTERS, iters: int = OPS_ITERS,
                    repair_stripes: int = OPS_REPAIR_STRIPES, tier_files: int | None = None,
                    blob_size: int = BLOB, device: str | None = None) -> dict:
    """Phase ``operators``: the operator plane and the blob and codec tools.
    The launcher starts phase ``fs``'s planes (a master, 3 metanodes, 4
    datanodes at replicas 3) and the blob roles (a clustermgr, 6
    blobnodes x 3 disks, a proxy and access on engine ``cuda``, ``blob_size``
    blobs, EC12P4), each a ``python -m cubefs_tpu_torch.cmd`` process.

    Every step but the last three goes through ``python -m
    cubefs_tpu_torch.cli`` subprocesses, as operators run it, and each holds
    its bytes exactly: ``cluster stat``, ``vol create opsvol``; ``fs
    mkdir/put/get/ls/stat/mv/rm`` on ``files`` files of ``file_size``
    bytes; ``blob put/get`` of ``objects`` objects of ``obj_size`` bytes
    (A's launches read from the access process's ``/metrics``: one PUT
    stack each). Then the scheduler role, started on a copy of the
    clustermgr's state with engine ``cuda`` and its failure detector's task
    kinds switched off (``tasks_off``: no blobnode heartbeats to that copy;
    the role's clustermgr is standalone, as the reference's), and the
    views: ``blob vols/disks``, ``node list``, ``tasks list/stats``, ``cm
    config-list``, ``mq status`` and ``metrics codec/repair/integrity/
    write-path/wire/raw``, each JSON with the traffic's counters non-zero.
    ``scrub run --full`` with ``bitflips`` bits flipped in stored shards on
    the blobnodes' disks (2 data units, 2 parity units, CRC-refused on
    read): every one queued, rebuilt by a ``RepairWorker`` here (engine
    ``cuda``), the new units written back to the clustermgr, a second pass
    clean, the objects read back equal, A's launches from the scheduler's
    ``/metrics``, and the stripes and bytes each pass staged.

    In this process: ``fsck`` of the volume clean; one extent replica
    rewritten on a datanode (its ``write_replica`` route, the follower leg)
    reported, healed by ``fsck(heal=True)``, then clean; an ``FsScrubber``
    full pass heals a second one. ``tool/snapshot``: export, verify and
    restore of ``opsvol``, the restored partitions' state equal to the live
    one. ``DialProber.probe_once()`` and ``bench_tool.run`` (``bench_count``
    x ``bench_size`` at concurrency ``bench_conc``) against the access role.
    On ``dev``: ``bench_codec.run_ab`` (``submitters`` x ``iters``, batched
    and not, bit-identical and equal to the host tables), ``run_repair_ab``
    at EC6P6MSR (``repair_stripes``) and ``tier_ab``'s legs (A encodes each
    tier PUT). Last, ``blob get`` with one blobnode process stopped: A in
    the access process once per blob that lost a data unit.

    ``loadgen`` and ``scrub_ab`` do no card work and are held by the tier-1
    tests only; here ``loadgen --check-host`` answers, the host calls its
    ``--wire`` mode needs. ``device`` is the roles' (None: the card).
    Returns the record with ``checks`` and ``launches`` per process."""
    import hashlib

    import torch

    from cubefs_tpu_torch.blob import bench_tool, dial
    from cubefs_tpu_torch.blob.worker import RepairWorker
    from cubefs_tpu_torch.codec import codemode as cm
    from cubefs_tpu_torch.deploy.cluster import Cluster, Proc
    from cubefs_tpu_torch.fs import fsck as fscklib
    from cubefs_tpu_torch.fs.client import FileSystem
    from cubefs_tpu_torch.fs.metanode import MetaPartition
    from cubefs_tpu_torch.fs.scrub import FsScrubber
    from cubefs_tpu_torch.ops import _build
    from cubefs_tpu_torch.tool import bench_codec, snapshot, tier_ab
    from cubefs_tpu_torch.utils import qos, rpc

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    rng = np.random.default_rng(SEED + 31)
    print(json.dumps({"phase": "operators", "card": card}), flush=True)
    workdir = tempfile.mkdtemp(prefix="cubefs-smoke-operators-")
    gate = (qos.DEFAULT._tracker, qos.DEFAULT._levels, qos.DEFAULT._last_refresh)
    qos.DEFAULT._tracker, qos.DEFAULT._levels = Quiet(), {}
    qos.DEFAULT._last_refresh = float("-inf")
    doors = ("CUBEFS_TIERING", "CUBEFS_SCRUB", "CUBEFS_VERIFY_READS", "CUBEFS_QOS")
    saved_env = {v: os.environ.pop(v, None) for v in doors}
    cases: dict[str, dict] = {}
    checks: dict[str, bool] = {}
    cli_calls: list[float] = []
    topo = {"metanodes": 3, "datanodes": 4, "replicas": 3,
            "volume": {"name": "vol1", "mp_count": 3, "dp_count": 4},
            "blobnodes": BLOB_NODES, "disks_per_blobnode": BLOB_DISKS, "access": True,
            "proxy": True, "ec_engine": "cuda", "blob_size": blob_size, "device": device}
    c = Cluster(topo, workdir, timeout=300.0)
    clients: list = []
    codes: dict = {}
    killed: set = set()
    local = os.path.join(workdir, "local")
    os.makedirs(local)

    def a_launches() -> int:
        return _build.LAUNCHES["gf_apply"]

    def cli(*args, check: bool = True, timeout: float = 300.0) -> str:
        """One operator command, a process of its own; its stdout."""
        t = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "cubefs_tpu_torch.cli", *args],
                             capture_output=True, text=True, cwd=root, timeout=timeout)
        cli_calls.append(time.perf_counter() - t)
        if check and run.returncode:
            raise AssertionError(f"cli {args[:2]} exited {run.returncode}: "
                                 f"{run.stderr[-3000:]}")
        return run.stdout

    def cli_json(*args) -> dict:
        return json.loads(cli(*args))

    def wait_for(cond, what: str, timeout: float = 120.0):
        deadline = time.perf_counter() + timeout
        while True:
            try:
                got = cond()
            except Exception as e:  # an election in progress
                got, err = None, e
            else:
                err = None
            if got:
                return got
            if time.perf_counter() > deadline:
                raise AssertionError(f"phase operators: timed out waiting for {what}: {err}")
            time.sleep(0.2)

    def staged(vols: dict) -> dict:
        """The stripes and shard bytes a full pass over ``vols`` stages:
        every volume's bids, at the units' stored sizes."""
        stripes = nbytes = 0
        for v in vols.values():
            u0 = v["units"][0]
            st, meta, _ = rpc_post(u0["node_addr"], "list_chunk",
                                   {"disk_id": u0["disk_id"], "chunk_id": u0["chunk_id"]})
            if st != 200:
                raise AssertionError(f"list_chunk: {st}")
            stripes += len(meta["shards"])
            nbytes += sum(size for _, size, _ in meta["shards"]) * len(v["units"])
        return {"stripes": stripes, "bytes": nbytes}

    try:
        t = time.perf_counter()
        state = c.up()
        roles = state["roles"]
        master, cmgr, acc = roles["master"][0], roles["clustermgr"][0], roles["access"][0]
        startup_s = time.perf_counter() - t
        host = subprocess.run([sys.executable, "-m", "cubefs_tpu_torch.tool.loadgen",
                               "--check-host"], capture_output=True, text=True, cwd=root,
                              timeout=60)
        cases["loadgen_check_host"] = {"rc": host.returncode, "out": host.stdout.strip(),
                                       "err": host.stderr[-400:]}
        checks["loadgen_host_calls_answer"] = host.returncode == 0

        # == 1. cluster stat, vol create ======================================
        m = ["--master", master]
        v = [*m, "--vol", "opsvol"]
        stat = cli_json("cluster", "stat", *m)
        cm_stat = cli_json("cluster", "stat", "--clustermgr", cmgr)
        made = cli_json("vol", "create", "opsvol", *m, "--mp-count", "3", "--dp-count", "4")
        view = cli_json("vol", "view", "opsvol", *m)["volume"]
        cases["create"] = {"stat_keys": sorted(stat)[:12], "clustermgr_stat": cm_stat,
                           "created": sorted(made)[:12]}
        checks["cluster_stat_and_vol_create"] = (
            "vol1" in stat.get("volumes", {}) and bool(cm_stat)
            and len(view["mps"]) == 3 and len(view["dps"]) == 4)

        # == 2. the fs group ==================================================
        paths = [f"/ops/f{i}" for i in range(files)]
        payload = {p: rng.bytes(file_size) for p in paths}
        wait_for(lambda: "ops" in cli("fs", "mkdir", "/ops", *v, check=False)
                 + cli("fs", "ls", "/", *v, check=False), "mkdir /ops")
        put_ms, get_ms, equal = [], [], []
        for p in paths:
            src = os.path.join(local, os.path.basename(p))
            with open(src, "wb") as f:
                f.write(payload[p])
            t = time.perf_counter()
            cli("fs", "put", src, p, *v)
            put_ms.append((time.perf_counter() - t) * 1e3)
            os.remove(src)
        for p in paths:
            dst = os.path.join(local, "back")
            t = time.perf_counter()
            cli("fs", "get", p, dst, *v)
            get_ms.append((time.perf_counter() - t) * 1e3)
            with open(dst, "rb") as f:
                equal.append(f.read() == payload[p])
            os.remove(dst)
        listing = cli("fs", "ls", "/ops", *v)
        fstat = cli_json("fs", "stat", paths[0], *v)
        cli("fs", "mv", paths[-1], "/ops/moved", *v)
        moved_ls = cli("fs", "ls", "/ops", *v)
        cli("fs", "get", "/ops/moved", os.path.join(local, "moved"), *v)
        with open(os.path.join(local, "moved"), "rb") as f:
            moved_equal = f.read() == payload[paths[-1]]
        os.remove(os.path.join(local, "moved"))
        cli("fs", "rm", "/ops/moved", *v)
        rm_ls = cli("fs", "ls", "/ops", *v)
        cases["fs"] = {"files": files, "file_size": file_size, "put_ms": put_ms,
                       "get_ms": get_ms, "put_gib_s": file_size / (statistics.median(put_ms) / 1e3)
                       / 2**30, "get_gib_s": file_size / (statistics.median(get_ms) / 1e3) / 2**30,
                       "equal": all(equal)}
        checks["fs_put_get.equal"] = all(equal)
        checks["fs_ls_stat_mv_rm"] = (
            all(os.path.basename(p) in listing for p in paths)
            and fstat["size"] == file_size and "moved" in moved_ls
            and os.path.basename(paths[-1]) not in moved_ls and moved_equal
            and "moved" not in rm_ls and os.path.basename(paths[0]) in rm_ls)

        # == 3. the blob group: PUT and GET through the access role ===========
        objs = [rng.bytes(obj_size) for _ in range(objects)]
        a0_access = scrape(acc).get(LAUNCH_A, 0.0)
        locs, put_ms = [], []
        for i, obj in enumerate(objs):
            src = os.path.join(local, f"obj{i}")
            with open(src, "wb") as f:
                f.write(obj)
            t = time.perf_counter()
            loc = json.loads(cli("blob", "put", src, "--access", acc))
            put_ms.append((time.perf_counter() - t) * 1e3)
            os.remove(src)
            with open(os.path.join(local, f"loc{i}.json"), "w") as f:
                json.dump(loc, f)
            locs.append(loc)
        put_a = scrape(acc).get(LAUNCH_A, 0.0) - a0_access

        def blob_gets(label: str) -> None:
            a0, ms, same = scrape(acc).get(LAUNCH_A, 0.0), [], []
            for i, obj in enumerate(objs):
                dst = os.path.join(local, "got")
                t = time.perf_counter()
                cli("blob", "get", os.path.join(local, f"loc{i}.json"), dst, "--access", acc)
                ms.append((time.perf_counter() - t) * 1e3)
                with open(dst, "rb") as f:
                    same.append(f.read() == obj)
                os.remove(dst)
            cases[label] = {"objects": objects, "ms_runs": ms, "ms": statistics.median(ms),
                            "gib_s": obj_size / (statistics.median(ms) / 1e3) / 2**30,
                            "access_a_launches": scrape(acc).get(LAUNCH_A, 0.0) - a0,
                            "equal": all(same)}
            checks[f"{label}.equal"] = all(same)
        cases["blob_put"] = {"objects": objects, "bytes": objects * obj_size, "ms_runs": put_ms,
                             "ms": statistics.median(put_ms),
                             "gib_s": obj_size / (statistics.median(put_ms) / 1e3) / 2**30,
                             "access_a_launches": put_a}
        blob_gets("blob_get")
        blob_mode = cm.CodeMode(locs[0]["codemode"])
        tac = cm.tactic(blob_mode)
        blob_vols = tiered_volumes(cmgr, locs)
        checks["blob_codemode_ec12p4"] = blob_mode == cm.CodeMode.EC12P4
        checks["blob_put_launched_a_per_object"] = put_a >= objects
        parity = tiered_parity_equal(blob_vols, locs, tac.n, tac.m)
        checks["blob_parity_equals_plain"] = bool(parity) and all(parity)

        # == 4. the scheduler role and the views ==============================
        sched_cm = os.path.join(workdir, "sched-cm")
        shutil.copytree(os.path.join(workdir, "cm"), sched_cm)
        port = free_port()
        mq_me = f"127.0.0.1:{port}"
        sp = Proc("scheduler", {"role": "scheduler", "name": "scheduler", "listen_port": port,
                                "data_dir": sched_cm, "task_dir": os.path.join(workdir, "tasks"),
                                "mq_me": mq_me, "mq_peers": [mq_me],
                                "mq_dir": os.path.join(workdir, "mq"), "ec_engine": "cuda",
                                "tasks_off": ["disk_repair", "balance", "rebalance", "compact",
                                              "scrub"],
                                **({"device": device} if device else {})}, workdir)
        c.procs.append(sp)
        sched = sp.wait_addr(300.0)
        s = ["--scheduler", sched]
        switches = cli_json("tasks", "list", *s)
        vols_view = cli_json("blob", "vols", "--clustermgr", cmgr)["volumes"]
        disks_view = cli_json("blob", "disks", "--clustermgr", cmgr)["disks"]
        nodes_view = cli_json("node", "list", *m)
        cli("cm", "config-set", "operators.smoke", "on", "--clustermgr", cmgr)
        config = cli_json("cm", "config-list", "--clustermgr", cmgr)
        mq = wait_for(lambda: cli_json("mq", "status", "--member", sched), "mq status")
        views = {name: cli_json("metrics", name, "--addr", addr) for name, addr in
                 (("codec", acc), ("repair", acc), ("integrity", acc))}
        write_path = [cli_json("metrics", "write-path", "--addr", a) for a in roles["metanode"]]
        wire = [cli_json("metrics", "wire", "--addr", a)
                for a in (*roles["metanode"], *roles["datanode"])]
        raw = cli("metrics", "raw", "--addr", acc)
        cases["views"] = {"switches": switches, "volumes": len(vols_view),
                          "disks": len(disks_view), "mq_topics": sorted(mq),
                          "codec": views["codec"], "write_path": write_path,
                          "wire_frames": [sum(w["frames"].values()) for w in wire]}
        checks["views_answer_json"] = (
            switches == {"disk_repair": False, "shard_repair": True, "blob_delete": True,
                         "balance": False, "rebalance": False, "volume_inspect": True,
                         "compact": False, "scrub": False}
            and {str(k) for k in blob_vols} <= set(vols_view)
            and len(disks_view) == BLOB_NODES * BLOB_DISKS
            and len(nodes_view["datanodes"]) == 4 and len(nodes_view["metanodes"]) == 3
            and "operators.smoke" in json.dumps(config) and sorted(mq) == ["delete", "repair"]
            and set(views["repair"]) >= {"bytes_pulled", "repair_tasks"}
            and set(views["integrity"]) >= {"detected", "healed", "scrub_items"})
        checks["views_count_the_traffic"] = (
            views["codec"].get("encode", {}).get("stripes_submitted", 0) >= objects
            and views["codec"]["steps_by_engine"].get("cuda", 0) > 0
            and sum(w["raft"]["wal_fsyncs"] for w in write_path) > 0
            and sum(sum(w["frames"].values()) for w in wire) > 0
            and LAUNCH_A in raw)

        # == 5. scrub run --full with planted bitflips ========================
        a0_sched = scrape(sched).get(LAUNCH_A, 0.0)
        disk_paths = {int(k): d["path"] for k, d in disks_view.items()}
        vids = sorted(blob_vols)
        bids = {vid: sorted(b for loc in locs for sl in loc["slices"] if sl["vid"] == vid
                            for b in range(sl["min_bid"], sl["min_bid"] + sl["count"]))
                for vid in vids}
        targets = [(vids[i % len(vids)], idx)
                   for i, idx in enumerate((2, 7, tac.n, tac.n + 3)[:bitflips])]
        planted = []
        for i, (vid, idx) in enumerate(targets):
            u = blob_vols[vid]["units"][idx]
            bid = bids[vid][(i // len(vids) * 3 + i) % len(bids[vid])]
            st, _, shard = rpc_post(u["node_addr"], "get_shard", {
                "disk_id": u["disk_id"], "chunk_id": u["chunk_id"], "bid": bid})
            if st != 200:
                raise AssertionError(f"get_shard before the flip: {st}")
            path, at = flip_shard_byte(disk_paths[u["disk_id"]], u["chunk_id"], shard)
            refused = rpc_post(u["node_addr"], "get_shard", {
                "disk_id": u["disk_id"], "chunk_id": u["chunk_id"], "bid": bid})[0]
            planted.append({"vid": vid, "unit": idx, "bid": bid, "disk": u["disk_id"],
                            "file": os.path.basename(path), "offset": at,
                            "read_after_flip": refused})
        checks["bitflips_refused_on_read"] = all(p["read_after_flip"] == 409 for p in planted)
        pass_bytes = staged(blob_vols)

        def scrub_pass(label: str) -> dict:
            a0 = scrape(sched).get(LAUNCH_A, 0.0)
            t = time.perf_counter()
            res = cli_json("scrub", "run", "--full", *s)["result"]
            secs = time.perf_counter() - t
            cases[label] = {"result": res, "seconds": secs, **pass_bytes,
                            "gib_s": pass_bytes["bytes"] / secs / 2**30,
                            "scheduler_a_launches": scrape(sched).get(LAUNCH_A, 0.0) - a0}
            return cases[label]
        rot = scrub_pass("scrub_rot_pass")
        queued = cli_json("tasks", "stats", *s)["tasks"]
        leased: dict[str, dict] = {}
        done: list[dict] = []
        wk = RepairWorker(rpc.Client(sched), rpc.Client(cmgr), rpc.NodePool(), engine="cuda",
                          device=dev)
        call = wk.sched.call

        def record(method, args=None, body=b"", timeout=30.0):
            meta, out = call(method, args, body, timeout)
            if method == "acquire_task" and meta.get("task"):
                leased[meta["task"]["task_id"]] = meta["task"]
            elif method == "complete_task":
                done.append(leased[args["task_id"]])
            return meta, out
        wk.sched.call = record
        a0, t = a_launches(), time.perf_counter()
        while wk.run_once():
            pass
        for task in done:  # the rebuilt units, written back to the clustermgr role
            st = rpc_post(cmgr, "update_volume_unit", {
                "vid": task["vid"], "index": task["unit_index"], "disk_id": task["dest_disk"],
                "chunk_id": task["dest_chunk"], "node_addr": task["dest_addr"]})[0]
            if st != 200:
                raise AssertionError(f"update_volume_unit: {st}")
        cases["scrub_repair"] = {"queued": queued, "tasks": [(d["vid"], d["unit_index"])
                                                             for d in done],
                                 "completed": wk.completed, "failed": wk.failed,
                                 "seconds": time.perf_counter() - t,
                                 "a_launches": a_launches() - a0}
        second = scrub_pass("scrub_second_pass")
        after = tiered_volumes(cmgr, locs)
        rebuilt = [after[p["vid"]]["units"][p["unit"]]["disk_id"] != p["disk"] for p in planted]
        blob_gets("blob_get_after_scrub")
        rot_vids = sorted({vid for vid, _ in targets})
        checks["scrub_finds_every_bitflip"] = (
            rot["result"]["completed_pass"] and rot["result"]["corrupt"] == len(rot_vids)
            and queued.get("pending", 0) == len(targets)
            and sorted((d["vid"], d["unit_index"]) for d in done) == sorted(targets))
        checks["scrub_rebuilds_every_bitflip"] = (
            wk.completed == len(targets) and wk.failed == 0 and all(rebuilt)
            and cases["scrub_repair"]["a_launches"] > 0)
        checks["scrub_second_pass_clean"] = (second["result"]["completed_pass"]
                                             and second["result"]["corrupt"] == 0)
        checks["scrub_launched_a_in_the_scheduler"] = (
            rot["scheduler_a_launches"] > 0 and second["scheduler_a_launches"] > 0)
        scheduler_a = scrape(sched).get(LAUNCH_A, 0.0) - a0_sched

        # == 6. fsck and the FS scrubber, in this process =====================
        pool = rpc.NodePool()
        fs = FileSystem(rpc.call(master, "client_view", {"name": "opsvol"})[0]["volume"], pool,
                        master_addr=master)
        clients.append(fs)
        live = [p for p in paths[:-1]]

        def fsck(label: str, **kw) -> dict:
            t = time.perf_counter()
            rep = fscklib.fsck(fs, pool, **kw)
            secs = time.perf_counter() - t
            cases[label] = {**rep.summary(), "seconds": secs,
                            "s_per_gib": secs / max(rep.bytes_checked, 1) * 2**30}
            return cases[label]

        def corrupt(path: str) -> tuple[int, int]:
            ek = fs.meta.inode_get(fs.resolve(path))["extents"][0]
            dp = fs.data._dp_by_id(ek["dp_id"])
            victim = next(a for a in dp["replicas"] if a != dp.get("leader"))
            st = rpc_post(victim, "write_replica", {"dp_id": ek["dp_id"],
                                                    "extent_id": ek["extent_id"],
                                                    "offset": 0}, b"\x00" * 10)[0]
            if st != 200:
                raise AssertionError(f"write_replica: {st}")
            return ek["dp_id"], ek["extent_id"]
        clean = fsck("fsck_clean")
        key = corrupt(live[0])
        found = fsck("fsck_mismatch")
        healed = fsck("fsck_heal", heal=True)
        again = fsck("fsck_after_heal")
        checks["fsck_clean"] = clean["clean"] and clean["files"] == len(live)
        checks["fsck_finds_and_heals_the_mismatch"] = (
            found["replica_mismatches"] == 1 and not found["clean"]
            and healed["healed_extents"] == 1 and again["clean"])
        key2 = corrupt(live[1])
        fscrub = FsScrubber(fs, pool)
        t = time.perf_counter()
        fpass = fscrub.run_full_pass()
        cases["fs_scrubber"] = {"result": fpass, "seconds": time.perf_counter() - t,
                                "healed": sorted(fscrub.healed)}
        checks["fs_scrubber_heals_the_second"] = (
            fpass["completed_pass"] and fpass["corrupt"] == 1 and fscrub.healed == {key2}
            and fsck("fsck_after_scrubber")["clean"] and key != key2)
        checks["fs_reads_equal_after_heals"] = all(fs.read_file(p) == payload[p] for p in live)

        # == 7. snapshot: export, verify, restore =============================
        snap, restored_dir = os.path.join(workdir, "snap"), os.path.join(workdir, "restored")
        t = time.perf_counter()
        manifest = snapshot.export(master, "opsvol", snap)
        verified = snapshot.verify(snap)
        pids = snapshot.restore(snap, restored_dir)
        digests = {}
        for mp in manifest["mps"]:
            vmp = next(x for x in fs.meta.mps if x["pid"] == mp["pid"])
            meta, live_state = rpc.call_replicas(pool, vmp.get("addrs") or [vmp["addr"]],
                                                 "export_state", {"pid": mp["pid"]},
                                                 deadline=10.0)
            part = MetaPartition(mp["pid"], mp["start"], mp["end"],
                                 data_dir=os.path.join(restored_dir, f"mp_{mp['pid']}"))
            digests[mp["pid"]] = (hashlib.sha256(live_state).hexdigest(),
                                  hashlib.sha256(part.export_state()[0]).hexdigest())
        cases["snapshot"] = {"seconds": time.perf_counter() - t, "mps": len(manifest["mps"]),
                             "restored": pids, "digests": digests}
        checks["snapshot_restores_the_live_state"] = (
            verified == manifest and sorted(pids) == sorted(mp["pid"] for mp in manifest["mps"])
            and len(pids) == 3 and all(a == b for a, b in digests.values()))

        # == 8. the dial prober and the blob bench ============================
        prober = dial.DialProber(rpc.Client(acc))
        probes = [prober.probe_once() for _ in range(3)]
        t = time.perf_counter()
        bench = bench_tool.run(rpc.Client(acc), size=bench_size, count=bench_count,
                               concurrency=bench_conc)
        cases["dial"] = {"probes": probes, "failures": prober.failures}
        cases["blob_bench"] = {**bench, "seconds": time.perf_counter() - t}
        checks["dial_probes_ok"] = all(probes) and prober.failures == 0
        checks["blob_bench_ok"] = bench["count"] == bench_count and bench["put_mbps"] > 0 \
            and bench["get_mbps"] > 0

        # == 9. bench_codec and tier_ab, in this process on the card ==========
        a0, t = a_launches(), time.perf_counter()
        ab = bench_codec.run_ab(submitters=submitters, iters=iters, device=dev)
        cases["bench_codec_run_ab"] = {**ab, "seconds": time.perf_counter() - t,
                                       "a_launches": a_launches() - a0}
        a0, t = a_launches(), time.perf_counter()
        rab = bench_codec.run_repair_ab(stripes=repair_stripes, device=dev)
        cases["bench_codec_repair_ab"] = {**rab, "seconds": time.perf_counter() - t,
                                          "a_launches": a_launches() - a0}
        checks["bench_codec_bit_identical"] = (ab["bit_identical"] and ab["equals_plain"]
                                               and rab["bit_identical"])
        checks["bench_codec_coalesces"] = (ab["mean_stripes_per_device_step"] or 0) > 1 \
            and cases["bench_codec_run_ab"]["a_launches"] > 0
        if tier_files is not None:
            saved_files, tier_ab.FILES = tier_ab.FILES, tier_files
        try:
            tmp = os.path.join(workdir, "tier_ab")
            a0, t = a_launches(), time.perf_counter()
            leg_a = tier_ab.leg_replicated(tmp, 13)
            leg_b = tier_ab.leg_tiered(tmp, 13, dev)
            leg_d = tier_ab.leg_digests(tmp, 13, dev)
            n_tier = tier_ab.FILES
        finally:
            if tier_files is not None:
                tier_ab.FILES = saved_files
            qos.DEFAULT._tracker, qos.DEFAULT._levels = Quiet(), {}
        cases["tier_ab"] = {"legs": [leg_a, leg_b, leg_d], "seconds": time.perf_counter() - t,
                            "savings_x": leg_a["ratio"] / leg_b["ratio"],
                            "a_launches": a_launches() - a0}
        checks["tier_ab_ratios_and_digests"] = (
            leg_b["transitioned"] == n_tier and 1.3 <= leg_b["ratio"] <= 2.0
            and 2.5 <= leg_a["ratio"] <= 3.5 and leg_d["identical"]
            and cases["tier_ab"]["a_launches"] >= n_tier)

        # == 3b. blob get with one blobnode process stopped ===================
        vols = tiered_volumes(cmgr, locs)
        stopped, blob_exit, lost = stop_a_blobnode(c, roles["blobnode"], vols, locs,
                                                   tac.n, tac.m)
        killed.add(stopped)
        blob_gets("blob_degraded_get")
        cases["degraded"] = {"stopped": stopped, "exit": blob_exit,
                             "blobs_lost_a_data_unit": lost}
        checks["degraded_launched_a_per_lost_blob"] = (
            lost > 0 and cases["blob_degraded_get"]["access_a_launches"] >= lost)
        launches = {"access_role": scrape(acc).get(LAUNCH_A, 0.0) - a0_access,
                    "scheduler_role": scheduler_a, "this_process": a_launches()}
    except BaseException:
        print(json.dumps({"phase": "operators", "failed_after": cases, "checks": checks},
                         default=str), file=sys.stderr, flush=True)
        raise
    finally:
        for fsx in clients:
            for cl in (*fsx.meta._packet_clients.values(), *fsx.data._packet_clients.values()):
                cl.close()
        codes = c.down()
        shutil.rmtree(workdir, ignore_errors=True)
        qos.DEFAULT._tracker, qos.DEFAULT._levels, qos.DEFAULT._last_refresh = gate
        for k, val in saved_env.items():
            if val is not None:
                os.environ[k] = val
    checks["every_role_exited_0"] = all(rc == 0 for name, rc in codes.items()
                                        if name not in killed)
    return {"phase": "operators", "card": card, "seconds": time.perf_counter() - t_phase,
            "startup_s": startup_s, "cli_calls": len(cli_calls),
            "cli_call_s": {"median": statistics.median(cli_calls), "max": max(cli_calls)},
            "cluster": {"roles": {r: len(a) for r, a in roles.items()}, "scheduler": 1,
                        "replicas": 3, "blob_size": blob_size, "codemode": blob_mode.name,
                        "files": files, "file_size": file_size, "objects": objects,
                        "object": obj_size, "volumes": len(blob_vols)},
            "planted": planted, "cases": cases, "exit_codes": codes, "launches": launches,
            "checks": checks}


def batcher_dp_phase(dev, card: str, *, shard: int = SHARD, b: int = DP_STRIPES) -> dict:
    """Phase ``batcher_dp``: the batcher's dp split (``codec/batcher.py``)
    on a step of ``b`` EC12P4 stripes of ``shard``-byte shards: an encode,
    and the reconstruct apply of shards 1 and 7 from the first 12
    survivors, each on both legs (device tensors under ``cuda``, host
    stripes under ``auto``, whose step must be served by the ``cuda``
    leg) through ``BatchCodec(devices=[dev, dev])``, and through
    ``devices=None`` too where two or more cards are visible. Every
    result is held against the plain version and against the unsplit
    step of a default ``BatchCodec`` (on one card it must not split);
    each split step must count one ``codec_batch_dp_steps{dp}`` and
    launch A once a block; a list naming a card that is not there must
    fail the step's future, on both legs. Launches count from 0.
    Returns the record with ``checks``."""
    import torch

    from cubefs_tpu_torch.codec import engine as engines
    from cubefs_tpu_torch.codec.batcher import BatchCodec
    from cubefs_tpu_torch.ops import _build, gf256, rs_kernel
    from cubefs_tpu_torch.utils import metrics

    t_phase = time.perf_counter()
    n, m = 12, 4
    cards = torch.cuda.device_count()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    x = torch.randint(0, 256, (b, n, shard), dtype=torch.uint8, device=dev, generator=gen)
    enc_rows = gf256.parity_matrix(n, m)
    present = [i for i in range(n + m) if i not in (1, 7)][:n]
    rec_rows = rs_kernel.reconstruct_rows(n, n + m, present, [1, 7])

    def plain(coeff, t):
        return rs_kernel.gf_apply_bits(torch.from_numpy(rs_kernel.coeff_bits(coeff)), t)

    parity = plain(enc_rows, x)
    surv = torch.cat([x, parity], dim=1)[:, present].contiguous()
    lost = x[:, [1, 7]].cpu().numpy()
    work = {"encode": (None, x, parity.cpu().numpy()),
            "apply": (rec_rows, surv, plain(rec_rows, surv).cpu().numpy())}
    host_in = {op: t.cpu().numpy() for op, (_, t, _) in work.items()}
    del parity
    _build.reset_launches()

    def step(bc, leg: str, op: str):
        coeff, t, _ = work[op]
        data = t if leg == "cuda" else host_in[op]
        if op == "encode":
            return bc.submit_encode_async(dev, data, m, engine=leg)
        return bc.submit_apply_async(dev, coeff, data, engine=leg)

    def dp_total() -> float:
        return sum(v for _, v in metrics.codec_batch_dp_steps.samples())

    cases, checks = [], {}
    plain_bc = BatchCodec(enabled=True)  # the default: every visible card
    if cards >= 2:
        plain_bc.dp_enabled = False  # would split: take the unsplit step
    runs = {"named_twice": [dev, dev]}
    if cards >= 2:
        runs["visible_cards"] = None
    for run, devices in runs.items():
        bc = BatchCodec(enabled=True, devices=devices)
        dp = min(len(bc.devices if devices is not None else range(cards)), b)
        for leg in ("cuda", "auto"):
            for op in ("encode", "apply"):
                want = work[op][2]
                before = (dp_total(), metrics.codec_batch_dp_steps.value(dp=dp),
                          _build.LAUNCHES["gf_apply"],
                          metrics.codec_batch_steps.value(op=op, engine="cuda"))
                t = time.perf_counter()
                got = step(bc, leg, op).result()
                got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
                ms = (time.perf_counter() - t) * 1e3
                split = (dp_total() - before[0], metrics.codec_batch_dp_steps.value(dp=dp)
                         - before[1], _build.LAUNCHES["gf_apply"] - before[2],
                         metrics.codec_batch_steps.value(op=op, engine="cuda") - before[3])
                served = engines.last_dispatch["served"] if leg == "auto" else "cuda"
                before_plain = (dp_total(), _build.LAUNCHES["gf_apply"])
                ref = step(plain_bc, leg, op).result()
                ref = ref.cpu().numpy() if isinstance(ref, torch.Tensor) else ref
                unsplit = (dp_total() - before_plain[0], _build.LAUNCHES["gf_apply"]
                           - before_plain[1])
                case = f"{run}.{leg}.{op}"
                cases.append({"case": case, "dp": dp, "B": b, "S": shard, "ms": ms,
                              "served": served, "dp_steps": split[1], "launches": split[2],
                              "unsplit_launches": unsplit[1]})
                checks.update({
                    f"{case}.equals_plain": bool(np.array_equal(got, want)),
                    f"{case}.equals_unsplit_step": bool(np.array_equal(got, ref)),
                    f"{case}.served_cuda": served == "cuda" and split[3] == 1,
                    f"{case}.one_dp_step": split[0] == split[1] == 1,
                    f"{case}.a_launched_once_a_block": split[2] == dp,
                    f"{case}.default_did_not_split": unsplit == (0, 1),
                })
                if op == "apply":
                    checks[f"{case}.rebuilt_lost_shards"] = bool(np.array_equal(got, lost))
                del got, ref
    missing = torch.device("cuda", cards)
    bad = BatchCodec(enabled=True, devices=[dev, missing])
    refused = {}
    for leg in ("cuda", "auto"):
        before = (dp_total(), _build.LAUNCHES["gf_apply"])
        try:
            step(bad, leg, "encode").result()
            refused[leg] = None
        except RuntimeError as e:
            refused[leg] = str(e)[:200]
        checks[f"missing_card.{leg}.future_raised"] = (
            refused[leg] is not None and (dp_total(), _build.LAUNCHES["gf_apply"]) == before)
    launches = dict(_build.LAUNCHES)
    checks["launched_only_gf_apply"] = launches["gf_apply"] > 0 and all(
        v == 0 for k, v in launches.items() if k != "gf_apply")
    del x, surv, work, host_in
    torch.cuda.synchronize()
    return {"phase": "batcher_dp", "card": card, "runs": list(runs), "cards": cards,
            "missing_card": str(missing), "refused": refused, "cases": cases,
            "launches": launches, "seconds": time.perf_counter() - t_phase, "checks": checks}


def fs_bench_checks(name: str, rc, out) -> dict[str, bool]:
    """One tool run's checks, from its own fields. The mdtest/fio run, the
    wire A/B and the build check must exit 0. The split and geo A/Bs exit
    1 when their speed verdict (a timing A/B) fails as well as when their
    identity does: there the checks are the identity fields, the legs'
    errors, and an exit code that agrees with the summary's verdict (a run
    that died prints no record)."""
    if out is None:
        return {"printed_a_record": False}
    if name == "mdtest_fio":
        return {"exit_0": rc == 0, "keys": list(out) == list(MDTEST_KEYS),
                "rates_above_0": all(out.get(k, 0) > 0 for k in MDTEST_KEYS)}
    if name == "wire_ab":
        s = out["summary"]
        return {"exit_0": rc == 0, "fsm_digest_identical": s["fsm_digest_identical"],
                "blob_bytes_identical": s["blob_bytes_identical"],
                "abba": [leg["mux"] for leg in out["legs"]] == [True, False, False, True]}
    if name == "split_ab":
        s = out["summary"]
        return {"exit_agrees_with_verdict": rc == (0 if s["ok"] else 1),
                "door_off_identical": s["door_off_identical"],
                "identity_bit_identical": out["identity"]["bit_identical"],
                "sweeps_inert": out["identity"]["sweeps_inert"],
                # a create whose client table still names a partition the
                # sweep merged away answers this 404 until the client
                # re-reads its view, in both packages; any other error fails
                "leg_errors_only_merged_away_404": all(
                    re.search(r"RpcError: rpc 404: meta partition \d+ not on node \d+$", e)
                    for leg in [*(x for legs in out["legs"].values() for x in legs),
                                out["static64_ceiling"], out["loadgen_probe"]]
                    for e in leg["errors"])}
    if name == "geo_ab":
        s, lag, off = out["summary"], out["steady_lag"], out["geo_off_digest"]
        return {"exit_agrees_with_verdict": rc == (0 if s["ok"] else 1),
                "geo_off_identical": off["geo_off_identical"],
                "follower_converged": off["follower_converged"],
                "lag_drained": lag["drained"], "lag_digests_converged": lag["digests_converged"],
                "lag_no_gaps": lag["counters"]["gap"] == 0,
                "mutation_bounced_452": out["follower_read"]["mutation_bounced_452"]}
    from cubefs_tpu_torch.ops import _build

    built = {k["symbol"]: k for k in out["kernels"]}
    return {"exit_0": rc == 0, "all_ok": out["all_ok"], "target_sm_90a": out["target"] == "sm_90a",
            **{f"{sym}_compiled": sym in built and built[sym]["compiled"]
               and built[sym]["max_registers"] > 0 and built[sym]["cubin_bytes"] > 0
               for sym in _build.SYMBOLS}}


def fs_bench_phase(card: str, *, runs=FS_BENCH_RUNS, timeout: float = 300.0) -> dict:
    """Phase ``fs_bench``: the port's file-system benchmark harness
    (``tool/bench_fs.py``) and the sm_90a build check (``tool/aot_cuda.py``),
    each ``python -m`` in a process of its own, as their users run them
    (the harness forks client and server processes, which a process that
    has initialised CUDA must not do; neither tool imports torch). Each
    child gets a temporary directory of its own as ``TMPDIR``, removed
    after it. Returns the record: per run its arguments, exit code,
    seconds and printed JSON (the build check's without its per-entry
    ptxas figures), and ``checks`` (``fs_bench_checks``)."""
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    rec: dict = {"phase": "fs_bench", "card": card, "runs": {}, "checks": {}}
    for name, module, args in runs:
        tmp = tempfile.mkdtemp(prefix=f"smoke-fsbench-{name}-")
        argv = [sys.executable, "-m", module, *args]
        env = {**os.environ, "TMPDIR": tmp}
        if module.endswith("aot_cuda"):
            argv += ["--out-dir", os.path.join(tmp, "aot_sm90a")]
        t0 = time.perf_counter()
        proc = subprocess.Popen(argv, cwd=root, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, start_new_session=True)
        try:
            stdout, stderr = proc.communicate(timeout=timeout)
            rc = proc.returncode
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)  # the tool and the processes it forked
            stdout, stderr = proc.communicate()
            rc = None
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        try:
            out = json.loads(stdout)
        except ValueError:
            out = None
        run = {"argv": argv[1:], "rc": rc, "seconds": time.perf_counter() - t0, "result": out}
        if rc != 0:
            run["stderr_tail"] = stderr[-2000:]
        if out is not None and name == "aot_cuda":
            run["result"] = {**out, "kernels": [{k: v for k, v in kern.items() if k != "entries"}
                                                for kern in out["kernels"]]}
        rec["runs"][name] = run
        rec["checks"].update({f"{name}.{k}": bool(v)
                              for k, v in fs_bench_checks(name, rc, out).items()})
    rec["seconds"] = time.perf_counter() - t_phase
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    watch = Watchdog(PHASE_BUDGETS, SCRIPT_BUDGET)
    watch.arm("build")  # the imports below included
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from cubefs_tpu_torch.codec import codemode as cm
    from cubefs_tpu_torch.codec import crc32block
    from cubefs_tpu_torch.codec import hostio
    from cubefs_tpu_torch.codec.batcher import AdmittedEngine, BatchCodec
    from cubefs_tpu_torch.codec.encoder import CodecConfig, new_encoder
    from cubefs_tpu_torch.codec.engine import CudaEngine
    from cubefs_tpu_torch.models import repair
    from cubefs_tpu_torch.ops import (_build, crc32_kernel, crc_cuda, gf256, gf_bitmajor,
                                      gf_cuda, rs_kernel)
    from cubefs_tpu_torch.parallel import dryrun, launch
    from cubefs_tpu_torch.tuning import gf_tuning
    # the least time of a function (bytes over the HBM rate, operations over
    # the int8 peak) and ptxas' report, shared with the build check
    from cubefs_tpu_torch.tool.aot_cuda import (HBM_BYTES_PER_S, INT8_OPS_PER_S,
                                               bound, ptxas_registers)
    from cubefs_tpu_torch.utils import trace as tracelib
    from cubefs_tpu_torch.utils.benchtime import device_ms, kernel_ms
    from cubefs_tpu_torch.utils.benchtime import timed_ms as time_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    rng = np.random.default_rng(SEED)

    def rand(*shape) -> torch.Tensor:
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)

    def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0

    # -- 1. build --------------------------------------------------------
    # The three kernel sources (nvcc, in parallel) and, beside them, the
    # host libraries later phases load (g++, one thread each), all at once.
    from cubefs_tpu_torch.blob import chunkstore
    from cubefs_tpu_torch.ops import gfcpu
    from cubefs_tpu_torch.runtime import fsnative, kvstore, nativeclient

    t0 = time.perf_counter()
    host_builds = {"gfcpu": gfcpu.build, **{
        mod.__name__.rsplit(".", 1)[1]: functools.partial(
            _build.build_host, mod.lib_path(), mod.SOURCES, mod.__name__)
        for mod in (chunkstore, fsnative, kvstore, nativeclient)}}
    with ThreadPoolExecutor(len(host_builds)) as pool:
        host_futs = {name: pool.submit(fn) for name, fn in host_builds.items()}
        build_s = _build.build()
        host_libs = {name: os.path.basename(f.result()) for name, f in host_futs.items()}
    ptxas = {}
    for name in build_s:  # one library per source
        log = _build.log_path(name)
        if os.path.exists(log):
            with open(log) as f:
                ptxas[name] = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "per_kernel_s": {k: round(v, 3) for k, v in build_s.items()}, "host_libs": host_libs,
          "ptxas": ptxas, "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0)})

    watch.arm("gf_apply")
    # -- 2. gf_apply vs plain ------------------------------------------------
    # ms is the whole wrapper call between CUDA events; device_ms the
    # kernel's own time from the profiler's CUDA trace (host excluded),
    # and bound_share is taken from device_ms.
    n, m = 12, 4
    plan = repair.make_plan(n, m, [1, 7])
    step_rows = repair._step_rows(plan)  # recovery + extra-survivor rows, as repair_step applies them
    surviving = rand(4, len(plan.present), SHARD)
    in_place = rand(8, n + m, SHARD)  # encode straight into the stripes' parity rows
    unaligned = rand(3 * (SHARD + 5) + 1)[1:].view(3, 1, SHARD + 5)  # base 1 byte off
    # the LRC and MSR families' shapes of A, each in place where the codec writes in place
    lrc_enc = new_encoder(CodecConfig(cm.CodeMode.EC16P20L2))
    lrc_gf = rand(4, lrc_enc.t.total, SHARD)
    msr_t = cm.tactic(cm.CodeMode.EC6P6MSR)
    msr_k, msr_total, msr_d, alpha = msr_t.n, msr_t.total, msr_t.d, msr_t.alpha
    msr_s = new_encoder(CodecConfig(cm.CodeMode.EC6P6MSR)).shard_size(MSR_PAYLOAD)
    beta = msr_s // alpha
    msr_gf = rand(4, msr_total, msr_s)
    repair_helpers = tuple(range(1, msr_total))
    blob_s = -(-BLOB // n)
    svc_rows = rs_kernel.reconstruct_rows(n, n + m, list(plan.present), [1, 7])
    blob_degraded_rows = rs_kernel.reconstruct_rows(n, n + m, list(range(2, n + 2)), [0, 1])
    blob_solve = [i for i in range(n + m) if i != 2]
    blob_repair_rows = rs_kernel.reconstruct_rows(n, n + m, blob_solve[:n], [2, blob_solve[n]])
    gf_cases = [  # (label, coeff, shards, out)
        ("repair_rs12p4_bad1_7_B4", step_rows, surviving[:, :n, :], None),
        ("encode_rs12p4_B8", gf256.parity_matrix(n, m), rand(8, n, SHARD), None),
        ("encode_rs12p4_in_place_B8", gf256.parity_matrix(n, m), in_place[:, :n],
         in_place[:, n:]),
        ("encode_rs12p4_ragged_B2", gf256.parity_matrix(n, m), rand(2, n, SHARD + 123), None),
        ("random_36x36_B1", rng.integers(0, 256, (36, 36), dtype=np.uint8), rand(1, 36, SHARD),
         None),
        ("one_row_one_col_ragged_unaligned_B3", rng.integers(1, 256, (1, 1), dtype=np.uint8),
         unaligned, None),
        ("lrc_rows_22x16_EC16P20L2_in_place_B4", lrc_enc._encode_rows, lrc_gf[:, :16],
         lrc_gf[:, 16:]),
        ("msr_encode_36x36_EC6P6MSR_in_place_B4",
         rs_kernel.msr_encode_rows(msr_k, msr_total, msr_d),
         rs_kernel.msr_subshards(msr_gf[:, :msr_k], alpha),
         rs_kernel.msr_subshards(msr_gf[:, msr_k:], alpha)),
        ("msr_helper_1x6_every_node_B4", rs_kernel.msr_helper_rows(msr_k, msr_total, msr_d, 0),
         msr_gf.view(4, msr_total, alpha, beta), None),
        ("msr_repair_6x11_B4",
         rs_kernel.msr_repair_rows(msr_k, msr_total, msr_d, 0, repair_helpers),
         rand(4, msr_d, beta), None),
        # phase service's shapes: 8 MiB blobs (S = 699,051, byte loads) over
        # the HTTP body, 4 MiB shards through /dev/shm; encode, and the rows
        # of shards 1 and 7 for reconstruct
        ("service_encode_S699051_B4", gf256.parity_matrix(n, m), rand(4, n, blob_s), None),
        ("service_reconstruct_2x12_S699051_B4", svc_rows, rand(4, n, blob_s), None),
        ("service_encode_shm_B4", gf256.parity_matrix(n, m), rand(4, n, SHARD), None),
        ("service_reconstruct_shm_2x12_B4", svc_rows, rand(4, n, SHARD), None),
        # phase blob's shapes (measured here: profiler sessions late in the
        # process lose records): a 64 MiB PUT's stack of eight 8 MiB blobs,
        # a degraded blob's rows of shards 0 and 1, a repair batch's rows
        # of the lost unit 2 and the extra survivor 13 over 8 bids
        ("blob_put_EC12P4_S699051_B8", gf256.parity_matrix(n, m), rand(8, n, blob_s), None),
        ("blob_degraded_2x12_S699051_B1", blob_degraded_rows, rand(1, n, blob_s), None),
        ("blob_repair_2x12_S699051_B8", blob_repair_rows, rand(8, n, blob_s), None),
    ]
    coeff_36x36 = gf_cases[4][1]
    gf_results = []
    for label, coeff, x, out in gf_cases:
        r, c = coeff.shape
        s = x.shape[-1]
        b = x.numel() // (c * s)
        w = torch.from_numpy(rs_kernel.coeff_bits(coeff))
        call = functools.partial(gf_cuda.gf_apply, coeff, x, out=out)
        x_before = x.clone() if out is not None else None
        got = call()
        want = rs_kernel.gf_apply_bits(w, x)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        if out is not None:  # written in place, the input rows untouched
            equal = equal and got is out and bool(torch.equal(x, x_before))
        err = max_abs_err(got, want)
        del got, want, x_before
        ms = time_ms(call, KERNEL_REPS)
        dev_ms = device_ms(call, KERNEL_REPS, "gf_apply_kernel")
        plain_ms = time_ms(lambda: rs_kernel.gf_apply_bits(w, x), PLAIN_REPS)
        nbytes = (c + r) * s * b
        bound_ms, bound_by = bound(nbytes, 2 * r * c * s * b)
        res = {"case": label, "R": r, "C": c, "B": b, "S": s, "out_view": out is not None,
               "equal": equal, "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "gib_s": nbytes / (dev_ms / 1e3) / 2**30, "bound_share": bound_ms / dev_ms}
        gf_results.append(res)
        if not equal:
            raise AssertionError(f"gf_apply disagrees with its plain version: {res}")
    emit({"phase": "gf_apply", "seconds": watch.elapsed(), "cases": gf_results})
    del surviving, gf_cases, in_place, unaligned, lrc_gf, msr_gf

    watch.arm("crc32_blocks")
    # -- 3. crc32_blocks vs plain and zlib -------------------------------
    frame_rows = rand(512, 4, 64 << 10)  # blob frames: payloads 4 bytes into their blocks
    crc_cases = [  # (label, blocks)
        ("blocks_10000x128KiB", rand(10000, 128 << 10)),
        ("blob_payloads_2048x65532", rand(2048, (64 << 10) - 4)),
        ("repair_shards_8x4MiB", rand(8, SHARD)),
        ("frame_payload_views_512x4x65532", frame_rows[:, :, 4:]),
        ("odd_blocks_1000x1001", rand(1000, 1001)),
        ("short_blocks_4096x15", rand(4096, 15)),
        ("service_blocks_1024x128KiB", rand(1024, 128 << 10)),
    ]
    crc_results = []
    for label, blocks in crc_cases:
        block_len = blocks.shape[-1]
        b = blocks.numel() // block_len
        got = crc_cuda.crc32_blocks(blocks)
        want = crc32_kernel.crc32_blocks_plain(blocks)
        equal = bool(torch.equal(got, want))
        rows = np.sort(rng.choice(b, size=min(b, 256), replace=False))
        host = blocks.reshape(b, block_len)[torch.from_numpy(rows).to(dev)].cpu().numpy()
        got_rows = got.reshape(b).cpu().numpy()[rows]
        zlib_equal = all(int(g) == zlib.crc32(row.tobytes()) for g, row in zip(got_rows, host))
        err = max_abs_err(got, want)
        del got, want, host
        call = functools.partial(crc_cuda.crc32_blocks, blocks)
        ms = time_ms(call, KERNEL_REPS)
        dev_ms = device_ms(call, KERNEL_REPS, "crc32_span_kernel")
        plain_ms = time_ms(lambda: crc32_kernel.crc32_blocks_plain(blocks), PLAIN_REPS)
        span = crc_cuda.plan(block_len)
        nbytes = b * block_len + 4 * b
        bound_ms, bound_by = bound(nbytes, 2 * b * block_len)
        res = {"case": label, "B": b, "block_len": block_len, "rows": span.rows,
               "n_spans": span.n_spans, "strides": list(blocks.stride()),
               "equal": equal, "zlib_rows_checked": int(len(rows)), "zlib_equal": zlib_equal,
               "max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "gb_s": nbytes / (dev_ms / 1e3) / 1e9, "bound_share": bound_ms / dev_ms}
        crc_results.append(res)
        if not (equal and zlib_equal):
            raise AssertionError(f"crc32_blocks disagrees: {res}")
    emit({"phase": "crc32_blocks", "seconds": watch.elapsed(), "cases": crc_results})
    del crc_cases, frame_rows
    torch.cuda.empty_cache()

    watch.arm("gf_bitmajor")
    # -- 4. gf_bitmajor / gf_bitmajor_probe (kernels C, D) vs plain ------
    # Every instantiation: extraction x grid for the apply and nodot, grid
    # for noext (it extracts nothing). The bound is the function's, as for
    # gf_apply; mma_floor_ms is the bit-matrix form's own int8 work,
    # 2 * 8R * 8C * S * B at the int8 peak, which is not a bound. device_ms
    # for the bcast/flat apply and probes of every case and the recorded
    # instantiations; beside each, ptxas' registers of its template
    # instantiation and the blocks an SM holds (the persistent grid is that
    # times the SMs).
    tile = gf_bitmajor.DEFAULT_TILE
    bm_regs = ptxas_registers(_build.log_path("gf_bitmajor"))
    bm_x = rand(4, n, SHARD)
    bm_cases = [
        ("tuning_rows_2x12_B4", np.ascontiguousarray(plan.rows, dtype=np.uint8), bm_x),
        ("repair_step_rows_4x12_B4", step_rows, bm_x),
        ("step_rows_ragged_B2", step_rows, rand(2, n, SHARD + 123)),
        ("random_36x36_B1", coeff_36x36, rand(1, 36, SHARD)),
    ]
    bm_results, bm_bad = [], []
    for label, coeff, x in bm_cases:
        r, c = coeff.shape
        b, s = x.shape[0], x.shape[-1]
        nbytes = (c + r) * s * b
        bound_ms, bound_by = bound(nbytes, 2 * r * c * s * b)
        mma_floor_ms = 2 * 8 * r * 8 * c * s * b / INT8_OPS_PER_S * 1e3
        for probe in (None, "nodot", "noext"):
            want = gf_bitmajor.plain(coeff, x, probe)
            plain_ms = time_ms(lambda: gf_bitmajor.plain(coeff, x, probe), PLAIN_REPS)
            extracts = ("bcast",) if probe == "noext" else ("loop", "bcast", "bool")
            for extract, grid in itertools.product(extracts, gf_bitmajor.GRIDS):
                kw = {"tile": tile, "extract": extract, "grid": grid}
                fn = (functools.partial(gf_bitmajor.bitmajor_apply, coeff, x, **kw)
                      if probe is None else
                      functools.partial(gf_bitmajor.bitmajor_probe, coeff, x, probe=probe, **kw))
                got = fn()
                torch.cuda.synchronize()
                equal = bool(torch.equal(got, want))
                err = max_abs_err(got, want)
                del got
                ms = time_ms(fn, KERNEL_REPS)
                e, p = gf_bitmajor.EXTRACTS[extract], gf_bitmajor.PROBES.get(probe, 0)
                res = {"case": label, "kernel": "gf_bitmajor_probe" if probe else "gf_bitmajor",
                       "extract": extract, "grid": grid, "probe": probe, "tile": tile,
                       "R": r, "C": c, "B": b, "S": s, "equal": equal, "max_abs_err": err,
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "mma_floor_ms": mma_floor_ms,
                       "gib_s": nbytes / (ms / 1e3) / 2**30, "bound_share": bound_ms / ms,
                       "registers": next((v for k, v in bm_regs.items()
                                          if f"gf_bitmajor_kernelILi{e}ELi{p}EE" in k), None),
                       "blocks_per_sm": gf_bitmajor.blocks_per_sm(r, c, tile, extract, probe),
                       "ring_stages": gf_bitmajor.ring_stages(r, c, tile),
                       "smem_bytes": gf_bitmajor.smem_bytes(r, c, tile)}
                if ((extract, grid) == ("bcast", "flat")
                        or (label, extract, probe, grid) in RECORDED_BM):
                    res["device_ms"] = device_ms(fn, KERNEL_REPS, "gf_bitmajor")
                    res["device_bound_share"] = bound_ms / res["device_ms"]
                bm_results.append(res)
                if not equal:
                    bm_bad.append(res)
            del want
    emit({"phase": "gf_bitmajor", "seconds": watch.elapsed(), "cases": bm_results})
    if bm_bad:
        raise AssertionError(f"bit-matrix kernels disagree with their plain versions: {bm_bad}")
    del bm_x, bm_cases
    torch.cuda.empty_cache()

    watch.arm("main_path")
    # -- 5. the main path, through the entry points --------------------------
    _build.reset_launches()
    t_main = time.perf_counter()
    path = {}

    enc = new_encoder(CodecConfig(cm.CodeMode.EC12P4))
    payload = rng.integers(0, 256, 48 * MIB, dtype=np.uint8).tobytes()
    stripe = enc.split(payload)
    enc.encode(stripe)
    golden = stripe.clone()
    stripe[1] = 0
    stripe[7] = 0
    enc.reconstruct(stripe, [1, 7])
    path["encoder_shape"] = list(stripe.shape)
    path["encoder_verify"] = enc.verify(stripe)
    path["encoder_roundtrip"] = bool(torch.equal(stripe, golden)) and enc.join(
        stripe, len(payload)) == payload
    del stripe, golden

    with open(os.path.join(root, "tests", "fixtures", "rs12p4.bin"), "rb") as f:
        fixture = np.frombuffer(f.read(), dtype=np.uint8).reshape(16, 512)
    fx = torch.zeros((16, 512), dtype=torch.uint8, device=dev)
    fx[:n] = torch.from_numpy(fixture[:n].copy()).to(dev)
    enc.encode(fx)
    path["fixture_parity"] = bool(np.array_equal(fx.cpu().numpy(), fixture))
    fx[[1, 7, 14]] = 0
    enc.reconstruct(fx, [1, 7, 14])
    path["fixture_reconstruct"] = bool(np.array_equal(fx.cpu().numpy(), fixture))

    data = rand(4, n, SHARD)
    stripes = torch.cat([data, enc.engine.encode_parity(data, m)], dim=1)
    surviving = stripes[:, list(plan.present)].contiguous()
    recovered, crcs, ok = repair.repair_step(plan, surviving)
    lost = data[:, [1, 7]].cpu().numpy()
    crcs_host = crcs.cpu().numpy()
    path["repair_recovered"] = bool(torch.equal(recovered, data[:, [1, 7]]))
    path["repair_crcs_zlib"] = all(
        int(crcs_host[i, j]) == zlib.crc32(lost[i, j].tobytes())
        for i in range(lost.shape[0]) for j in range(lost.shape[1]))
    path["repair_ok"] = ok.tolist()
    surviving[2, n + 1, 12345] ^= 0x5A  # bit-rot in an extra survivor of stripe 2
    _, _, ok_bad = repair.repair_step(plan, surviving)
    path["repair_ok_corrupt"] = ok_bad.tolist()
    del data, stripes, surviving, recovered, lost

    frames = np.stack([
        np.frombuffer(crc32block.encode(rng.integers(0, 256, 4 * ((64 << 10) - 4),
                                                     dtype=np.uint8).tobytes()), np.uint8)
        for _ in range(64)])
    frames[5, 3 * (64 << 10) + 100] ^= 1  # a payload byte of frame 5's last block
    valid = crc32block.verify_batch(torch.from_numpy(frames).to(dev)).tolist()
    path["frames_valid"] = valid
    torch.cuda.synchronize()
    path["seconds"] = time.perf_counter() - t_main
    path["launches"] = dict(_build.LAUNCHES)
    emit({"phase": "main_path", **path})

    checks = {
        "encoder_verify": path["encoder_verify"],
        "encoder_roundtrip": path["encoder_roundtrip"],
        "fixture_parity": path["fixture_parity"],
        "fixture_reconstruct": path["fixture_reconstruct"],
        "repair_recovered": path["repair_recovered"],
        "repair_crcs_zlib": path["repair_crcs_zlib"],
        "repair_ok": path["repair_ok"] == [True] * 4,
        "repair_detects_corrupt": path["repair_ok_corrupt"] == [True, True, False, True],
        "frames": valid == [i != 5 for i in range(64)],
        "launched_both_kernels": all(_build.LAUNCHES[k] > 0 for k in MAIN_KERNELS),
        "no_bitmajor_kernel_on_main_path": all(
            v == 0 for k, v in _build.LAUNCHES.items() if k not in MAIN_KERNELS),
    }
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"main path checks failed: {failed}")
    launches = dict(_build.LAUNCHES)

    def plain(coeff: np.ndarray, x: torch.Tensor) -> torch.Tensor:
        return rs_kernel.gf_apply_bits(torch.from_numpy(rs_kernel.coeff_bits(coeff)), x)

    def only_gf_apply(counts: dict[str, int]) -> bool:
        return counts["gf_apply"] > 0 and all(v == 0 for k, v in counts.items() if k != "gf_apply")

    watch.arm("codec_families")
    # -- 6. the LRC and MSR codec families, through the entry points --------
    # Every result is held against the plain version on the same inputs, or
    # against stripes that were; any mismatch fails the run.
    _build.reset_launches()
    t_fam = time.perf_counter()
    fam = {}

    # EC16P20L2 (two AZs): 4 stripes of 4 MiB shards from 64 MiB payloads
    lt = lrc_enc.t
    lrc_payloads = rand(4, lt.n * SHARD)
    lrc = torch.stack([lrc_enc.split(p) for p in lrc_payloads])
    before = _build.LAUNCHES["gf_apply"]
    lrc_enc.encode(lrc)
    fam["lrc_encode_launches"] = _build.LAUNCHES["gf_apply"] - before
    fam["lrc_encode_plain"] = bool(torch.equal(
        lrc[:, lt.n:], plain(lrc_enc._encode_rows, lrc[:, :lt.n])))
    fam["lrc_verify"] = lrc_enc.verify(lrc)
    lrc_golden = lrc.clone()
    bad = [1, 7, lt.n + lt.m]  # two data shards and AZ 0's local parity
    lrc[:, bad] = 0
    fam["lrc_verify_damaged"] = lrc_enc.verify(lrc)
    lrc_enc.reconstruct(lrc, bad)
    fam["lrc_reconstruct"] = bool(torch.equal(lrc, lrc_golden))
    fam["lrc_join"] = lrc_enc.join(lrc[0], lt.n * SHARD) == lrc_payloads[0].cpu().numpy().tobytes()
    idx, _, _ = lt.local_stripe_in_az(1)
    local = lrc_golden[:, idx].clone()  # a bare local stripe, one shard lost
    local[:, 3] = 0
    lrc_enc.reconstruct(local, [3])
    fam["lrc_local_stripe_repair"] = (bool(torch.equal(local, lrc_golden[:, idx]))
                                      and lrc_enc.verify(local))
    rows = lrc_golden[:, : lt.n + lt.m].clone()  # the degraded GET's (N+M) rows
    rows[:, [0, lt.n - 1]] = 0
    lrc_enc.reconstruct_data(rows, [0, lt.n - 1])
    fam["lrc_reconstruct_data_global_rows"] = bool(torch.equal(rows, lrc_golden[:, : lt.n + lt.m]))
    del lrc, lrc_golden, local, rows, lrc_payloads
    with open(os.path.join(root, "tests", "fixtures", "ec16p20l2.bin"), "rb") as f:
        lrc_fixture = np.frombuffer(f.read(), dtype=np.uint8).reshape(lt.total, 512)
    fx = torch.zeros((lt.total, 512), dtype=torch.uint8, device=dev)
    fx[: lt.n] = torch.from_numpy(lrc_fixture[: lt.n].copy()).to(dev)
    lrc_enc.encode(fx)
    fam["lrc_fixture_parity"] = bool(np.array_equal(fx.cpu().numpy(), lrc_fixture))

    # EC6P6MSR (three AZs, d = 11): 4 stripes from 24 MiB payloads
    msr_enc = new_encoder(CodecConfig(cm.CodeMode.EC6P6MSR))
    msr_payloads = rand(4, MSR_PAYLOAD)
    msr = torch.stack([msr_enc.split(p) for p in msr_payloads])
    before = _build.LAUNCHES["gf_apply"]
    msr_enc.encode(msr)
    fam["msr_encode_launches"] = _build.LAUNCHES["gf_apply"] - before
    fam["msr_shard"] = [msr_s, beta]
    fam["msr_encode_plain"] = bool(torch.equal(
        rs_kernel.msr_subshards(msr[:, msr_k:], alpha),
        plain(rs_kernel.msr_encode_rows(msr_k, msr_total, msr_d),
              rs_kernel.msr_subshards(msr[:, :msr_k], alpha))))
    fam["msr_verify"] = msr_enc.verify(msr)
    msr_golden = msr.clone()
    msr_bad = sorted(rng.choice(msr_total, msr_total - msr_k, replace=False).tolist())
    msr[:, msr_bad] = 0
    msr_enc.reconstruct(msr, msr_bad)
    fam["msr_reconstruct_bad"] = msr_bad
    fam["msr_reconstruct"] = bool(torch.equal(msr, msr_golden))
    fam["msr_join"] = all(msr_enc.join(msr[i], MSR_PAYLOAD)
                          == msr_payloads[i].cpu().numpy().tobytes() for i in range(4))
    del msr, msr_payloads

    def repair_every_slot(enc_, stripes: torch.Tensor, with_verify: bool) -> dict[str, bool]:
        """Each slot lost in turn: d helper symbols (one apply of the
        helper row over every node) rebuild it through msr_repair_shard;
        with an extra survivor, its verify row predicts that survivor's
        symbol, and one corrupted helper symbol must break the prediction
        of its stripe only."""
        t = enc_.t
        b_, s_ = stripes.shape[0], stripes.shape[-1]
        nodes = stripes.view(b_, t.total, t.alpha, s_ // t.alpha)
        out = {"rebuilt": True, "plain": True, "predicted": True, "corrupt_caught": True}
        for failed in range(t.total):
            order = [i for i in range(t.total) if i != failed]
            helpers = tuple(order[: t.d])
            row = rs_kernel.msr_helper_rows(t.n, t.total, t.d, failed)
            syms = rs_kernel.gf_matrix_apply(row, nodes)[:, :, 0]
            payloads = syms[:, list(helpers)]
            rebuilt = rs_kernel.msr_repair_shard(payloads, t.n, t.total, t.d, failed, helpers)
            out["rebuilt"] &= bool(torch.equal(rebuilt, stripes[:, failed]))
            rep = rs_kernel.msr_repair_rows(t.n, t.total, t.d, failed, helpers)
            out["plain"] &= (bool(torch.equal(syms, plain(row, nodes)[:, :, 0]))
                             and bool(torch.equal(rebuilt, plain(rep, payloads).view(b_, s_))))
            if with_verify:
                extra = order[t.d]
                vrow = rs_kernel.msr_verify_rows(t.n, t.total, t.d, failed, helpers, extra)
                pred = rs_kernel.gf_matrix_apply(vrow, payloads)[:, 0]
                out["predicted"] &= (bool(torch.equal(pred, syms[:, extra]))
                                     and bool(torch.equal(pred, plain(vrow, payloads)[:, 0])))
                payloads[2, failed % t.d, (s_ // t.alpha) // 2] ^= 0x5A
                pred = rs_kernel.gf_matrix_apply(vrow, payloads)[:, 0]
                out["corrupt_caught"] &= [bool(torch.equal(pred[i], syms[i, extra]))
                                          for i in range(b_)] == [True, True, False, True]
        return out

    fam["msr_repair_EC6P6MSR_d11"] = repair_every_slot(msr_enc, msr_golden, False)
    del msr_golden
    one_az_enc = new_encoder(CodecConfig(cm.CodeMode.EC6P6MSROneAZ))
    one_az = torch.stack([one_az_enc.split(p) for p in rand(4, MSR_PAYLOAD)])
    one_az_enc.encode(one_az)
    fam["msr_repair_EC6P6MSROneAZ_d10"] = repair_every_slot(one_az_enc, one_az, True)
    del one_az
    torch.cuda.synchronize()
    fam["seconds"] = time.perf_counter() - t_fam
    fam["launches"] = dict(_build.LAUNCHES)
    emit({"phase": "codec_families", **fam})
    fam_checks = {
        "lrc_encode_one_launch": fam["lrc_encode_launches"] == 1,
        "lrc_encode_plain": fam["lrc_encode_plain"],
        "lrc_verify": fam["lrc_verify"] and not fam["lrc_verify_damaged"],
        "lrc_reconstruct": fam["lrc_reconstruct"],
        "lrc_join": fam["lrc_join"],
        "lrc_local_stripe_repair": fam["lrc_local_stripe_repair"],
        "lrc_reconstruct_data_global_rows": fam["lrc_reconstruct_data_global_rows"],
        "lrc_fixture_parity": fam["lrc_fixture_parity"],
        "msr_encode_one_launch": fam["msr_encode_launches"] == 1,
        "msr_encode_plain": fam["msr_encode_plain"],
        "msr_verify": fam["msr_verify"],
        "msr_reconstruct": fam["msr_reconstruct"],
        "msr_join": fam["msr_join"],
        **{f"{k}.{c}": v for k in ("msr_repair_EC6P6MSR_d11", "msr_repair_EC6P6MSROneAZ_d10")
           for c, v in fam[k].items()},
        "launched_only_gf_apply": only_gf_apply(fam["launches"]),
    }
    failed = [k for k, v in fam_checks.items() if not v]
    if failed:
        raise AssertionError(f"codec family checks failed: {failed}")

    watch.arm("batcher")
    # -- 7. the codec batcher: concurrent small PUTs and an MSR mix --------
    # 32 threads each admit 8 EC12P4 encodes of 1 MiB payloads before
    # collecting them, as the blob access layer's concurrent PUTs do; every
    # fourth thread also admits two EC6P6MSR encodes (another key). Then
    # the same threads with payloads of mixed sizes: the batcher coalesces
    # only submissions of one shard size S, so that run shows what it does
    # with traffic it cannot coalesce. Every stripe's parity is held against
    # the plain version and against a launch of its own.
    _build.reset_launches()
    bc = BatchCodec(enabled=True)
    put_enc = new_encoder(CodecConfig(cm.CodeMode.EC12P4))
    put_enc.engine = AdmittedEngine(bc, dev)
    mix_enc = new_encoder(CodecConfig(cm.CodeMode.EC6P6MSR))
    mix_enc.engine = AdmittedEngine(bc, dev)
    n_threads, per_thread, mix_per = 32, 8, 2
    n_puts = n_threads * per_thread
    put_rows = gf256.parity_matrix(n, m)
    msr_rows = rs_kernel.msr_encode_rows(msr_k, msr_total, msr_d)

    def run_puts(payloads: list, mix_payloads: list) -> tuple[list, list, float]:
        """32 threads admit their PUTs (and the MSR mix) and collect them."""
        stripes, mixed = [None] * len(payloads), [None] * len(mix_payloads)
        start = threading.Barrier(n_threads)

        def worker(i: int) -> None:
            start.wait(60.0)
            pending = []
            for j in range(per_thread):
                k = i * per_thread + j
                stripes[k] = put_enc.split(payloads[k])
                pending.append(put_enc.encode_async(stripes[k]))
                if len(mix_payloads) and i % 4 == 0 and j < mix_per:
                    q = i // 4 * mix_per + j
                    mixed[q] = mix_enc.split(mix_payloads[q])
                    pending.append(mix_enc.encode_async(mixed[q]))
            for p in pending:
                p.wait()

        t = time.perf_counter()
        with ThreadPoolExecutor(n_threads) as pool:
            for f in [pool.submit(worker, i) for i in range(n_threads)]:
                f.result()  # re-raises a worker's failure
        torch.cuda.synchronize()
        return stripes, mixed, time.perf_counter() - t

    def equals_plain(rows: np.ndarray, xs: list, ys: list) -> bool:
        """ys[i] == plain(rows, xs[i]) for every stripe, 32 at a time."""
        return all(bool(torch.equal(torch.stack(ys[i:i + 32]),
                                    plain(rows, torch.stack(xs[i:i + 32]))))
                   for i in range(0, len(xs), 32))

    def puts_hold(stripes: list) -> dict[str, bool]:
        by_s = {}  # the plain version takes one S at a time
        for st in stripes:
            by_s.setdefault(st.shape[-1], []).append(st)
        return {
            "plain": all(equals_plain(put_rows, [st[:n] for st in g], [st[n:] for st in g])
                         for g in by_s.values()),
            "unbatched": all(bool(torch.equal(st[n:], rs_kernel.encode_parity(st[:n], m)))
                             for st in stripes)}

    put_stripes, mix_stripes, secs = run_puts(
        rand(n_puts, PUT), rand(n_threads // 4 * mix_per, PUT))
    bat = {"seconds": secs, "threads": n_threads, "submissions": bc.submissions,
           "steps": bc.steps, "put_shard": put_enc.shard_size(PUT),
           "launches": dict(_build.LAUNCHES)}
    bat["puts"] = puts_hold(put_stripes)
    bat["msr_mix"] = {
        "plain": equals_plain(msr_rows,
                              [rs_kernel.msr_subshards(st[:msr_k], alpha) for st in mix_stripes],
                              [rs_kernel.msr_subshards(st[msr_k:], alpha) for st in mix_stripes]),
        "unbatched": all(bool(torch.equal(
            st[msr_k:], rs_kernel.msr_encode_parity(st[:msr_k], msr_k, msr_total, msr_d)))
            for st in mix_stripes)}
    n_uniform = len(put_stripes) + len(mix_stripes)
    del put_stripes, mix_stripes
    sizes = rng.integers(PUT // 2, 2 * PUT + 1, n_puts)
    before = (bc.submissions, bc.steps)
    mixed_stripes, _, secs = run_puts([rand(int(z)) for z in sizes], [])
    bat["mixed_sizes"] = {
        "seconds": secs, "submissions": bc.submissions - before[0],
        "steps": bc.steps - before[1],
        "distinct_s": len({put_enc.shard_size(int(z)) for z in sizes}),
        **puts_hold(mixed_stripes)}
    bat["queues_left"] = len(bc._queues)  # an idle key's queue is dropped
    st = put_enc.split(rand(PUT))
    data = st[:n].clone()
    before = _build.LAUNCHES["gf_apply"]
    put_enc.encode(st)  # uncontended: one launch, parity written into the stripe
    bat["uncontended_launches"] = _build.LAUNCHES["gf_apply"] - before
    bat["uncontended_plain"] = (bool(torch.equal(st[:n], data)) and bool(
        torch.equal(st[n:], plain(put_rows, data))))
    bat["launches_all_runs"] = dict(_build.LAUNCHES)
    emit({"phase": "batcher", **bat, "phase_seconds": watch.elapsed()})
    mx = bat["mixed_sizes"]
    bat_checks = {
        **{f"{run}.{c}": v for run in ("puts", "msr_mix") for c, v in bat[run].items()},
        "mixed_sizes.plain": mx["plain"],
        "mixed_sizes.unbatched": mx["unbatched"],
        "all_submitted": bat["submissions"] == n_uniform and mx["submissions"] == n_puts,
        "fewer_steps_than_submissions": 0 < bat["steps"] < bat["submissions"],
        "mixed_sizes_at_most_a_step_each": mx["distinct_s"] <= mx["steps"] <= n_puts,
        "idle_queues_dropped": bat["queues_left"] == 0,
        "uncontended_encode_one_launch": bat["uncontended_launches"] == 1
        and bat["uncontended_plain"],
        "launched_only_gf_apply": only_gf_apply(bat["launches_all_runs"]),
    }
    failed = [k for k, v in bat_checks.items() if not v]
    if failed:
        raise AssertionError(f"batcher checks failed: {failed}")
    del mixed_stripes
    torch.cuda.empty_cache()

    watch.arm("batcher_dp")
    # -- 7b. the batcher's dp split over the listed cards ------------------
    # The card named twice (and every visible card where there are two or
    # more): both legs, an encode and a reconstruct apply of 8 EC12P4
    # stripes at 4 MiB shards, each held against the plain version and
    # the unsplit step; the dp counter, A once a block, and a missing card
    # refused. Counts from 0: A only.
    dp_phase = batcher_dp_phase(dev, card)
    emit(dp_phase)
    failed = [k for k, v in dp_phase["checks"].items() if not v]
    if failed:
        raise AssertionError(f"batcher_dp checks failed: {failed}")
    torch.cuda.empty_cache()

    watch.arm("end_to_end")
    # -- 8. the entry points end to end, timed ------------------------------
    # Each ms covers the whole call (host work, kernels, views, compares).
    e2e = []

    # Beside the whole call, the device time of each kernel it ran (from
    # the profiler's CUDA trace), their sum, and the share of the call the
    # device was busy.
    def e2e_case(label: str, fn, moved: int, least: int) -> None:
        ms = time_ms(fn, KERNEL_REPS)
        kernels = kernel_ms(fn, KERNEL_REPS)
        busy_ms = sum(kernels.values())
        bound_ms = least / HBM_BYTES_PER_S * 1e3
        e2e.append({"case": label, "ms": ms, "gib_s": moved / (ms / 1e3) / 2**30,
                    "bound_ms": bound_ms, "bound_share": bound_ms / ms,
                    "device_ms": busy_ms, "device_busy_share": busy_ms / ms,
                    "kernels_ms": {name[:80]: t for name, t in
                                   sorted(kernels.items(), key=lambda kv: -kv[1])}})

    stripes = rand(8, n + m, SHARD)
    e2e_case("Encoder.encode_EC12P4_B8", lambda: enc.encode(stripes),
             moved=8 * n * SHARD, least=8 * (n + m) * SHARD)
    # the same launch without the admission layer: the difference is what
    # the batcher costs an uncontended caller
    raw = CudaEngine(dev)
    e2e_case("CudaEngine.encode_parity_EC12P4_B8_unadmitted",
             lambda: raw.encode_parity(stripes[:, :n], m, out=stripes[:, n:]),
             moved=8 * n * SHARD, least=8 * (n + m) * SHARD)
    del stripes
    data = rand(4, n, SHARD)
    surviving = torch.cat([data, rs_kernel.encode_parity(data, m)], dim=1)[:, list(plan.present)]
    surviving = surviving.contiguous()
    w = len(plan.wanted)
    e2e_case("repair_step_rs12p4_bad1_7_B4", lambda: repair.repair_step(plan, surviving),
             moved=surviving.numel(), least=(len(plan.present) + w) * SHARD * 4)
    del data, surviving
    many = torch.from_numpy(frames).to(dev).repeat(16, 1)  # 1024 frames of 4 blocks
    e2e_case("verify_batch_1024x256KiB", lambda: crc32block.verify_batch(many),
             moved=many.numel(), least=many.numel())
    del many
    stripes = rand(4, lt.total, SHARD)
    e2e_case("LrcEncoder.encode_EC16P20L2_B4", lambda: lrc_enc.encode(stripes),
             moved=4 * lt.n * SHARD, least=4 * lt.total * SHARD)
    stripes = rand(4, msr_total, msr_s)
    e2e_case("MsrEncoder.encode_EC6P6MSR_B4", lambda: msr_enc.encode(stripes),
             moved=4 * msr_k * msr_s, least=4 * msr_total * msr_s)
    del stripes
    ot = one_az_enc.t
    one_az_s = one_az_enc.shard_size(MSR_PAYLOAD)
    payloads = rand(4, ot.d, one_az_s // ot.alpha)
    helpers = tuple(range(1, ot.d + 1))
    e2e_case("msr_repair_shard_EC6P6MSROneAZ_B4",
             lambda: rs_kernel.msr_repair_shard(payloads, ot.n, ot.total, ot.d, 0, helpers),
             moved=payloads.numel(), least=payloads.numel() + 4 * one_az_s)
    del payloads
    # the same 48 PUT-sized encodes through the batcher and as 48 launches
    # one by one, parity written into each caller's stripe: 1 MiB each (one
    # S, one coalesced step), then of mixed sizes (an S each, a step each)
    e2e_bc = BatchCodec(enabled=True)
    put_s = put_enc.shard_size(PUT)
    mixed_s = [put_enc.shard_size(int(z)) for z in rng.integers(PUT // 2, 2 * PUT + 1, 48)]
    for tag, shard_sizes, want_steps in (("1MiB", [put_s] * 48, 1),
                                         ("mixed_sizes", mixed_s, len(set(mixed_s)))):
        puts = [rand(1, n + m, z) for z in shard_sizes]

        def admitted(puts=puts):
            futs = [e2e_bc.submit_encode_async(dev, p[:, :n], m, out=p[:, n:]) for p in puts]
            for f in futs:
                f.result()

        def one_by_one(puts=puts):
            for p in puts:
                rs_kernel.encode_parity(p[:, :n], m, out=p[:, n:])

        steps = e2e_bc.steps
        admitted()
        got = [p[:, n:].clone() for p in puts]
        one_by_one()
        if e2e_bc.steps != steps + want_steps or not all(
                bool(torch.equal(g, p[:, n:])) and bool(torch.equal(g, plain(put_rows, p[:, :n])))
                for g, p in zip(got, puts)):
            raise AssertionError(f"the batcher's steps ({tag}) disagree with the launches one "
                                 f"by one or the plain version")
        moved = sum(n * z for z in shard_sizes)
        for label, fn in ((f"batcher_EC12P4_{tag}_x48", admitted),
                          (f"one_by_one_EC12P4_{tag}_x48", one_by_one)):
            e2e_case(label, fn, moved=moved, least=moved * (n + m) // n)
        del puts, got

    # what each step's trace span costs on this host: a stage:codec_step
    # root with 48 follows-from links, its tags, its collection and its
    # stage sample, as codec/batcher.py opens one per step (mean of 1000)
    refs = [tracelib.SpanRef(f"{i:016x}", f"{i:016x}", True, "blob.put") for i in range(48)]

    def step_span():
        span = tracelib.start_span("stage:codec_step", links=refs)
        span.set_tag("stage", "codec_step").set_tag("op", "encode").set_tag("stripes", 48)
        with span:
            pass
        tracelib.observe_stage("codec_step", "blob.put", span.duration())

    t0 = time.perf_counter()
    for _ in range(1000):
        step_span()
    span_us = (time.perf_counter() - t0) * 1e3
    tracelib.reset_collector()
    emit({"phase": "end_to_end", "seconds": watch.elapsed(), "cases": e2e,
          "codec_step_span_us": span_us})

    watch.arm("gf_tuning")
    # -- 9. the GF tuning path: both rounds of tuning/gf_tuning.py ----------
    _build.reset_launches()
    tuning = {}
    for round_ in (1, 2):
        records = gf_tuning.sweep(round_, dev)
        best = gf_tuning.best(records)
        tuning[round_] = records
        emit({"phase": "gf_tuning", "round": round_, "seconds": watch.elapsed(),
              "records": records, "best": best})
        print("BEST:", json.dumps(best), flush=True)
        errors = [rec for rec in records if "error" in rec]
        if errors or best is None:
            raise AssertionError(f"tuning round {round_} had failing variants: {errors}")
    tuning_launches = dict(_build.LAUNCHES)
    if not (tuning_launches["gf_bitmajor"] > 0 and tuning_launches["gf_bitmajor_probe"] > 0):
        raise AssertionError(f"the tuning path did not launch both bit-matrix kernels: "
                             f"{tuning_launches}")

    watch.arm("service")
    # -- 10. the codec service: the codec role, driven over its wire --------
    # The server runs as its users start it, a process of its own on the
    # card. This process drives it with http.client as the native client
    # does (a connection a call, no body CRC) and holds every reply exactly
    # against the plain versions on the card and zlib. ms: the whole RPC on
    # the client's clock, median of SERVICE_REPS after one checked call.
    # The server's device time for a case: its kernel's device_ms at the
    # same shape (phases gf_apply and crc32_blocks, from the profiler) and
    # the copies in and out (codec/hostio.py) between CUDA events in this
    # process on the same request. (Profiler traces taken this late in the
    # run lost the first record of most sessions, in a probe and in this
    # phase, so none is taken here.) Launches: the server's
    # cubefs_codec_kernel_launches_total, read from its /metrics.
    torch.cuda.empty_cache()
    t_svc = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="cubefs-smoke-")
    proc, addr = start_server(root, SERVICE_CFG, workdir)
    svc_cases, shm_paths = [], []
    kernel_case = {r["case"]: r for r in gf_results + crc_results}

    def server_launches() -> dict[str, int]:
        got = scrape(addr)
        return {k: int(got.get(f'cubefs_codec_kernel_launches_total{{kernel="{k}"}}', 0))
                for k in _build.KERNELS}

    def svc_case(label: str, method: str, args: dict, body: bytes, moved: int, check,
                 kernel: str | None, y: torch.Tensor, src, shape: tuple, out=None) -> None:
        """One checked call, then SERVICE_REPS timed ones; the device time
        of the ``kernel`` case at its shape, and the service's copy in
        (``src`` to ``shape``) and copy out (of its result ``y``, into
        ``out`` or a new pinned tensor) in this process."""
        before = server_launches()
        status, meta, payload = rpc_post(addr, method, args, body)
        ok = status == 200 and bool(check(meta, payload))
        times = []
        for _ in range(SERVICE_REPS):
            t = time.perf_counter()
            ok = rpc_post(addr, method, args, body)[0] == 200 and ok
            times.append((time.perf_counter() - t) * 1e3)
        after = server_launches()
        ms = statistics.median(times)
        res = {"case": label, "method": method, "args": {k: v for k, v in args.items()
                                                         if k != "shm"},
               "bytes_in": moved, "equal": ok, "ms": ms, "ms_runs": times,
               "gib_s": moved / (ms / 1e3) / 2**30, "calls": 1 + SERVICE_REPS,
               "launches": {k: after[k] - before[k] for k in after if after[k] != before[k]},
               "to_device_ms": time_ms(lambda: hostio.to_device(src, shape, dev), KERNEL_REPS),
               "to_host_ms": time_ms(lambda: hostio.to_host(y, out=out), KERNEL_REPS)}
        if kernel is not None:
            k = kernel_case[kernel]
            res.update({"kernel_case": kernel, "kernel_device_ms": k["device_ms"],
                        "kernel_bound_ms": k["bound_ms"], "kernel_bound_share": k["bound_share"]})
        svc_cases.append(res)

    def to_bytes(x: torch.Tensor) -> bytes:
        return x.cpu().numpy().tobytes()

    def shm_file(nbytes: int, data: bytes) -> str:
        fd, path = tempfile.mkstemp(prefix="cubefs-codec-", dir="/dev/shm")
        shm_paths.append(path)
        os.ftruncate(fd, nbytes)
        os.close(fd)
        mm = shm_view(path)
        mm[: len(data)] = np.frombuffer(data, np.uint8)
        mm.flush()
        return path

    def shm_view(path: str) -> np.memmap:
        return np.memmap(path, dtype=np.uint8, mode="r+")

    def shm_tail(path: str, nbytes: int) -> bytes:
        with open(path, "rb") as f:
            f.seek(-nbytes, os.SEEK_END)
            return f.read()

    try:
        # encode and reconstruct of 8 MiB blobs over the HTTP body, B = 4
        enc_rows = gf256.parity_matrix(n, m)
        blob = rand(4, n + m, blob_s)
        blob[:, n:] = plain(enc_rows, blob[:, :n])
        data_b = to_bytes(blob[:, :n])
        geo = {"n": n, "m": m, "shard_size": blob_s, "batch": 4}
        want = to_bytes(blob[:, n:])
        svc_case("encode_EC12P4_8MiB_blobs_B4", "encode", geo, data_b, len(data_b),
                 lambda meta, p: meta == {"shape": [4, m, blob_s]} and p == want,
                 "service_encode_S699051_B4", blob[:, n:].contiguous(), data_b, (4, n, blob_s))
        present = list(plan.present)
        rec_args = {"n": n, "total": n + m, "present": present, "wanted": [1, 7],
                    "shard_size": blob_s, "batch": 4}
        surv = blob[:, present[:n]].contiguous()
        want_rec = to_bytes(plain(svc_rows, surv))
        lost = to_bytes(blob[:, [1, 7]])
        surv_b = to_bytes(surv)
        svc_case("reconstruct_EC12P4_8MiB_blobs_bad1_7_B4", "reconstruct", rec_args, surv_b,
                 surv.numel(), lambda meta, p: meta == {"shape": [4, 2, blob_s]}
                 and p == want_rec == lost, "service_reconstruct_2x12_S699051_B4",
                 blob[:, [1, 7]], surv_b, surv.shape)
        vstripes = blob.clone()
        vstripes[1, n + 2, blob_s // 3] ^= 0x5A
        vplain = [bool(torch.equal(plain(enc_rows, vstripes[i:i + 1, :n]), vstripes[i:i + 1, n:]))
                  for i in range(4)]
        vs_b = to_bytes(vstripes)
        svc_case("verify_EC12P4_8MiB_blobs_B4_one_corrupt", "verify", geo, vs_b,
                 vstripes.numel(), lambda meta, p: meta == {"ok": vplain}
                 and vplain == [True, False, True, True],
                 "service_encode_S699051_B4", torch.zeros(4, dtype=torch.bool, device=dev),
                 vs_b, vstripes.shape)
        del blob, surv, vstripes, data_b, surv_b, vs_b

        # the same math through /dev/shm, 4 MiB shards, B = 4
        need = 4 * (n + m) * SHARD
        shm_fs = os.statvfs("/dev/shm")
        free = shm_fs.f_bavail * shm_fs.f_frsize
        if free < need:
            raise AssertionError(f"/dev/shm has {free} bytes free; the shm cases need {need}")
        x = rand(4, n, SHARD)
        want = to_bytes(plain(enc_rows, x))
        path = shm_file(need, to_bytes(x))
        mm = shm_view(path)
        svc_case("encode_shm_EC12P4_4MiB_B4", "encode_shm",
                 {"n": n, "m": m, "shard_size": SHARD, "batch": 4, "shm": path}, b"", x.numel(),
                 lambda meta, p: meta == {"shape": [4, m, SHARD], "offset": x.numel()}
                 and shm_tail(path, len(want)) == want,
                 "service_encode_shm_B4", plain(enc_rows, x), mm[:x.numel()], x.shape,
                 mm[x.numel():])
        del mm
        os.unlink(path)
        want = to_bytes(plain(svc_rows, x))
        path = shm_file(4 * (n + 2) * SHARD, to_bytes(x))
        mm = shm_view(path)
        svc_case("reconstruct_shm_EC12P4_4MiB_bad1_7_B4", "reconstruct_shm",
                 dict(rec_args, shard_size=SHARD, shm=path), b"", x.numel(),
                 lambda meta, p: meta == {"shape": [4, 2, SHARD], "offset": x.numel()}
                 and shm_tail(path, len(want)) == want,
                 "service_reconstruct_shm_2x12_B4", plain(svc_rows, x), mm[:x.numel()],
                 x.shape, mm[x.numel():])
        del mm
        os.unlink(path)
        del x

        # CRCs: datanode packets, and odd rows on B's byte path
        for label, blocks, kernel in (
                ("crc32_1024x128KiB", rand(1024, 128 << 10), "service_blocks_1024x128KiB"),
                ("crc32_1000x1001", rand(1000, 1001), "odd_blocks_1000x1001")):
            b_, block_len = blocks.shape
            body = to_bytes(blocks)
            want_crc = crc32_kernel.crc32_blocks_plain(blocks).cpu().numpy().astype("<u4")
            zl = np.asarray([zlib.crc32(body[i * block_len:(i + 1) * block_len])
                             for i in range(b_)], dtype="<u4")
            svc_case(label, "crc32", {"block_len": block_len}, body, len(body),
                     lambda meta, p, b_=b_, w=want_crc, z=zl: meta == {"count": b_}
                     and p == w.tobytes() == z.tobytes() and int(z.max()) >= 1 << 31,
                     kernel, crc32_kernel.crc32_blocks_plain(blocks), body, blocks.shape)
            del blocks, body

        # 32 threads x 8 encodes of a 1 MiB blob each, all at once
        n_threads, per_thread = 32, 8
        small_s = -(-PUT // n)
        small = rand(n_threads * per_thread, n, small_s)
        small_want = [to_bytes(plain(enc_rows, small[i:i + 32])) for i in range(0, len(small), 32)]
        small_want = [w[j * m * small_s:(j + 1) * m * small_s]
                      for w in small_want for j in range(32)]
        bodies = [to_bytes(small[i]) for i in range(len(small))]
        replies, call_ms = [None] * len(bodies), [0.0] * len(bodies)
        start = threading.Barrier(n_threads)
        small_args = {"n": n, "m": m, "shard_size": small_s}

        def client(i: int) -> None:
            start.wait(60.0)
            for j in range(per_thread):
                k = i * per_thread + j
                t = time.perf_counter()
                replies[k] = rpc_post(addr, "encode", small_args, bodies[k])
                call_ms[k] = (time.perf_counter() - t) * 1e3

        keys = {"steps": 'cubefs_codec_batch_steps_total{op="encode",engine="cuda"}',
                "submissions": 'cubefs_codec_batch_submissions_total{op="encode"}',
                "bytes": 'cubefs_codec_bytes_total{op="encode",engine="cuda"}',
                "launches": 'cubefs_codec_kernel_launches_total{kernel="gf_apply"}'}
        m0 = scrape(addr)
        t = time.perf_counter()
        with ThreadPoolExecutor(n_threads) as pool:
            for f in [pool.submit(client, i) for i in range(n_threads)]:
                f.result()
        wall = time.perf_counter() - t
        m1 = scrape(addr)
        conc = {k: m1.get(v, 0.0) - m0.get(v, 0.0) for k, v in keys.items()}
        sent = sum(len(b) for b in bodies)
        conc.update({
            "threads": n_threads, "calls": len(bodies), "shard_size": small_s,
            "bytes_sent": sent, "seconds": wall, "gib_s": sent / wall / 2**30,
            "ms": statistics.median(call_ms), "ms_max": max(call_ms),
            "equal": all(r == (200, {"shape": [1, m, small_s]}, w)
                         for r, w in zip(replies, small_want))})
        conc["held"] = (conc["equal"] and conc["submissions"] == len(bodies)
                        and 0 < conc["steps"] < conc["submissions"]
                        and conc["bytes"] == sent and conc["launches"] == conc["steps"])
        del small, small_want, bodies, replies

        # refusals: the server says no, and touches nothing
        refusals = {
            "unsorted_present": rpc_post(addr, "reconstruct",
                                         dict(rec_args, present=present[::-1]))[:2],
            "shm_path_escape": rpc_post(addr, "encode_shm", dict(
                geo, shm="/dev/shm/cubefs-codec-x/../../etc/passwd"))[:2],
            "shm_outside_prefix": rpc_post(addr, "encode_shm", dict(geo, shm="/etc/passwd"))[:2],
            "body_crc_mismatch": rpc_post(addr, "crc32", {"block_len": 4}, bytes(8),
                                          {"X-Rpc-Crc": "1"})[:2],
        }
        svc_launches = server_launches()
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            server_exit = proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)
            server_exit = None
        for path in shm_paths:
            if os.path.exists(path):
                os.unlink(path)
        shutil.rmtree(workdir, ignore_errors=True)
    service = {"server": addr, "seconds": time.perf_counter() - t_svc, "cases": svc_cases,
               "concurrency": conc, "refusals": refusals, "launches": svc_launches,
               "server_exit": server_exit}
    emit({"phase": "service", **service})
    svc_checks = {
        **{f"{c['case']}.equal": c["equal"] for c in svc_cases},
        "concurrency": conc["held"],
        "refusals_400": all(st_ == 400 for st_, _ in refusals.values()),
        "launched_a_and_b_only": (svc_launches["gf_apply"] > 0 and svc_launches["crc32_blocks"] > 0
                                  and all(v == 0 for k, v in svc_launches.items()
                                          if k not in MAIN_KERNELS)),
        "server_exit_0": server_exit == 0,
    }
    failed = [k for k, v in svc_checks.items() if not v]
    if failed:
        raise AssertionError(f"service checks failed: {failed}")

    watch.arm("engines")
    # -- 11. the codec engine layer: host legs, XOR programs, auto ---------
    # Counts from 0 (this process's): A only. The second codec role's
    # launches come from its /metrics.
    torch.cuda.empty_cache()
    eng_phase = engines_phase(root, dev, card)
    emit(eng_phase)
    failed = [k for k, v in eng_phase["checks"].items() if not v]
    if failed:
        raise AssertionError(f"engines checks failed: {failed}")

    watch.arm("blob")
    # -- 12. the blob plane: PUT, GET, degraded GET, disk repair -------------
    # After phase engines, so that auto reads the table measured on this
    # card. Counts from 0: A only (B is not on the path: the blob plane
    # takes its CRCs on the host).
    torch.cuda.empty_cache()
    blob = blob_phase(dev, card)
    blob["a_device_ms"] = {r["case"]: r["device_ms"] for r in gf_results
                           if r["case"].startswith("blob_")}
    emit(blob)
    failed = [k for k, v in blob["checks"].items() if not v]
    if failed:
        raise AssertionError(f"blob checks failed: {failed}")

    watch.arm("roles")
    # -- 13. the blob roles over HTTP: every role a process of its own --------
    # The access process builds nothing (phase build did) and runs engine
    # cuda; its A launches come from its /metrics. Nothing in this process
    # launches a kernel here.
    torch.cuda.empty_cache()
    roles = roles_phase(dev, card)
    emit(roles)
    failed = [k for k, v in roles["checks"].items() if not v]
    if failed:
        raise AssertionError(f"roles checks failed: {failed}")

    watch.arm("raft")
    # -- 14. the replicated blob plane: raft and its failures ----------------
    # The same plane with its control plane replicated: a clustermgr raft
    # group of 3 and the repair/delete bus on 3 scheduler members. A runs
    # in the access process on both sides of a clustermgr leader kill and
    # on the degraded GETs; its launches come from the access /metrics.
    torch.cuda.empty_cache()
    replicated = raft_phase(dev, card)
    emit(replicated)
    failed = [k for k, v in replicated["checks"].items() if not v]
    if failed:
        raise AssertionError(f"raft checks failed: {failed}")

    watch.arm("integrity")
    # -- 15. the integrity sweep: the scheduler's scrub, A its parity verifier
    # In process, on engine cuda. Counts from 0: A only.
    torch.cuda.empty_cache()
    integrity = integrity_phase(dev, card)
    emit(integrity)
    failed = [k for k, v in integrity["checks"].items() if not v]
    if failed:
        raise AssertionError(f"integrity checks failed: {failed}")

    watch.arm("shardnode")
    # -- 16. the metadata shards: the shardnode on raft over the KV store ----
    # Host work only: no kernel runs here.
    shards = shardnode_phase(dev, card)
    emit(shards)
    failed = [k for k, v in shards["checks"].items() if not v]
    if failed:
        raise AssertionError(f"shardnode checks failed: {failed}")

    watch.arm("fs")
    # -- 17. the file-system plane: master, metanodes, datanodes, the client
    # The roles are processes; the client runs here, and so does its cold
    # tier's blob codec: A encodes each tier PUT and rebuilds each degraded
    # cold read in this process, on engine cuda. Counts from 0: A only.
    torch.cuda.empty_cache()
    fsp = fs_phase(dev, card)
    emit(fsp)
    failed = [k for k, v in fsp["checks"].items() if not v]
    if failed:
        raise AssertionError(f"fs checks failed: {failed}")

    watch.arm("s3")
    # -- 18. the S3 gateway: the objectnode role over the same planes --------
    # The roles are processes; the cold tier's client and the gateway that
    # serves the cold GETs run here, and so does the blob codec: A encodes
    # each tier PUT and rebuilds each degraded cold GET in this process, on
    # engine cuda. Counts from 0: A only.
    torch.cuda.empty_cache()
    s3p = s3_phase(dev, card)
    emit(s3p)
    failed = [k for k, v in s3p["checks"].items() if not v]
    if failed:
        raise AssertionError(f"s3 checks failed: {failed}")

    watch.arm("fs_doors")
    # -- 19. the file-system plane's doors: split, flash tier, geo ----------
    # The roles are processes; the client, its cold tier's blob codec and
    # the two geo regions run here: A encodes the tier PUTs and rebuilds
    # the degraded cold reads after the split in this process, on engine
    # cuda. Counts from 0: A only.
    torch.cuda.empty_cache()
    doors = fs_doors_phase(dev, card)
    emit(doors)
    failed = [k for k, v in doors["checks"].items() if not v]
    if failed:
        raise AssertionError(f"fs_doors checks failed: {failed}")

    watch.arm("clients")
    # -- 20. the clients and mounts: the C ABI, the fsgateway, FUSE, console
    # The roles are processes: A and B run in the codec role under the C
    # ABI's codec calls, A in the access role under cfs_blob_*; the tiered
    # volume's gateway and mount run here, and A encodes its tier PUTs and
    # rebuilds its degraded cold reads in this process. Counts from 0.
    torch.cuda.empty_cache()
    _build.reset_launches()
    cli = clients_phase(dev, card)
    emit(cli)
    failed = [k for k, v in cli["checks"].items() if not v]
    if failed:
        raise AssertionError(f"clients checks failed: {failed}")

    watch.arm("operators")
    # -- 21. the operator plane and the blob and codec tools ------------------
    # The roles are processes, driven by the CLI's processes: A runs in the
    # access role on the PUT stacks and the degraded GETs, in the scheduler
    # role on its scrub's parity recompute, and here under the repair
    # worker, bench_codec and tier_ab. loadgen and scrub_ab do no card work
    # (tier-1 holds them). Counts from 0.
    torch.cuda.empty_cache()
    _build.reset_launches()
    ops = operators_phase(dev, card)
    emit(ops)
    failed = [k for k, v in ops["checks"].items() if not v]
    if failed:
        raise AssertionError(f"operators checks failed: {failed}")

    watch.arm("fs_bench")
    # -- 22. the file-system benchmark harness and the sm_90a build check ----
    # Host tools, each a process of its own (the harness forks its clients
    # and servers); nothing in them launches a kernel. The build check
    # compiles the three kernel sources again, into a directory of its own.
    fsb = fs_bench_phase(card)
    emit(fsb)
    failed = [k for k, v in fsb["checks"].items() if not v]
    if failed:
        raise AssertionError(f"fs_bench checks failed: {failed}")

    watch.arm("sharded")
    # -- 23. the sharded step: 8 ranks over torch.distributed ----------------
    # Built above, in this process: the ranks find the libraries and run
    # no nvcc. Every rank runs A and B on its own block; the collectives
    # go through gloo, which stages CUDA buffers through host memory and
    # lets the 8 ranks share one card (NCCL does not); NCCL only where 8
    # cards are visible. Every block of every result is held exactly
    # against the plain version, the single-rank path, the lost shards
    # and zlib in the rank, and each rank's partial applies against the
    # plain version on the same block.
    torch.cuda.empty_cache()
    world = 8
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    t_sh = time.perf_counter()
    ranks = launch.launch(dryrun.multichip, world, backend=backend, device=None,
                          args=(SHARDED_RUNS, KERNEL_REPS),
                          deadline=PHASE_BUDGETS["sharded"] - 10.0, timeout=300.0)
    sharded = [sharded_summary(run, [r.result[i] for r in ranks])
               for i, run in enumerate(SHARDED_RUNS)]
    emit({"phase": "sharded", "backend": backend, "world": world,
          "seconds": time.perf_counter() - t_sh, "runs": sharded})
    sh_bad = [res for res in sharded if not res["held"]]
    if sh_bad:
        raise AssertionError(f"sharded step checks failed: {sh_bad}")

    watch.arm("kernels")
    # -- 24. the kernels' record --------------------------------------------
    gf_main, crc_main = gf_results[0], crc_results[0]
    bm_main, probe_main = (next(x for x in bm_results
                                if (x["case"], x["extract"], x["probe"], x["grid"]) == key)
                           for key in RECORDED_BM)
    emit({"kernels": [
        {"name": "gf_apply", "route": "cuda", "source": "cubefs_tpu_torch/csrc/gf_apply.cu",
         "replaces": "cubefs_tpu/ops/pallas_gf.py:46", "shape": gf_main["case"],
         "launches": launches["gf_apply"], "service_launches": svc_launches["gf_apply"],
         "batcher_dp_launches": dp_phase["launches"]["gf_apply"],
         "engines_launches": eng_phase["launches"]["gf_apply"],
         "blob_launches": blob["launches"]["gf_apply"],
         "roles_launches": roles["launches"]["gf_apply"],
         "raft_launches": replicated["launches"]["gf_apply"],
         "integrity_launches": integrity["launches"]["gf_apply"],
         "integrity_scrub_launches": integrity["scrub_launches"],
         "fs_launches": fsp["launches"]["gf_apply"],
         "s3_launches": s3p["launches"]["gf_apply"],
         "fs_doors_launches": doors["launches"]["gf_apply"],
         "clients_launches": {proc: counts["gf_apply"]
                              for proc, counts in cli["launches"].items()},
         "operators_launches": ops["launches"],
         "equal": gf_main["equal"],
         "max_abs_err": gf_main["max_abs_err"], "ms": gf_main["ms"],
         "device_ms": gf_main["device_ms"], "plain_ms": gf_main["plain_ms"],
         "bound_ms": gf_main["bound_ms"],
         "bound_by": gf_main["bound_by"], "library_ms": None},
        {"name": "crc32_blocks", "route": "cuda",
         "source": "cubefs_tpu_torch/csrc/crc32_blocks.cu",
         "replaces": "cubefs_tpu/ops/pallas_crc.py:44", "shape": crc_main["case"],
         "launches": launches["crc32_blocks"],
         "service_launches": svc_launches["crc32_blocks"],
         "clients_launches": {"codec_role": cli["launches"]["codec_role"]["crc32_blocks"]},
         "equal": crc_main["equal"],
         "max_abs_err": crc_main["max_abs_err"], "ms": crc_main["ms"],
         "device_ms": crc_main["device_ms"], "plain_ms": crc_main["plain_ms"],
         "bound_ms": crc_main["bound_ms"],
         "bound_by": crc_main["bound_by"], "library_ms": None},
        *({"name": rec["kernel"], "route": "cuda",
           "source": "cubefs_tpu_torch/csrc/gf_bitmajor.cu", "replaces": replaces,
           "shape": f'{rec["case"]} {rec["extract"]}/{rec["grid"]}/{rec["probe"]} tile {tile}',
           "path": "gf_tuning", "launches": tuning_launches[rec["kernel"]],
           "equal": rec["equal"], "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
           "device_ms": rec["device_ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
           "bound_by": rec["bound_by"], "library_ms": None}
          for rec, replaces in ((bm_main, "benchmarks/pallas_tuning.py:41"),
                                (probe_main, "benchmarks/pallas_tuning2.py:56"))),
    ]})
    watch.disarm()
    emit({"phase_seconds": watch.seconds, "script_s": time.monotonic() - watch.t0})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
