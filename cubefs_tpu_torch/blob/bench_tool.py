"""Access-layer load generator (PUT/GET throughput).

Role parity: blobstore/tool/bench — concurrent PUT then GET of random
payloads against an access endpoint, reporting aggregate MB/s and
latency percentiles. Run: `python -m cubefs_tpu_torch.blob.bench_tool
--access HOST:PORT --size 4194304 --count 64 --concurrency 8`.

The port's copy of ``cubefs_tpu/blob/bench_tool.py``: a host program that
talks to the access role, which holds the card.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

from ..utils import rpc


def _pct(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p / 100 * len(xs)))] if xs else 0.0


def run(access: rpc.Client, size: int, count: int, concurrency: int) -> dict:
    payloads = [os.urandom(size) for _ in range(min(count, 8))]

    put_lat: list[float] = []
    locations = []

    def put(i):
        t0 = time.perf_counter()
        meta, _ = access.call("put", {}, payloads[i % len(payloads)])
        put_lat.append(time.perf_counter() - t0)
        return meta["location"]

    t0 = time.perf_counter()
    with ThreadPoolExecutor(concurrency) as ex:
        locations = list(ex.map(put, range(count)))
    put_wall = time.perf_counter() - t0

    get_lat: list[float] = []

    def get(loc):
        t0 = time.perf_counter()
        access.call("get", {"location": loc})
        get_lat.append(time.perf_counter() - t0)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(concurrency) as ex:
        list(ex.map(get, locations))
    get_wall = time.perf_counter() - t0

    total_mb = size * count / 1e6
    return {
        "size": size, "count": count, "concurrency": concurrency,
        "put_mbps": round(total_mb / put_wall, 2),
        "get_mbps": round(total_mb / get_wall, 2),
        "put_p50_ms": round(_pct(put_lat, 50) * 1e3, 2),
        "put_p99_ms": round(_pct(put_lat, 99) * 1e3, 2),
        "get_p50_ms": round(_pct(get_lat, 50) * 1e3, 2),
        "get_p99_ms": round(_pct(get_lat, 99) * 1e3, 2),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="cubefs-tpu-torch-blob-bench")
    ap.add_argument("--access", required=True)
    ap.add_argument("--size", type=int, default=1 << 20)
    ap.add_argument("--count", type=int, default=32)
    ap.add_argument("--concurrency", type=int, default=8)
    args = ap.parse_args(argv)
    print(json.dumps(run(rpc.Client(args.access), args.size, args.count,
                         args.concurrency)))


if __name__ == "__main__":
    main()
