"""Dial: live e2e prober (canary) for the blob plane.

Role parity: blobstore/testing/dial — continuously put/get/delete
against a running access endpoint and export success/latency metrics
(dial.go, metric.go). Run in-process or as `python -m
cubefs_tpu_torch.blob.dial --access HOST:PORT`.

The port's copy of ``cubefs_tpu/blob/dial.py``: a host program that talks
to the access role, which holds the card.
"""

from __future__ import annotations

import os
import threading
import time

from ..utils import metrics, rpc

dial_ops = metrics.DEFAULT.counter(
    "cubefs_dial_ops_total", "dial prober operations", ("op", "ok")
)
dial_latency = metrics.DEFAULT.histogram(
    "cubefs_dial_latency_seconds", "dial prober op latency", ("op",)
)


class DialProber:
    def __init__(self, access: rpc.Client, payload_size: int = 64 << 10,
                 interval: float = 1.0):
        self.access = access
        self.payload_size = payload_size
        self.interval = interval
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.rounds = 0
        self.failures = 0

    def probe_once(self) -> bool:
        """One put -> get -> delete cycle; records metrics per leg."""
        payload = os.urandom(self.payload_size)
        self.rounds += 1
        ok = True
        try:
            with dial_latency.time(op="put"):
                meta, _ = self.access.call("put", {}, payload)
            loc = meta["location"]
            dial_ops.inc(op="put", ok=True)
        except Exception:
            dial_ops.inc(op="put", ok=False)
            self.failures += 1
            return False
        try:
            with dial_latency.time(op="get"):
                _, got = self.access.call("get", {"location": loc})
            good = got == payload
            dial_ops.inc(op="get", ok=good)
            ok &= good
        except Exception:
            dial_ops.inc(op="get", ok=False)
            ok = False
        try:
            with dial_latency.time(op="delete"):
                self.access.call("delete", {"location": loc})
            dial_ops.inc(op="delete", ok=True)
        except Exception:
            dial_ops.inc(op="delete", ok=False)
            ok = False
        if not ok:
            self.failures += 1
        return ok

    def start(self) -> "DialProber":
        def loop():
            while not self._stop.wait(self.interval):
                self.probe_once()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(prog="cubefs-tpu-torch-dial")
    ap.add_argument("--access", required=True)
    ap.add_argument("--size", type=int, default=64 << 10)
    ap.add_argument("--interval", type=float, default=1.0)
    ap.add_argument("--count", type=int, default=0, help="0 = forever")
    args = ap.parse_args(argv)
    prober = DialProber(rpc.Client(args.access), args.size, args.interval)
    n = 0
    while args.count == 0 or n < args.count:
        ok = prober.probe_once()
        print(f"round {n}: {'OK' if ok else 'FAIL'}", flush=True)
        n += 1
        time.sleep(args.interval)


if __name__ == "__main__":
    main()
