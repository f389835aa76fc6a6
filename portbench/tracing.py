"""The device trace of a traced run, reduced to what the per-layer metrics
read: device busy time, copies, kernels, idle gaps and what the host was
doing in each.

``torch.profiler`` (CUPTI) records the card's activity over the window;
its Chrome trace is read back, and only the events inside the
harness's ``pb.window`` annotation (on the thread that runs the window)
count. A device event is a kernel, a memcpy or a memset; copies between
host and device are the memcpys whose name says HtoD or DtoH. The
clients' host phases (``pb.*``, timed by the harness around its calls
into the program, ``harness.Call.span``) label the idle gaps: host
times map onto the trace from the window's start.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

import torch

WINDOW = "pb.window"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}


def start():
    """A started profiler: the card's activity, and the host ops of the
    calling thread alone (the window's annotation)."""
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    return prof


def stop(prof) -> list[dict]:
    """Stop ``prof`` and return its trace's complete events."""
    prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _union(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _length(spans) -> float:
    return sum(b - a for a, b in spans)


def summarize(events: list[dict], spans=(), start: float = 0.0, top: int = 10
              ) -> dict | None:
    """Seconds of the window, of device busy time (the union of every
    device event), of host-device copies (their union) and of kernels
    (their sum); the bytes of those copies (the trace's ``bytes`` of
    each, whole where it starts or ends inside the window); the device ops that took most time and the longest idle
    gaps, each labelled by the host phase that overlaps it most.
    ``spans`` are the phases, (name, start, end) on the host clock whose
    reading at the window's start was ``start``. None if the trace holds
    no window."""
    win = [e for e in events if e.get("name") == WINDOW]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])

    def clip(e):
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        return (a, b) if b > a else None

    device, copies, kernels = [], [], []
    copy_bytes = 0
    by_name: dict[str, float] = defaultdict(float)
    for e in events:
        if str(e.get("cat", "")).lower() not in DEVICE_CATS:
            continue
        span = clip(e)
        if span is None:
            continue
        device.append(span)
        by_name[e["name"]] += span[1] - span[0]
        cat = str(e["cat"]).lower()
        if cat == "kernel":
            kernels.append(span)
        elif cat == "gpu_memcpy" and ("HtoD" in e["name"] or "DtoH" in e["name"]):
            copies.append(span)
            copy_bytes += int(e.get("args", {}).get("bytes", 0))
    busy = _union(device)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    notes = [(w0 + (a - start) * 1e6, w0 + (b - start) * 1e6, name) for name, a, b in spans]

    def label(gap) -> str:
        over: dict[str, float] = defaultdict(float)
        for a, b, name in notes:
            o = min(b, gap[1]) - max(a, gap[0])
            if o > 0:
                over[name] += o
        return max(over, key=over.get) if over else "host:none"

    us = 1e-6
    return {
        "window_s": (w1 - w0) * us,
        "busy_s": _length(busy) * us,
        "copy_s": _length(_union(copies)) * us,
        "kernel_s": sum(b - a for a, b in kernels) * us,
        "copy_bytes": copy_bytes,
        "device_ops": [[n, s * us] for n, s in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[label(g), (g[1] - g[0]) * us] for g in gaps],
    }
