"""What every cell shares: its files found by name, seeded inputs, the
closed loop of callers, and the arithmetic of the end-to-end metrics.

A cell is ``workloads/<cell>.json``: its configuration's name (the file
``configs/<config>.json``), its traffic mix (the driver
``traffic/<traffic>.py``) and the driver's parameters. A metric is ``metrics/<metric>.py``, whose
``read(run)`` returns the metric's number, or None where the run holds
nothing to read.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import statistics
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
GIB = float(1 << 30)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    return load_json(PKG / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return load_json(PKG / "configs" / f"{name}.json")


def driver(name: str):
    return importlib.import_module(f"portbench.traffic.{name}")


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``; names may hold dots."""
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, section: str) -> list[dict]:
    """The metrics of ``section`` that ``cell`` reports: those that list
    it, and those without a list whose end-to-end metric it reports."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]}
    out = []
    for m in bench[section]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def seeded_bytes(seed: int, stream: int, n: int, device) -> torch.Tensor:
    """``n`` uniform bytes from (seed, stream), made on ``device`` in one
    call: the same seed and stream give the same bytes on one device."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + stream) % (1 << 63))
    return torch.randint(0, 256, (n,), generator=g, dtype=torch.uint8, device=device)


class Phases(dict):
    """Seconds of each named phase of a cell's set-up: ``with
    phases("inputs"): ...``."""

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self[name] = time.perf_counter() - t


class Sampler:
    """Which calls keep their answers for the check, drawn from the seed
    over the whole window: client i's candidates are its calls k with
    k % ``every`` equal to an offset drawn from the seed, and it keeps a
    uniform sample of ``most`` of them (a reservoir: a later candidate
    may take a kept one's place, whose answer is then dropped), so a call
    near the window's close is as likely to be checked as one near its
    start. Each client's state is its own thread's alone."""

    def __init__(self, seed: int, clients: int, every: int, most: int):
        self.offsets = np.random.default_rng([seed, 7]).integers(0, every, clients)
        self.rngs = [np.random.default_rng([seed, 7, i]) for i in range(clients)]
        self.kept: list[list[Call]] = [[] for _ in range(clients)]
        self.seen = [0] * clients
        self.every, self.most = every, most

    def keep(self, client: int, k: int, rec: "Call") -> bool:
        """Whether call ``k`` of ``client`` (its record ``rec``) keeps its
        answer; the caller then sets ``rec.sample``."""
        if k % self.every != self.offsets[client]:
            return False
        n, kept = self.seen[client], self.kept[client]
        self.seen[client] = n + 1
        if n < self.most:
            kept.append(rec)
            return True
        j = int(self.rngs[client].integers(0, n + 1))
        if j >= self.most:
            return False
        kept[j].sample = None
        kept[j] = rec
        return True


@dataclass
class Call:
    """One call a client made in the window: host-clock start and end,
    the user bytes it served, the codec work it asked for as (R, C, S, B)
    applies, and what the check needs to see again."""

    client: int
    start: float
    end: float = 0.0
    nbytes: int = 0
    ok: bool = False
    error: str = ""
    work: list = field(default_factory=list)
    sample: object = None
    spans: list = field(default_factory=list)  # (name, start, end) of its host phases

    @contextlib.contextmanager
    def span(self, name: str):
        """Time a host phase of the call (``pb.*``): the traced run labels
        the card's idle gaps with the phases that overlap them."""
        t = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, t, time.perf_counter()))


@dataclass
class Window:
    """A closed loop's window: ``seconds`` long from ``start``, and every
    call started in it, those still in flight at its close included."""

    start: float
    seconds: float
    calls: list

    @property
    def end(self) -> float:
        return self.start + self.seconds

    def completed(self) -> list:
        return [c for c in self.calls if c.ok and c.end <= self.end]

    def gib_s(self) -> float:
        return sum(c.nbytes for c in self.completed()) / GIB / self.seconds

    def p95_ms(self) -> float | None:
        """The 95th percentile of every call started in the window that
        returned (``statistics.quantiles``, inclusive)."""
        ms = [(c.end - c.start) * 1e3 for c in self.calls if c.ok]
        if len(ms) < 2:
            return None
        return statistics.quantiles(ms, n=20, method="inclusive")[18]


def closed_loop(clients: int, call, seconds: float, annotate: str = "") -> Window:
    """``clients`` threads, each calling ``call(client, k, rec)`` for k =
    0, 1, ... while the window is open, the next call once the last
    returned. ``call`` fills the record ``rec`` (a ``Call``) with its
    bytes and work, and may set its timed ``start`` and ``end`` itself
    (the loop's clock around the call otherwise); an exception marks
    the call failed."""
    gate = threading.Barrier(clients + 1)
    records: list[list[Call]] = [[] for _ in range(clients)]
    window = {}

    def client(i: int) -> None:
        gate.wait()
        end = window["end"]
        k = 0
        while True:
            rec = Call(client=i, start=time.perf_counter())
            if rec.start >= end:
                return
            try:
                call(i, k, rec)
                rec.ok = True
            except Exception as e:  # a failed call counts against the run
                rec.error = f"{type(e).__name__}: {e}"[:300]
            rec.end = rec.end or time.perf_counter()
            records[i].append(rec)
            k += 1

    threads = [threading.Thread(target=client, args=(i,), name=f"pb-client-{i}")
               for i in range(clients)]
    for t in threads:
        t.start()
    ctx = torch.profiler.record_function(annotate) if annotate else contextlib.nullcontext()
    with ctx:
        start = time.perf_counter()
        window["end"] = start + seconds
        gate.wait()
        for t in threads:
            t.join()
    calls = sorted((c for r in records for c in r), key=lambda c: c.start)
    return Window(start=start, seconds=seconds, calls=calls)


def run_threads(n: int, fn) -> None:
    """``fn(i)`` for i < n on threads of their own; raises the first error."""
    errors = []

    def body(i):
        try:
            fn(i)
        except BaseException as e:  # handed to the caller below
            errors.append(e)

    threads = [threading.Thread(target=body, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
