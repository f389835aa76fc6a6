"""PUT encode at the access's codec entry: a closed loop of callers, each
encoding one object's host stack a call, as ``AccessHandler._put``
does: the (ceil(size / blob_size), total, S) stack filled from the
payload (data rows, zero padding), then
``encoder.encode_async(stack).wait()``, which stages the stack to the
card, runs the parity step (coalesced with other callers' in the
batcher) and copies the parity rows back into the stack.

Parameters: ``clients``; object sizes of ``min_units`` to ``max_units``
whole units of ``unit`` bytes, every size once a round in an order
drawn from the seed per client; ``sample_every`` and
``samples_per_client`` (``harness.Sampler``: the calls that keep their
parity for the check). Payloads are slices, at offsets drawn from the
seed, of one random buffer made from the seed on the card. Each client
reuses one stack, as large as the largest object.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import harness
from portbench.reference.codes import Code

from . import program
from .substitute import ControlEncoder


class Cell:
    def __init__(self, cfg: dict, params: dict, seed: int, device, control: bool = False):
        self.cfg, self.p, self.seed = cfg, params, seed
        self.device = torch.device(device)
        self.control = control
        self.clients = params["clients"]
        self.code = Code.of(cfg)
        self.blob = cfg["blob_size"]
        self.s = -(-self.blob // self.code.n)

    def setup(self) -> None:
        p, unit = self.p, self.p["unit"]
        self.phases = harness.Phases()
        with self.phases("inputs"):
            sizes = [u * unit for u in range(p["min_units"], p["max_units"] + 1)]
            self.biggest = max(sizes)
            self.src = harness.seeded_bytes(self.seed, 0, 2 * self.biggest,
                                            self.device).cpu().numpy()
            self.plans = []
            for i in range(self.clients):
                rng = np.random.default_rng([self.seed, i])
                self.plans.append((rng, list(rng.permutation(sizes))))
            nb = -(-self.biggest // self.blob)
            self.stacks = [np.zeros((nb, self.code.total, self.s), dtype=np.uint8)
                           for _ in range(self.clients)]
            self.sampler = harness.Sampler(self.seed, self.clients, p["sample_every"],
                                           p["samples_per_client"])
        with self.phases("program"):
            self.enc = (ControlEncoder(self.cfg, self.device) if self.control
                        else program.encoder(self.cfg, self.device))
        # warm: every client's stack at its largest, all at once, twice
        for r in range(2):
            with self.phases(f"warm{r}"):
                harness.run_threads(self.clients, lambda i: self._encode(i, self.biggest, 0))

    def _fill(self, stack: np.ndarray, size: int, off: int) -> int:
        n, nb = self.code.n, -(-size // self.blob)
        for j in range(nb):
            chunk = self.src[off + j * self.blob: off + min((j + 1) * self.blob, size)]
            flat = stack[j, :n].reshape(-1)
            flat[:chunk.size] = chunk
            flat[chunk.size:] = 0
        return nb

    def _encode(self, i: int, size: int, off: int) -> np.ndarray:
        stack = self.stacks[i][:self._fill(self.stacks[i], size, off)]
        self.enc.encode_async(stack).wait()
        return stack

    def call(self, i: int, k: int, rec: harness.Call) -> None:
        rng, sizes = self.plans[i]
        size = int(sizes[k % len(sizes)])
        off = int(rng.integers(0, self.src.size - size + 1))
        with rec.span("pb.fill"):
            nb = self._fill(self.stacks[i], size, off)
        stack = self.stacks[i][:nb]
        rec.start = time.perf_counter()
        with rec.span("pb.encode"):
            self.enc.encode_async(stack).wait()
        rec.end = time.perf_counter()
        rec.nbytes = size
        rec.work = [(self.code.m + self.code.l, self.code.n, self.s, nb)]
        if self.sampler.keep(i, k, rec):
            rec.sample = (size, off, stack[:, self.code.n:].copy())

    def counters(self):
        return program.counters()

    def release(self) -> None:
        self.enc = None
        self.stacks = None

    def check(self, window: harness.Window) -> list[tuple]:
        """Every kept call's parity rows against the reference's encode of
        the same payload."""
        bad, checked = 0, 0
        for c in window.calls:
            if not (c.ok and c.sample is not None):
                continue
            size, off, parity = c.sample
            stack = np.zeros((-(-size // self.blob), self.code.total, self.s), dtype=np.uint8)
            self._fill(stack, size, off)
            data = torch.from_numpy(stack[:, :self.code.n]).to(self.device)
            ref = self.code.parity(data).cpu().numpy()
            bad += int(np.count_nonzero(ref != parity))
            checked += 1
        return [("mismatched_parity_bytes", bad, 0, "max"),
                ("failed_calls", sum(not c.ok for c in window.calls), 0, "max"),
                ("checked_calls", checked, 1, "min")]

    def close(self) -> None:
        self.release()
