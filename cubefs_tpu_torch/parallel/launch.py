"""Run a function on every rank of a fresh ``torch.distributed`` world.

``launch(fn, world, backend=..., device=...)`` starts ``world`` processes
with the ``spawn`` method (a forked child would inherit the parent's
CUDA state, which CUDA does not allow), initializes the default process
group in each from a file store in a private temporary directory (so
concurrent launches share no port), calls ``fn(device, *args)`` on
every rank and returns each rank's result with its kernel launch counts
(``_build.LAUNCHES``: per process, so read in the rank).

The backend and the device are the caller's: nothing here picks or
changes either. ``device=None`` puts rank r on CUDA device
r % device_count (all ranks share the one card of a one-card machine,
which the gloo backend allows and NCCL does not); ``"cpu"`` runs the
plain PyTorch path.

A rank that raises, or dies, fails the launch at once:
``torch.multiprocessing``'s process context kills every other child and
raises with the rank's traceback, so ranks left waiting in a collective
do not hold the caller. So does the ``deadline``. The ``timeout`` bounds
the process group's own waits inside each rank.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..ops import _build

BACKENDS = ("gloo", "nccl")


class RankResult(NamedTuple):
    result: object
    launches: dict[str, int]


def _rank_device(device, rank: int) -> torch.device:
    if device is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device(device)


def _rank_main(rank: int, world: int, backend: str, device, store: str, timeout: float,
               fn, args: tuple, results) -> None:
    """A child's body: join the world, run ``fn``, post the result. A
    failure propagates: the process context reports it to the parent
    (the group is left only on success, so a rank that fails is the
    first to go)."""
    dev = _rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:  # the ranks share the host's cores: one slice each, not all each
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout))
    out = fn(dev, *args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    results.put((rank, RankResult(out, dict(_build.LAUNCHES))))
    dist.destroy_process_group()


def launch(fn, world: int, *, backend: str, device: str | torch.device | None = None,
           args: tuple = (), deadline: float = 300.0, timeout: float = 120.0
           ) -> list[RankResult]:
    """Run ``fn(device, *args)`` on ``world`` spawned ranks; return their
    ``RankResult``s in rank order.

    ``fn`` and ``args`` are pickled into each child, so ``fn`` must be a
    module-level function that the child can import (a child imports
    only what ``fn``'s module imports: keep it away from JAX).
    Raises RuntimeError if a rank raises or dies (with its traceback) and
    TimeoutError if the ranks have not all returned within ``deadline``
    seconds; either way every child is killed first."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    if (device is None or torch.device(device).type == "cuda") and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the "
                           "plain PyTorch path")
    results = mp.get_context("spawn").SimpleQueue()
    out: list[RankResult | None] = [None] * world
    end = time.monotonic() + deadline
    with tempfile.TemporaryDirectory(prefix="cubefs-launch-") as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(world, backend, device, os.path.join(tmp, "store"), timeout, fn,
                              args, results),
            nprocs=world, join=False, daemon=True, start_method="spawn")
        try:
            # read results while joining: a rank blocks on a result that
            # overflows the pipe until it is read
            while True:
                while not results.empty():
                    rank, res = results.get()
                    out[rank] = res
                if ctx.join(timeout=0.1):
                    break
                if time.monotonic() > end:
                    waiting = [r for r, x in enumerate(out) if x is None]
                    raise TimeoutError(f"ranks {waiting} of {world} did not return within "
                                       f"{deadline} s")
        except mp.ProcessRaisedException as e:
            raise RuntimeError(f"rank {e.error_index} of {world} failed:{e}") from None
        except mp.ProcessExitedException as e:
            raise RuntimeError(f"rank {e.error_index} of {world} died (exit code "
                               f"{e.exit_code})") from None
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
    while not results.empty():
        rank, res = results.get()
        out[rank] = res
    results.close()
    return out
