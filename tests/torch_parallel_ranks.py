"""Rank bodies for tests/test_torch_parallel.py, and the global inputs of
its cases.

They live apart from that test module, which imports JAX, so that a
spawned rank, which imports the module of the function it runs,
imports only torch and the port."""

import os
import sys
import time

import torch
import torch.distributed as dist

from cubefs_tpu_torch.models import repair
from cubefs_tpu_torch.parallel import dryrun, sharded_codec
from cubefs_tpu_torch.parallel import mesh as meshlib


def case_input(case: dict, device: torch.device):
    """The global input of one ``outputs`` case: data (b, n, s) for
    "encode", segments (rows, len) for "crc", the first n survivors
    (b, n, s) of encoded stripes for "repair"."""
    if case["op"] == "encode":
        return dryrun.random_bytes(case["seed"], (case["b"], case["n"], case["s"]))
    if case["op"] == "crc":
        return dryrun.random_bytes(case["seed"], (case["rows"], case["len"]))
    if case["op"] == "repair":
        plan = repair.make_plan(case["n"], case["m"], case["bad"])
        st = dryrun.global_stripes(case["seed"], case["b"], case["n"], case["m"], case["s"],
                                   device)
        return st[:, list(plan.present[: case["n"]])]
    raise ValueError(f"unknown op {case['op']!r}")


def outputs(device: torch.device, cases: list[dict], runs: list[dict]) -> dict:
    """This rank's blocks of single sharded calls, as numpy arrays, one
    dict per case: "encode" (``encode_sharded``: parity), "crc"
    (``crc32_sharded``: crcs), "repair" (``sharded_repair_step``:
    recovered, crcs). A case's mesh is built from its "dims" on first
    use, in case order (every rank builds the same meshes in the same
    order). Then ``dryrun.multichip`` on ``runs``, and the top-level
    modules the rank has loaded."""
    meshes, out = {}, []
    for case in cases:
        key = tuple(case["dims"][a] for a in meshlib.AXES)
        if key not in meshes:
            meshes[key] = meshlib.make_mesh(case["dims"], device)
        mesh = meshes[key]
        res = {"coords": mesh.coords}
        if case["op"] == "encode":
            local = meshlib.local_block(mesh, case_input(case, device))
            res["parity"] = sharded_codec.encode_sharded(mesh, case["n"], case["m"])(local)
        elif case["op"] == "crc":
            local = meshlib.local_block(mesh, case_input(case, device), ("dp", "sp"))
            res["crcs"] = sharded_codec.crc32_sharded(mesh, case["len"])(local)
        else:
            plan = repair.make_plan(case["n"], case["m"], case["bad"])
            local = meshlib.local_block(mesh, case_input(case, device))
            res["recovered"], res["crcs"] = repair.sharded_repair_step(mesh, plan, local)
        out.append({k: v.cpu().numpy() if torch.is_tensor(v) else v for k, v in res.items()})
    return {"cases": out, "multichip": dryrun.multichip(device, runs),
            "modules": sorted({name.split(".")[0] for name in sys.modules})}


def raise_on_rank(device, bad_rank: int) -> int:
    """``bad_rank`` raises; the others wait on, for a peer that never
    comes."""
    if dist.get_rank() == bad_rank:
        raise ValueError(f"rank {bad_rank} fails on purpose")
    time.sleep(600.0)
    return dist.get_rank()


def exit_on_rank(device, bad_rank: int) -> int:
    """``bad_rank`` dies without a word; the others wait on."""
    if dist.get_rank() == bad_rank:
        os._exit(3)
    time.sleep(600.0)
    return dist.get_rank()


def sleep(device, seconds: float) -> None:
    time.sleep(seconds)
