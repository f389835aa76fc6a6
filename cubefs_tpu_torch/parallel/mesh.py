"""The (dp, tp, sp) process mesh of the sharded codec step.

The port's counterpart of ``cubefs_tpu/parallel/mesh.py``. There a
``jax.sharding.Mesh`` places one array over the devices and XLA inserts
the collectives; here every rank of a ``torch.distributed`` world is
one cell of the mesh, holds only its own block of the stripes, and the
sharded functions (``parallel/sharded_codec.py``) call the collectives
on the sub-group of the axis they combine over:

  * ``dp`` - stripe batch (independent stripes, no communication)
  * ``tp`` - shard axis N (partial GF applies, XOR-combined over tp)
  * ``sp`` - byte axis of a shard (segment CRCs, folded over sp)

Ranks fill the mesh in row-major (dp, tp, sp) order, as the reference
reshapes its device list, so rank r sits at dp = r // (tp*sp),
tp = r // sp % tp, sp = r % sp.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from .. import device as device_mod

AXES = ("dp", "tp", "sp")
STRIPES = ("dp", "tp", "sp")  # (B, N, S) stripe stacks, the reference's stripe_sharding
ROWS = ("dp", None, "sp")  # (B, R, S) results: every tp rank holds all R rows


def factor_mesh(n_devices: int) -> dict[str, int]:
    """Split n devices over (dp, tp, sp), preferring dp > tp > sp but
    exercising every axis when the device count allows."""
    dims = {"dp": 1, "tp": 1, "sp": 1}
    remaining = n_devices
    for axis in ("tp", "sp"):
        if remaining % 2 == 0 and remaining > 1:
            dims[axis] = 2
            remaining //= 2
    dims["dp"] = remaining
    return dims


def coords(rank: int, dims: dict[str, int]) -> dict[str, int]:
    """Mesh coordinates of a rank (row-major over AXES)."""
    return {"dp": rank // (dims["tp"] * dims["sp"]),
            "tp": rank // dims["sp"] % dims["tp"], "sp": rank % dims["sp"]}


def axis_groups(dims: dict[str, int], axis: str) -> list[list[int]]:
    """The rank lists of an axis' sub-groups: the ranks that differ only in
    that coordinate, in ascending rank (and so coordinate) order."""
    ranks = np.arange(math.prod(dims[a] for a in AXES)).reshape([dims[a] for a in AXES])
    lines = np.moveaxis(ranks, AXES.index(axis), -1).reshape(-1, dims[axis])
    return [line.tolist() for line in lines]


class Mesh:
    """One rank's view of the mesh: its dims, its coordinates, its device
    and the process groups of its three axes (``None`` for an axis of
    size 1, which needs no collective)."""

    def __init__(self, dims: dict[str, int], rank: int, groups: dict, device: torch.device):
        self.dims = dims
        self.rank = rank
        self.coords = coords(rank, dims)
        self.groups = groups
        self.device = device


def make_mesh(dims: dict[str, int] | None = None,
              device: str | torch.device | None = None) -> Mesh:
    """Build the (dp, tp, sp) mesh over the initialized default process
    group; ``dims`` overrides ``factor_mesh(world)`` (for example
    {"dp": 8, "tp": 1, "sp": 1}, a collective-free repair fleet).
    ``device`` is the rank's device (``None``: the current CUDA device).

    Every rank must call this with the same dims, in the same order as
    its other meshes: each rank creates every sub-group of the world."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized default process group")
    world, rank = dist.get_world_size(), dist.get_rank()
    if dims is None:
        dims = factor_mesh(world)
    elif set(dims) != set(AXES):
        raise ValueError(f"mesh dims {dims} must name exactly the axes {AXES}")
    dims = {a: int(dims[a]) for a in AXES}
    if math.prod(dims.values()) != world or min(dims.values()) < 1:
        raise ValueError(f"mesh dims {dims} != {world} ranks")
    dev = device_mod.resolve(device)
    groups = {}
    for axis in AXES:
        groups[axis] = None
        if dims[axis] == 1:
            continue
        for ranks in axis_groups(dims, axis):
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = group
    return Mesh(dims, rank, groups, dev)


def local_block(mesh: Mesh, x, spec: tuple = STRIPES) -> torch.Tensor:
    """This rank's block of a global array ``x`` (numpy or torch), laid
    out by ``spec``: one mesh axis (or ``None``, not split) per leading
    dim, as a ``PartitionSpec`` names them. Returned as a contiguous
    tensor on the mesh's device. Raises ValueError if a split dim does
    not divide by its axis."""
    if len(spec) > x.ndim:
        raise ValueError(f"spec {spec} has more dims than the array {tuple(x.shape)}")
    index = []
    for dim, axis in enumerate(spec):
        size = int(x.shape[dim])
        if axis is None:
            index.append(slice(None))
            continue
        n = mesh.dims[axis]
        if size % n:
            raise ValueError(f"dim {dim} of size {size} not divisible by {axis}={n}")
        at = mesh.coords[axis] * (size // n)
        index.append(slice(at, at + size // n))
    block = x[tuple(index)]
    if isinstance(block, np.ndarray):
        block = torch.from_numpy(np.ascontiguousarray(block))
    return block.to(mesh.device).contiguous()


def gather_rows(mesh: Mesh, local: torch.Tensor, spec: tuple = ROWS) -> torch.Tensor:
    """The global array whose ``spec`` block on each rank is ``local``
    (the inverse of ``local_block``), assembled on every rank by
    all-gathers over the split axes. For checks: it moves every block to
    every rank."""
    out = local.contiguous()
    for dim, axis in enumerate(spec):
        if axis is None or mesh.groups[axis] is None:
            continue
        parts = [torch.empty_like(out) for _ in range(mesh.dims[axis])]
        dist.all_gather(parts, out, group=mesh.groups[axis])
        out = torch.cat(parts, dim=dim)
    return out
