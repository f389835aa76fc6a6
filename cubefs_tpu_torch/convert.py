"""Carry the reference's device state across to the port.

This system has no weights. Its device state is a batch of stripes plus
the coefficient matrices derived from the codemode and the erasure
pattern. ``from_reference`` puts a stripe batch laid out as the JAX
package lays it out on the port's device, with the port's RepairPlan
built from the same numbers ``cubefs_tpu.models.repair.make_plan``
takes. ``bit_matrices`` returns the GF(2) matrices the plain versions
apply, so a test can hold them against the reference's, and
``bitmajor_operand`` (defined beside its kernel in ``ops/gf_bitmajor.py``)
the same GF(2) matrix in the order the tensor-core kernel reads it.
"""

from __future__ import annotations

import numpy as np
import torch

from . import device as devlib
from .models import repair
from .ops import crc32_kernel, rs_kernel
from .ops.gf_bitmajor import bitmajor_operand  # noqa: F401  (re-exported)


def from_reference(stripes: np.ndarray, n_data: int, n_parity: int, bad: list[int],
                   device: str | torch.device | None = None):
    """stripes: (B, n_data + n_parity, S) uint8 full stripes. Returns
    (surviving, plan): the present shards (B, P, S) in ascending index
    order on ``device``, ready for ``repair.repair_step``, and the plan."""
    stripes = np.asarray(stripes)
    if stripes.dtype != np.uint8 or stripes.ndim != 3 or stripes.shape[1] != n_data + n_parity:
        raise ValueError(f"stripes must be (B, {n_data + n_parity}, S) uint8, got "
                         f"{stripes.shape} {stripes.dtype}")
    plan = repair.make_plan(n_data, n_parity, bad)
    dev = devlib.resolve(device)
    surviving = torch.from_numpy(np.ascontiguousarray(stripes[:, list(plan.present)]))
    return surviving.to(dev), plan


def bit_matrices(coeff: np.ndarray, block_len: int,
                 chunk_len: int = crc32_kernel.CHUNK_LEN):
    """Returns (w, wt, shifts) as numpy:
    w (8R, 8C) int8, the plane-major GF(2) form of ``coeff``;
    wt (8L, 32) uint8, the plane-major transposed chunk matrix of the CRC
    of ``block_len``-byte blocks at L = fit_chunk_len(chunk_len, block_len);
    shifts (block_len // L, 32, 32) uint8, each chunk's zero-extension
    matrix to the end of its block."""
    length = crc32_kernel.fit_chunk_len(chunk_len, block_len)
    return (rs_kernel.coeff_bits(coeff),
            crc32_kernel._plane_major_wt(length),
            crc32_kernel.shift_matrices(length, block_len // length))
