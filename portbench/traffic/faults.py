"""Faults planted under a cell's timed path, for the checks' own tests:
each replaces the program's GF(2^8) apply (``rs_kernel.gf_matrix_apply``,
which every encode and decode of the cells reaches) with a broken one.
A sound check reads a run with any of them as not correct.

- ``unchanged``: the step returns its state unchanged: nothing is
  written (``out`` keeps what it held; a new result is zeros).
- ``half``: only the first half of the batch is computed (of the bytes,
  for a batch of one stripe), the rest left as it was.
- ``altered``: the answer is computed, then one byte of it altered.

The exchange between chips does not exist on these one-chip cells.
"""

from __future__ import annotations

import contextlib

import torch

from cubefs_tpu_torch.ops import rs_kernel

FAULTS = ("unchanged", "half", "altered")


def _broken(kind: str, apply):
    def fault(coeff, shards, out=None):
        shape = (*shards.shape[:-2], coeff.shape[0], shards.shape[-1])
        y = out if out is not None else torch.zeros(shape, dtype=torch.uint8,
                                                    device=shards.device)
        if kind == "unchanged":
            return y
        if kind == "half":
            x = shards.reshape(-1, *shards.shape[-2:])
            y3 = y if y.dim() == 3 else y.view(-1, *shape[-2:])
            if x.shape[0] > 1:  # the first half of the stripes
                keep = (x.shape[0] + 1) // 2
                y3[:keep] = apply(coeff, x[:keep])
            else:  # one stripe: the first half of its bytes
                keep = (x.shape[-1] + 1) // 2
                y3[..., :keep] = apply(coeff, x[..., :keep].contiguous())
            return y
        y = apply(coeff, shards, out=out)
        y[(0,) * (y.dim() - 1) + (y.shape[-1] // 2,)] ^= 1
        return y

    return fault


@contextlib.contextmanager
def planted(kind: str):
    """The fault ``kind`` in place of the program's apply, for the block."""
    if kind not in FAULTS:
        raise ValueError(f"unknown fault {kind!r}; have {FAULTS}")
    orig = rs_kernel.gf_matrix_apply
    rs_kernel.gf_matrix_apply = _broken(kind, orig)
    try:
        yield
    finally:
        rs_kernel.gf_matrix_apply = orig
