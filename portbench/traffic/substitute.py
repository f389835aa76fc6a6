"""The control: the plain reference put in the program's codec's place,
with the guarantee the configuration states broken (every parity row
the XOR of the data rows, every rebuilt row the XOR of the survivors).
The same surfaces as the program's, over host stripes, computed on the
run's device. A sound check has to read such a run as not correct."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from portbench.reference import gf256
from portbench.reference.codes import Code


class _Done:
    def __init__(self, stripes):
        self.stripes = stripes

    def wait(self, timeout: float = 120.0):
        return self.stripes


class ControlEncoder:
    """``encode_async`` and ``reconstruct_data`` of an encoder."""

    def __init__(self, cfg: dict, device):
        self.code = Code.of(cfg, xor=True)
        self.device = torch.device(device)
        c = self.code
        self.t = SimpleNamespace(n=c.n, m=c.m, l=c.l, total=c.total, az_count=c.az_count)

    def shard_size(self, data_len: int) -> int:
        return -(-data_len // self.code.n)

    def encode_async(self, stripes: np.ndarray) -> _Done:
        n = self.code.n
        data = torch.from_numpy(np.ascontiguousarray(stripes[..., :n, :])).to(self.device)
        flat = data.reshape(-1, n, data.shape[-1])
        stripes[..., n:, :] = self.code.parity(flat).cpu().numpy().reshape(
            stripes[..., n:, :].shape)
        return _Done(stripes)

    def reconstruct_data(self, stripe: np.ndarray, bad_idx: list[int]) -> np.ndarray:
        n, glob = self.code.n, self.code.n + self.code.m
        solve = [i for i in range(glob) if i not in set(bad_idx)][:n]
        wanted = sorted(i for i in set(bad_idx) if i < n)
        x = torch.from_numpy(np.ascontiguousarray(stripe[solve])).to(self.device)
        stripe[wanted] = self.code.rebuild(x[None], solve, wanted)[0].cpu().numpy()
        return stripe


class ControlEngine:
    """``matrix_apply`` of an admitted engine: each output row the XOR
    of the input rows, whatever the rows asked for."""

    def __init__(self, device):
        self.device = torch.device(device)

    def matrix_apply(self, coeff: np.ndarray, shards: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(shards)).to(self.device)
        ones = np.ones(np.shape(coeff), dtype=np.uint8)
        return gf256.apply(ones, x.reshape(-1, *x.shape[-2:])).cpu().numpy().reshape(
            *shards.shape[:-2], ones.shape[0], shards.shape[-1])
