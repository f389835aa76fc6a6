"""A codemode's code, from its numbers alone: encode, and the rebuild of
lost shards from survivors. ``xor=True`` gives the control: the same
calls with every parity row the XOR of the data rows (a single-parity
code, the cheaper arithmetic a later change could be tempted by), which
breaks the codemode's guarantee that any ``m`` lost shards come back.

Tensors are (B, rows, S) uint8 on any device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import gf256


@dataclass(frozen=True)
class Code:
    n: int
    m: int
    l: int = 0
    az_count: int = 1
    xor: bool = False

    @classmethod
    def of(cls, cfg: dict, xor: bool = False) -> "Code":
        return cls(cfg["n"], cfg["m"], cfg.get("l", 0), cfg.get("az_count", 1), xor)

    @property
    def total(self) -> int:
        return self.n + self.m + self.l

    def layout(self) -> list[list[int]]:
        """Each AZ's shard indices: its data, global parity and local
        parity, as codemode.go's GetECLayoutByAZ lays them out."""
        n, m, l = (v // self.az_count for v in (self.n, self.m, self.l))
        return [[az * n + i for i in range(n)]
                + [self.n + az * m + i for i in range(m)]
                + [self.n + self.m + az * l + i for i in range(l)]
                for az in range(self.az_count)]

    def _apply(self, rows: np.ndarray, x: torch.Tensor) -> torch.Tensor:
        return gf256.apply(np.ones_like(rows) if self.xor else rows, x)

    def parity(self, data: torch.Tensor) -> torch.Tensor:
        """(B, n, S) data -> (B, m + l, S): the global parity, then each
        AZ's local parity over the AZ's data and global parity."""
        glob = self._apply(gf256.rs_matrix(self.n, self.n + self.m)[self.n:], data)
        if not self.l:
            return glob
        stripe = torch.cat([data, glob], dim=1)
        ln = (self.n + self.m) // self.az_count
        lm = self.l // self.az_count
        local = [self._apply(gf256.rs_matrix(ln, ln + lm)[ln:], stripe[:, az[:ln]])
                 for az in self.layout()]
        return torch.cat([glob, *local], dim=1)

    def rebuild(self, survivors: torch.Tensor, solve: list[int], wanted: list[int]
                ) -> torch.Tensor:
        """(B, n, S) shards ``solve`` of the global stripe (ascending) ->
        (B, len(wanted), S), the shards ``wanted`` (< n + m)."""
        return self._apply(gf256.decode_rows(self.n, self.n + self.m, solve, wanted),
                           survivors)
