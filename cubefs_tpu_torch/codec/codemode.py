"""Codemode registry: declarative EC layouts and stripe geometry.

The port's own copy of ``cubefs_tpu/codec/codemode.py`` (CodeMode,
Tactic, tactic(), Policy, select_codemode()), which mirrors the
reference's public codemode surface
(blobstore/common/codemode/codemode.go). The values are protocol
constants of the system, not code.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass

ALIGN_0B = 0
ALIGN_512B = 512
ALIGN_2KB = 2048


class CodeMode(enum.IntEnum):
    EC15P12 = 1
    EC6P6 = 2
    EC16P20L2 = 3
    EC6P10L2 = 4
    EC6P3L3 = 5
    EC6P6Align0 = 6
    EC6P6Align512 = 7
    EC4P4L2 = 8
    EC12P4 = 9
    EC16P4 = 10
    EC3P3 = 11
    EC10P4 = 12
    EC6P3 = 13
    EC12P9 = 14
    EC24P8 = 15
    EC6P6MSR = 16
    EC6P6MSROneAZ = 17
    Replica3 = 100
    Replica3OneAZ = 101
    # test-only modes
    EC6P6L9 = 200
    EC6P8L10 = 201
    Replica4TwoAZ = 202
    EC4P4MSR = 203


@dataclass(frozen=True)
class Tactic:
    """Constant strategy of one CodeMode: N data / M global parity /
    L local parity shards over az_count AZs; put_quorum must keep data
    recoverable with one AZ down (ignoring local shards).

    scheme selects the code family: "rs" (Reed-Solomon / LRC) or "msr"
    (product-matrix MSR regenerating code). MSR tactics carry d, the
    helper count of a single-shard repair."""

    n: int
    m: int
    l: int = 0
    az_count: int = 1
    put_quorum: int = 0
    get_quorum: int = 0
    min_shard_size: int = 0
    scheme: str = "rs"
    d: int = 0

    def __post_init__(self):
        if self.az_count < 1:
            raise ValueError(f"az_count must be >= 1, got {self.az_count}")
        for name, v in (("n", self.n), ("m", self.m), ("l", self.l)):
            if v % self.az_count:
                raise ValueError(
                    f"Tactic {name}={v} is not divisible by "
                    f"az_count={self.az_count}: ec_layout_by_az would "
                    f"silently truncate shards")
        if self.scheme not in ("rs", "msr"):
            raise ValueError(f"unknown code scheme {self.scheme!r}")
        if self.scheme == "rs":
            if self.d:
                raise ValueError("d (helper count) is only meaningful "
                                 "for scheme='msr'")
            return
        self._validate_msr()

    def _validate_msr(self) -> None:
        """Reject MSR geometries the product-matrix construction cannot
        build or the blob plane cannot repair."""
        if self.l:
            raise ValueError(
                "MSR tactics do not compose with LRC local parity: the "
                "sub-shard repair protocol replaces the local stripe")
        k, total, d = self.n, self.n + self.m, self.d
        if k < 2:
            raise ValueError(f"MSR needs k >= 2 data shards, got k={k}")
        if d < k:
            raise ValueError(
                f"MSR d={d} < k={k}: a regenerating repair needs at "
                f"least as many helpers as a conventional decode")
        if d >= total:
            raise ValueError(
                f"MSR d={d} >= total={total}: helpers must be "
                f"surviving shards, so d can be at most total-1")
        if d < 2 * k - 2:
            raise ValueError(
                f"product-matrix MSR exists only for d >= 2k-2 = "
                f"{2 * k - 2}, got d={d}")
        alpha = d - k + 1
        nbar = total + (d - (2 * k - 2))
        if nbar > 255 // math.gcd(alpha, 255):
            raise ValueError(
                f"GF(256) admits only {255 // math.gcd(alpha, 255)} "
                f"nodes with distinct lambda^{alpha} values; this "
                f"geometry needs {nbar}")
        if self.az_count > 1:
            local = total // self.az_count - 1
            cross = d - local
            if cross < 0 or cross % (self.az_count - 1):
                raise ValueError(
                    f"MSR d={d} is AZ-indivisible: after the {local} "
                    f"AZ-local survivors, {cross} cross-AZ helpers "
                    f"cannot spread evenly over {self.az_count - 1} "
                    f"remote AZs")

    @property
    def alpha(self) -> int:
        """Sub-shards per shard (MSR); 1 for RS/LRC tactics."""
        return self.d - self.n + 1 if self.scheme == "msr" else 1

    def is_msr(self) -> bool:
        return self.scheme == "msr"

    @property
    def total(self) -> int:
        return self.n + self.m + self.l

    def is_replicate(self) -> bool:
        return self.m == 0 and self.l == 0

    def ec_layout_by_az(self) -> list[list[int]]:
        """Shard indices per AZ: each AZ gets a contiguous slice of data,
        global-parity and local-parity index ranges."""
        n, m, l = self.n // self.az_count, self.m // self.az_count, self.l // self.az_count
        stripes = []
        for az in range(self.az_count):
            stripe = [az * n + i for i in range(n)]
            stripe += [self.n + az * m + i for i in range(m)]
            stripe += [self.n + self.m + az * l + i for i in range(l)]
            stripes.append(stripe)
        return stripes

    def global_stripe(self) -> tuple[list[int], int, int]:
        return list(range(self.n + self.m)), self.n, self.m

    def local_stripe_in_az(self, az: int) -> tuple[list[int], int, int]:
        if self.l == 0:
            return [], 0, 0
        n, m, l = self.n // self.az_count, self.m // self.az_count, self.l // self.az_count
        stripes = self.ec_layout_by_az()
        if not 0 <= az < len(stripes):
            return [], 0, 0
        return stripes[az], n + m, l

    def local_stripe(self, index: int) -> tuple[list[int], int, int]:
        if self.l == 0:
            return [], 0, 0
        n, m, l = self.n // self.az_count, self.m // self.az_count, self.l // self.az_count
        if index < self.n:
            az = index // n
        elif index < self.n + self.m:
            az = (index - self.n) // m
        elif index < self.total:
            az = (index - self.n - self.m) // l
        else:
            return [], 0, 0
        return self.local_stripe_in_az(az)

    def all_local_stripes(self) -> tuple[list[list[int]], int, int]:
        if self.l == 0:
            return [], 0, 0
        n, m, l = self.n // self.az_count, self.m // self.az_count, self.l // self.az_count
        return self.ec_layout_by_az(), n + m, l


TACTICS: dict[CodeMode, Tactic] = {
    # three az
    CodeMode.EC15P12: Tactic(15, 12, 0, 3, 24, 0, ALIGN_2KB),
    CodeMode.EC6P6: Tactic(6, 6, 0, 3, 11, 0, ALIGN_2KB),
    CodeMode.EC12P9: Tactic(12, 9, 0, 3, 20, 0, ALIGN_2KB),
    # two az
    CodeMode.EC16P20L2: Tactic(16, 20, 2, 2, 34, 0, ALIGN_2KB),
    CodeMode.EC6P10L2: Tactic(6, 10, 2, 2, 14, 0, ALIGN_2KB),
    # single az
    CodeMode.EC12P4: Tactic(12, 4, 0, 1, 15, 0, ALIGN_2KB),
    CodeMode.EC16P4: Tactic(16, 4, 0, 1, 19, 0, ALIGN_2KB),
    CodeMode.EC3P3: Tactic(3, 3, 0, 1, 5, 0, ALIGN_2KB),
    CodeMode.EC10P4: Tactic(10, 4, 0, 1, 13, 0, ALIGN_2KB),
    CodeMode.EC6P3: Tactic(6, 3, 0, 1, 8, 0, ALIGN_2KB),
    CodeMode.EC24P8: Tactic(24, 8, 0, 1, 30, 0, ALIGN_2KB),
    # product-matrix MSR regenerating codes (sub-shard repair)
    CodeMode.EC6P6MSR: Tactic(6, 6, 0, 3, 11, 0, ALIGN_2KB,
                              scheme="msr", d=11),
    CodeMode.EC6P6MSROneAZ: Tactic(6, 6, 0, 1, 11, 0, ALIGN_2KB,
                                   scheme="msr", d=10),
    # env-test modes
    CodeMode.EC6P3L3: Tactic(6, 3, 3, 3, 9, 0, ALIGN_2KB),
    CodeMode.EC6P6Align0: Tactic(6, 6, 0, 3, 11, 0, ALIGN_0B),
    CodeMode.EC6P6Align512: Tactic(6, 6, 0, 3, 11, 0, ALIGN_512B),
    CodeMode.EC4P4L2: Tactic(4, 4, 2, 2, 6, 0, ALIGN_2KB),
    CodeMode.EC6P6L9: Tactic(6, 6, 9, 3, 11, 0, ALIGN_2KB),
    CodeMode.EC6P8L10: Tactic(6, 8, 10, 2, 13, 0, ALIGN_0B),
    CodeMode.Replica4TwoAZ: Tactic(4, 0, 0, 2, 3),
    CodeMode.EC4P4MSR: Tactic(4, 4, 0, 1, 6, 0, ALIGN_0B,
                              scheme="msr", d=6),
    # replicate
    CodeMode.Replica3: Tactic(3, 0, 0, 3, 3),
    CodeMode.Replica3OneAZ: Tactic(3, 0, 0, 1, 3),
}


def tactic(mode: CodeMode | int | str) -> Tactic:
    if isinstance(mode, str):
        mode = CodeMode[mode]
    return TACTICS[CodeMode(mode)]


@dataclass
class Policy:
    """Size-class policy the access layer uses to pick a codemode per
    object size (reference: blobstore/common/codemode/policy.go)."""

    mode_name: str
    min_size: int = 0
    max_size: int = 1 << 62
    size_ratio: float = 0.0
    enable: bool = True


def select_codemode(policies: list[Policy], size: int) -> CodeMode:
    for p in policies:
        if p.enable and p.min_size <= size <= p.max_size:
            return CodeMode[p.mode_name]
    raise ValueError(f"no enabled codemode policy covers size {size}")
