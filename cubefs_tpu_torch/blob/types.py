"""Blob-plane wire types (role parity: blobstore/api/access location
types and clustermgr volume/disk records; reimagined as plain
dataclasses with dict round-trip for the JSON RPC layer).

The port's copy of ``cubefs_tpu/blob/types.py``, with the same behaviour.
"""

from __future__ import annotations

import enum
from dataclasses import asdict, dataclass, field

from ..codec import codemode as cm


class DiskStatus(enum.IntEnum):
    NORMAL = 1
    BROKEN = 2
    REPAIRING = 3
    REPAIRED = 4
    DROPPED = 5
    # limping disk (IO errors / latency outlier): serves existing data
    # but gets no new allocations — topology's NORMAL filter excludes
    # it from placement; probe-based return to NORMAL via heartbeat
    QUARANTINED = 6


class VolumeStatus(enum.IntEnum):
    IDLE = 1
    ACTIVE = 2
    LOCK = 3
    UNLOCKING = 4


@dataclass
class DiskInfo:
    disk_id: int
    node_addr: str
    path: str
    status: int = DiskStatus.NORMAL
    chunk_count: int = 0
    free_chunks: int = 1 << 20
    last_heartbeat: float = 0.0
    # failure-domain labels (blob/topology.py): empty az means the
    # default AZ, empty rack means the host is its own rack
    az: str = ""
    rack: str = ""

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "DiskInfo":
        return cls(**d)


@dataclass
class VolumeUnit:
    """One shard slot of a volume: vuid index -> (disk, chunk)."""

    index: int
    disk_id: int
    chunk_id: int
    node_addr: str
    az: str = ""  # AZ of the disk at placement time (topology scoring)

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "VolumeUnit":
        return cls(**d)


@dataclass
class VolumeInfo:
    vid: int
    codemode: int
    units: list[VolumeUnit] = field(default_factory=list)
    status: int = VolumeStatus.IDLE
    used: int = 0
    epoch: int = 1  # bumped on unit relocation (repair writeback)

    @property
    def tactic(self) -> cm.Tactic:
        return cm.tactic(self.codemode)

    def to_dict(self) -> dict:
        d = asdict(self)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "VolumeInfo":
        d = dict(d)
        d["units"] = [VolumeUnit.from_dict(u) for u in d.get("units", [])]
        return cls(**d)


@dataclass
class Slice:
    """A run of consecutive BIDs in one volume (access location slice)."""

    min_bid: int
    vid: int
    count: int
    blob_size: int  # bytes of payload per blob except possibly the last

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Slice":
        return cls(**d)


@dataclass
class Location:
    """Returned by access PUT; everything GET/DELETE needs."""

    cluster_id: int
    codemode: int
    size: int
    slices: list[Slice] = field(default_factory=list)
    crc: int = 0  # crc32 of the whole payload

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Location":
        d = dict(d)
        d["slices"] = [Slice.from_dict(s) for s in d.get("slices", [])]
        return cls(**d)
