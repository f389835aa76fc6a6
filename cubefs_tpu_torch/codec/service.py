"""Codec sidecar service: the cross-language boundary of the codec.

The port's counterpart of ``cubefs_tpu/codec/service.py``, the ``codec``
role of the server (``cmd.py``). Storage nodes that are not Python
offload EC math and CRCs here over the RPC transport (``utils/rpc.py``;
the reference's native C client speaks it too): shapes ride the JSON
args, shard bytes ride the body or a ``/dev/shm`` file. Every endpoint
takes the reference's arguments, makes its checks with its error codes
and messages, and answers with its meta and bytes.

Endpoints:
  engine          -> {engine: <name>, shm: true}
  encode          {n, m, shard_size, batch} + data shards -> parity
  reconstruct     {n, total, present, wanted, shard_size, batch} + survivors
  crc32           {block_len} + blocks -> <u4 CRCs
  verify          {n, m, shard_size, batch} + full stripes -> {ok: [...]}
  encode_shm, reconstruct_shm: the same math on a /dev/shm file

The engine is any of the codec's (``engine.py``): with ``cuda`` (the
default) the request's bytes are copied to the card (``hostio``) and the
shard math is kernel A; with a host engine or ``auto`` they stay in host
memory and the engine, or the leg ``auto`` routes each coalesced step
to, does the math (``auto``'s ``cuda`` leg copies through ``hostio``
itself). ``auto`` loads the persisted crossover table when the service
starts. Either way the math goes through the admission layer (``admit``:
stripes of concurrent callers with one geometry coalesce into one step).
CRCs are kernel B, except under ``numpy``, where they are zlib's, as in
the reference. ``device="cpu"`` runs the kernels' plain versions. No
error moves a call to another leg: a failing kernel answers 500 with its
error.
"""

from __future__ import annotations

import os
import zlib

import numpy as np
import torch

from .. import device as devlib
from ..ops import crc32_kernel, rs_kernel
from ..utils import metrics, rpc
from . import engine as engines
from . import hostio
from .batcher import admit

SHM_PREFIX = "/dev/shm/cubefs-codec-"


def _pos_int(args, name: str, default: int | None = None) -> int:
    """RPC arg as a positive int, or a 400: a non-positive n, m,
    shard_size or batch fails at the boundary, not deep in the engine."""
    try:
        v = int(args.get(name, default) if default is not None else args[name])
    except (KeyError, TypeError, ValueError):
        raise rpc.RpcError(400, f"missing/non-integer arg {name!r}") from None
    if v < 1:
        raise rpc.RpcError(400, f"{name}={v} must be >= 1")
    return v


def _index_list(args, name: str, total: int) -> list[int]:
    """RPC arg as a list of distinct shard indices in [0, total), or 400."""
    try:
        idx = [int(i) for i in args[name]]
    except (KeyError, TypeError, ValueError):
        raise rpc.RpcError(400, f"missing/non-integer arg {name!r}") from None
    bad = [i for i in idx if not 0 <= i < total]
    if bad:
        raise rpc.RpcError(400, f"{name} indices {bad} out of range [0, {total})")
    if len(set(idx)) != len(idx):
        raise rpc.RpcError(400, f"{name} carries duplicate indices")
    return idx


def _reconstruct_args(args, unsorted: str) -> tuple[int, int, list[int], list[int]]:
    """n, total, present and wanted of a reconstruct, or a 400 (with
    ``unsorted`` as the message when ``present`` is not ascending: the
    rows are built for ascending shard order, and another order of the
    survivors would corrupt the output)."""
    n, total = _pos_int(args, "n"), _pos_int(args, "total")
    if total < n:
        raise rpc.RpcError(400, f"total {total} < n {n}")
    present = _index_list(args, "present", total)
    wanted = _index_list(args, "wanted", total)
    if present != sorted(present):
        raise rpc.RpcError(400, unsorted)
    if len(present) < n:
        raise rpc.RpcError(400, f"only {len(present)} survivors < n {n}")
    return n, total, present, wanted


class CodecService:
    def __init__(self, engine: str = "cuda", device=None):
        self.device = devlib.resolve(device)  # raises without a card
        self.engine = engines.get_engine(engine, self.device)
        self.host = self.engine.name != "cuda"  # the request's stripes stay on the host
        self.codec = admit(self.device, engine=self.engine.name)
        if self.engine.name == "auto":
            engines._load_policy(self.device)

    def _stripes(self, buf, shape: tuple):
        """The request's bytes as (B, rows, S) stripes: copied to the
        device for ``cuda``, a read-only numpy view for the others."""
        if self.host:
            return np.frombuffer(buf, dtype=np.uint8).reshape(shape)
        return hostio.to_device(buf, shape, self.device)

    @staticmethod
    def _bytes(y) -> bytes:
        if isinstance(y, torch.Tensor):
            return hostio.to_host(y).numpy().tobytes()
        return np.ascontiguousarray(y).tobytes()

    @staticmethod
    def _write(y, dst: np.ndarray) -> None:
        if isinstance(y, torch.Tensor):
            hostio.to_host(y, out=dst)
        else:
            dst[:] = y.reshape(-1)

    # ---------------- RPC surface ----------------
    def rpc_engine(self, args, body):
        # shm: co-located clients may pass shards in a /dev/shm file
        return {"engine": self.engine.name, "shm": True}

    def _shm_map(self, args, need: int) -> np.memmap:
        path = str(args["shm"])
        # a bare filename after the prefix: a '/' could route through a
        # symlinked directory, which O_NOFOLLOW (last component) misses
        if not path.startswith(SHM_PREFIX) or "/" in path[len(SHM_PREFIX):]:
            raise rpc.RpcError(400, f"shm path must be a file directly under {SHM_PREFIX}*")
        try:
            # O_NOFOLLOW: a symlink planted at a cubefs-codec-* name must
            # not make the service map an arbitrary file
            fd = os.open(path, os.O_RDWR | os.O_NOFOLLOW)
            with os.fdopen(fd, "r+b") as f:
                mm = np.memmap(f, dtype=np.uint8, mode="r+")
        except (OSError, ValueError) as e:
            raise rpc.RpcError(400, f"shm map failed: {e}") from None
        if mm.size < need:
            raise rpc.RpcError(400, f"shm {mm.size}B < required {need}B")
        return mm

    def _reconstruct(self, n, total, present, wanted, surv: torch.Tensor) -> torch.Tensor:
        rows = rs_kernel.reconstruct_rows(n, total, present, wanted)
        return self.codec.matrix_apply(rows, surv)

    def rpc_encode_shm(self, args, body):
        """Shared-memory encode for co-located clients: data shards at
        offset 0 of a /dev/shm file, parity written right after them."""
        n, m = _pos_int(args, "n"), _pos_int(args, "m")
        s = _pos_int(args, "shard_size")
        b = _pos_int(args, "batch", default=1)
        in_bytes, out_bytes = b * n * s, b * m * s
        mm = self._shm_map(args, in_bytes + out_bytes)
        data = self._stripes(mm[:in_bytes], (b, n, s))
        self._write(self.codec.encode_parity(data, m), mm[in_bytes:in_bytes + out_bytes])
        mm.flush()
        metrics.codec_bytes.inc(in_bytes, op="encode_shm", engine=self.engine.name)
        return {"shape": [b, m, s], "offset": in_bytes}

    def rpc_reconstruct_shm(self, args, body):
        """Shared-memory reconstruct: survivors at offset 0 (rows in
        ascending ``present`` order), the ``wanted`` rows written after."""
        n, total, present, wanted = _reconstruct_args(args, "present must be sorted ascending")
        s = _pos_int(args, "shard_size")
        b = _pos_int(args, "batch", default=1)
        in_bytes, out_bytes = b * n * s, b * len(wanted) * s
        mm = self._shm_map(args, in_bytes + out_bytes)
        surv = self._stripes(mm[:in_bytes], (b, n, s))
        self._write(self._reconstruct(n, total, present, wanted, surv),
                    mm[in_bytes:in_bytes + out_bytes])
        mm.flush()
        metrics.codec_bytes.inc(in_bytes, op="reconstruct_shm", engine=self.engine.name)
        return {"shape": [b, len(wanted), s], "offset": in_bytes}

    def rpc_encode(self, args, body):
        n, m = _pos_int(args, "n"), _pos_int(args, "m")
        s = _pos_int(args, "shard_size")
        b = _pos_int(args, "batch", default=1)
        expect = b * n * s
        if len(body) != expect:
            raise rpc.RpcError(400, f"body {len(body)}B != batch*n*shard {expect}B")
        parity = self.codec.encode_parity(self._stripes(body, (b, n, s)), m)
        metrics.codec_bytes.inc(len(body), op="encode", engine=self.engine.name)
        return {"shape": [b, m, s]}, self._bytes(parity)

    def rpc_reconstruct(self, args, body):
        n, total, present, wanted = _reconstruct_args(
            args, "present must be sorted ascending and body rows must follow that order")
        s = _pos_int(args, "shard_size")
        b = _pos_int(args, "batch", default=1)
        if len(body) != b * n * s:
            raise rpc.RpcError(400, "body size mismatch")
        surv = self._stripes(body, (b, n, s))
        rec = self._reconstruct(n, total, present, wanted, surv)
        metrics.codec_bytes.inc(len(body), op="reconstruct", engine=self.engine.name)
        return {"shape": [b, len(wanted), s]}, self._bytes(rec)

    def rpc_crc32(self, args, body):
        block = int(args["block_len"])
        if block <= 0 or len(body) % block:
            raise rpc.RpcError(400, f"body not a multiple of block {block}")
        if self.engine.name == "numpy":  # the host golden engine: host CRCs too
            crcs = np.asarray([zlib.crc32(body[i:i + block]) for i in range(0, len(body), block)],
                              dtype="<u4")
        else:
            blocks = hostio.to_device(body, (len(body) // block, block), self.device)
            # int64 holding the unsigned CRC: exact as <u4, 2^31 and above too
            crcs = hostio.to_host(crc32_kernel.crc32_blocks(blocks)).numpy().astype("<u4")
        metrics.codec_bytes.inc(len(body), op="crc32", engine=self.engine.name)
        return {"count": len(crcs)}, crcs.tobytes()

    def rpc_verify(self, args, body):
        n, m = _pos_int(args, "n"), _pos_int(args, "m")
        s = _pos_int(args, "shard_size")
        b = _pos_int(args, "batch", default=1)
        if len(body) != b * (n + m) * s:
            raise rpc.RpcError(400, "body size mismatch")
        stripes = self._stripes(body, (b, n + m, s))
        parity = self.codec.encode_parity(stripes[:, :n], m)
        metrics.codec_bytes.inc(len(body), op="verify", engine=self.engine.name)
        if self.host:
            return {"ok": [bool(x) for x in (parity == stripes[:, n:]).reshape(b, -1).all(1)]}
        ok = (parity == stripes[:, n:]).flatten(1).all(1)  # compared on the device
        return {"ok": hostio.to_host(ok).tolist()}
