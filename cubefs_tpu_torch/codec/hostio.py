"""Host buffers in and out of the device: the numpy/bytes <-> tensor
adaptor of the codec's host-facing callers.

The reference hands numpy arrays to its engines. The port's engines take
tensors on their device, so a caller that holds bytes (an RPC body), a
memoryview, a numpy array or a ``np.memmap`` slice (a ``/dev/shm`` file)
copies them in with ``to_device`` and the results out with ``to_host``.
``staged`` is the card's leg over a host stack, the one path from host
stripes to kernel A: one copy in, the work, one copy of the result out.

- Neither function aliases its source: ``np.frombuffer`` over a request
  body is read-only, and the engines write their outputs in place.
- Copies go through a pinned staging tensor of the calling thread
  (pageable memory cannot be copied asynchronously), on that thread's
  current stream of the tensor's device. The staging tensor grows to the
  largest request the thread has seen; before it is written again, its
  last upload must have finished (an event).
- ``to_host`` synchronises the current stream of the tensor's device,
  and nothing else.
- On ``device="cpu"`` the same code runs, with pageable staging: the
  copies are host copies.
"""

from __future__ import annotations

import threading

import numpy as np
import torch


class _Staging(threading.local):
    buf: torch.Tensor | None = None
    uploaded: torch.cuda.Event | None = None  # the last upload from ``buf``


_STAGING = _Staging()


def _stage(nbytes: int, pinned: bool) -> torch.Tensor:
    """The calling thread's staging bytes, at least ``nbytes`` long and
    free to write."""
    st = _STAGING
    if st.uploaded is not None:
        st.uploaded.synchronize()
        st.uploaded = None
    if st.buf is None or st.buf.numel() < nbytes or st.buf.is_pinned() != pinned:
        st.buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pinned)
    return st.buf[:nbytes]


def to_device(buf, shape: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """A new uint8 tensor of ``shape`` on ``device`` holding the bytes of
    ``buf`` (bytes, a memoryview, or a uint8 numpy array or memmap slice
    of any strides, read in C order), copied through the thread's staging
    tensor."""
    src = buf if isinstance(buf, np.ndarray) else np.frombuffer(buf, dtype=np.uint8)
    if src.dtype != np.uint8:
        raise ValueError(f"a host buffer must hold uint8, got {src.dtype}")
    if src.size != int(np.prod(shape)):
        raise ValueError(f"{src.size} bytes do not fill a {tuple(shape)} uint8 tensor")
    device = torch.device(device)
    out = torch.empty(shape, dtype=torch.uint8, device=device)
    if not src.size:
        return out
    stage = _stage(src.size, pinned=device.type == "cuda")
    np.copyto(stage.numpy().reshape(src.shape), src)
    out.view(-1).copy_(stage, non_blocking=True)
    if device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        _STAGING.uploaded = ev
    return out


def to_host(t: torch.Tensor, out: np.ndarray | None = None):
    """``t`` on the host, once the current stream of its device has run
    what it queued. With no ``out``: a new (pinned, for a CUDA tensor)
    host tensor of ``t``'s shape and dtype. With ``out``, a writable uint8
    numpy array or memmap view of ``t.numel()`` bytes: ``t`` (uint8) is
    copied into it through the thread's staging tensor, and ``out`` is
    returned."""
    cuda = t.device.type == "cuda"
    if out is None:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda)
        host.copy_(t, non_blocking=True)
    else:
        if t.dtype != torch.uint8 or out.dtype != np.uint8 or out.size != t.numel():
            raise ValueError(f"out ({out.dtype}, {out.size} elements) cannot take "
                             f"{t.dtype} {tuple(t.shape)}")
        host = _stage(t.numel(), pinned=cuda)
        host.copy_(t.reshape(-1), non_blocking=True)
    if cuda:
        torch.cuda.current_stream(t.device).synchronize()
    if out is None:
        return host
    np.copyto(out, host.numpy().reshape(out.shape))
    return out


def staged(x: np.ndarray, device, fn, out: np.ndarray | None = None) -> np.ndarray:
    """``fn`` run on the device over a host stack: ``x`` (a uint8 array of
    any strides) copied to ``device`` in one copy, and the uint8 tensor
    ``fn`` returns copied back in one copy into ``out`` (a writable array
    of its size, any strides), or into a new host tensor of its shape,
    returned as an array (pinned for a card: PyTorch's caching host
    allocator hands it out without the page faults of fresh memory)."""
    y = fn(to_device(x, x.shape, device))
    return to_host(y).numpy() if out is None else to_host(y, out=out)
