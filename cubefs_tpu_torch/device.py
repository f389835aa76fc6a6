"""Device resolution for the port's entry points.

Entry points run on the CUDA card unless the caller names the CPU. With
no card they raise: nothing drops quietly to the CPU, where only the
plain PyTorch versions of the kernels run.
"""

from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the current CUDA device; ``"cpu"`` selects the plain
    PyTorch path. Raises RuntimeError when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "the plain PyTorch path")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
