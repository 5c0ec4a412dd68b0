"""The port's device rule: explicit, `cuda` when not given, never a silent
fall back to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device`, or the GPU when None; raises when there is no GPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch path")
    return torch.device("cuda")
