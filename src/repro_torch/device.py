"""Device resolution shared by the port's entry points.

Entry points (``build_index``, ``QueryEngine``, the serving CLI) run on
``cuda`` unless the caller asks for the CPU. Without a card they raise:
they never drop to the CPU on their own.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def synchronize(dev: torch.device) -> None:
    """Wait for the work queued on ``dev`` (a no-op on the CPU), so a
    host clock around it measures the work and not its enqueue."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def canonical(device) -> torch.device:
    """``device`` with its index: a bare ``cuda`` is the current card
    (card 0 where none is visible), so that two names of one device
    compare equal, as the devices of tensors do."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device()
                            if torch.cuda.is_available() else 0)
    return dev
