"""Device resolution shared by every entry point of the package."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None):
    """``device`` as a ``torch.device``; ``None`` means ``cuda``.

    The port runs on the card unless the caller asks for the CPU, so a
    CUDA device without a card raises here instead of quietly running on
    the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        if dev.index is None:   # 'cuda' names the current card
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
