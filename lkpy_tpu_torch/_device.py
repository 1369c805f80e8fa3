"""
Device resolution for the port's entry points.

Every entry point takes a ``device`` argument.  ``None`` means the card
(``cuda``); the CPU is used only when the caller asks for it by name, as the
tests do.  Without a card, asking for ``cuda`` raises: the port never goes
on quietly on the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``device`` says otherwise."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lkpy_tpu_torch runs on a CUDA device by default and none is available; "
            'pass device="cpu" to run on the CPU'
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
