"""Device selection for the port's entry points.

Entry points default to the GPU.  They never drop to the CPU quietly: a
caller that wants the CPU (the tests) says ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU")
    return dev


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for queued work on ``device`` (no-op on the CPU)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def canonical_device(device: DeviceLike = None) -> torch.device:
    """:func:`resolve_device` with the CUDA index made explicit (``cuda``
    -> ``cuda:<current>``), so two names of one card compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
