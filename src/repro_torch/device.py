"""Device selection for the port's entry points.

Entry points run on the card by default.  A caller that wants the CPU (the
parity tests) asks for it explicitly; nothing here falls back on its own.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def default_device() -> torch.device:
    """The CUDA device entry points use when the caller names none.

    Raises ``RuntimeError`` when no CUDA device is present: a run that was
    meant for the card must not silently measure the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' explicitly to run "
            "the port's plain PyTorch versions on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> :func:`default_device`; anything else -> ``torch.device``.

    A CUDA device that does not exist raises here rather than at the first
    allocation."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
