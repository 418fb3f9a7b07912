"""Device selection: the port runs on the card unless the caller asks for
the CPU, and never falls back from one to the other."""
from __future__ import annotations

import sys

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    no card is available (pass ``device="cpu"`` to run on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev


def device_or_exit(device: str) -> torch.device:
    """:func:`resolve_device` for a command line's ``--device``: exits
    naming the flag and the reason where there is no card."""
    try:
        return resolve_device(device)
    except RuntimeError as e:
        sys.exit(f"--device {device}: {e}")


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
