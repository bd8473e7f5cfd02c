"""Device resolution shared by the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``. Without a
card it raises: the port never carries on quietly on the CPU unless the
caller asked for the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available()"
            " is False; pass device='cpu' to run on the CPU")
    return dev
