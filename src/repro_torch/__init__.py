"""PyTorch/CUDA port of the JAX package ``repro``: the serving slice.

The port keeps the JAX package's module names where that helps a reader find
a module's counterpart, and imports nothing of it. Its entry points run on
the CUDA card unless the caller asks for the CPU; without a card they raise.
On the CPU every kernel wrapper runs its plain PyTorch version.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """Turn ``device`` into a ``torch.device``; a CUDA device without a card
    raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA card is present; "
            "pass device='cpu' to run the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
