"""Hand-written CUDA kernels for Hopper (sm_90a), one package per kernel:

  kernel.py — the wrapper: checks its operands, launches the kernel from
              ``csrc/<name>.cu`` on the current stream and counts launches;
              a CPU tensor runs the plain version instead
  ref.py    — the plain PyTorch version of the same function

``_build.py`` compiles ``csrc/*.cu`` with nvcc at first use.
"""
from __future__ import annotations

from .decode_attention.kernel import decode_attention
from .flash_attention.kernel import flash_attention
from .rmsnorm.kernel import fused_residual_rmsnorm
from .ssd.kernel import ssd

WRAPPERS = (fused_residual_rmsnorm, flash_attention, decode_attention, ssd)


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {w.__name__: w.launches for w in WRAPPERS}


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0
