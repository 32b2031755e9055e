"""Carry parameters across from the JAX package.

The JAX param tree, flattened to the ``families.py`` paths
("layers/attn/wq", ...) as numpy arrays, maps one to one onto the port's
nested param dict: the paths, shapes and ``(in, out)`` layout are the same.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.common import unflatten


def _tensor(a: np.ndarray) -> torch.Tensor:
    # bf16 arrives as an ml_dtypes.bfloat16 array, which torch.from_numpy
    # refuses; float32 holds every bf16 value exactly
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_jax(flat: dict[str, np.ndarray]) -> dict:
    """{path: numpy array} -> the port's nested param dict (CPU tensors;
    ``.to(device)`` each to move them)."""
    return unflatten({path: _tensor(a) for path, a in flat.items()})
