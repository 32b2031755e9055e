"""Fused residual-add + RMSNorm: CUDA kernel ``csrc/rmsnorm.cu``.

Replaces ``repro/kernels/rmsnorm/kernel.py::fused_residual_rmsnorm``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import fused_residual_rmsnorm_plain

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, ctypes.c_float, _I, _P]
# one CTA per row: 256 threads x 8 vectors of 16 bytes (csrc/rmsnorm.cu)
_MAX_ROW_BYTES = 256 * 8 * 16


def fused_residual_rmsnorm(x: torch.Tensor, residual: torch.Tensor | None,
                           scale: torch.Tensor, eps: float = 1e-5
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """x, residual: (R, D); scale: (D,). Returns (y, h) with h = x + residual
    and y = rmsnorm(h) * scale, statistics in fp32, both in x's dtype. A
    ``None`` residual gives plain RMSNorm, with h = x.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    or raises."""
    if x.device.type == "cpu":
        return fused_residual_rmsnorm_plain(x, residual, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_residual_rmsnorm: unsupported device "
                         f"{x.device}")
    code = _build.dtype_code(x)
    if x.dim() != 2 or x.shape[0] == 0:
        raise ValueError(f"x must be a non-empty (R, D) matrix, got "
                         f"{tuple(x.shape)}")
    rows, d = x.shape
    vec = 16 // x.element_size()
    if d % vec or d * x.element_size() > _MAX_ROW_BYTES:
        raise ValueError(f"D={d} must be a multiple of {vec} and at most "
                         f"{_MAX_ROW_BYTES // x.element_size()}")
    operands = [x, scale] + ([] if residual is None else [residual])
    for t in operands:
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError("x, residual and scale must share device and "
                             "dtype")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("operands must be contiguous and 16-byte "
                             "aligned")
    if scale.shape != (d,) or (residual is not None
                               and residual.shape != x.shape):
        raise ValueError("residual must match x and scale must be (D,)")
    y = torch.empty_like(x)
    h = x if residual is None else torch.empty_like(x)
    lib = _build.load("rmsnorm", "rmsnorm_launch", _ARGTYPES)
    rc = lib.rmsnorm_launch(
        x.data_ptr(), None if residual is None else residual.data_ptr(),
        scale.data_ptr(), y.data_ptr(),
        None if residual is None else h.data_ptr(),
        rows, d, eps, code, _build.stream())
    fused_residual_rmsnorm.launches += 1
    _build.check(rc, "fused_residual_rmsnorm")
    return y, h


fused_residual_rmsnorm.launches = 0
