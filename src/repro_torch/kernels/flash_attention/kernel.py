"""Flash attention forward: CUDA kernel ``csrc/flash_attention.cu``.

Replaces ``repro/kernels/flash_attention/kernel.py::flash_attention``.
Unlike the TPU kernel, sequence lengths need not be block multiples: the
ragged last tile is masked.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import attention_plain

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = ([_P] * 4 + [_I] * 6 + [_L] * 12
             + [ctypes.c_float, _I, _I, _I, _P])
HEAD_DIMS = (16, 32, 64, 128)


def _check(t: torch.Tensor, like: torch.Tensor, name: str) -> None:
    if t.dim() != 4 or t.device != like.device or t.dtype != like.dtype:
        raise ValueError(f"{name} must be 4-D on {like.device} in "
                         f"{like.dtype}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must have unit stride on its last axis")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B,Hq,Sq,d); k, v: (B,Hkv,Skv,d) with Hq % Hkv == 0; any strides
    with a unit last stride, so a (B,S,H,d) tensor passes as a transposed
    view. Returns (B,Hq,Sq,d) laid out like q.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    or raises."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    code = _build.dtype_code(q)
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check(t, q, name)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if (k.shape != (b, hkv, skv, d) or v.shape != k.shape
            or hq % hkv or d not in HEAD_DIMS or sq == 0 or skv == 0):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}; d must be one of {HEAD_DIMS}")
    o = torch.empty_like(q)
    lib = _build.load("flash_attention", "flash_attention_launch", _ARGTYPES)
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        b, hq, hkv, sq, skv, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        d ** -0.5, int(causal), int(window), code, _build.stream())
    flash_attention.launches += 1
    _build.check(rc, "flash_attention")
    return o


flash_attention.launches = 0
