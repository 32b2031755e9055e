"""Split-KV decode attention: CUDA kernel ``csrc/decode_attention.cu``.

Replaces ``repro/kernels/decode_attention/kernel.py::decode_attention``.
``pos`` is a device int32 tensor read by the kernel itself (the TPU's scalar
prefetch), so a decode step needs no host sync; any cache length works.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import decode_plain

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = ([_P] * 8 + [_I] * 6 + [_L] * 8
             + [ctypes.c_float, _I, _P])
HEAD_DIMS = (16, 32, 64, 128)
SPLIT = 64          # keys per CTA in pass 1 (kSplit in csrc/decode_attention.cu)
MAX_GROUP = 16      # q heads per KV head (kMaxGroup)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor
                     ) -> torch.Tensor:
    """q: (B,Hq,1,d); caches: (B,Hkv,S,d) through any strides with a unit
    last stride, so the model's (B,S,Hkv,d) cache passes as a transposed
    view; pos: int32 tensor of one element, the last valid cache index.
    Returns (B,Hq,1,d).

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    or raises."""
    if q.device.type == "cpu":
        return decode_plain(q, k_cache, v_cache, pos)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    code = _build.dtype_code(q)
    for t in (q, k_cache, v_cache):
        if (t.dim() != 4 or t.device != q.device or t.dtype != q.dtype
                or t.stride(-1) != 1):
            raise ValueError("q and caches must be 4-D, on one device, of "
                             "one dtype, with unit last stride")
    b, hq, one, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    if (one != 1 or k_cache.shape != (b, hkv, s, d)
            or v_cache.shape != k_cache.shape or hq % hkv
            or hq // hkv > MAX_GROUP or d not in HEAD_DIMS or s == 0):
        raise ValueError(f"bad shapes q {tuple(q.shape)} cache "
                         f"{tuple(k_cache.shape)}")
    if (pos.device != q.device or pos.dtype != torch.int32
            or pos.numel() != 1):
        raise ValueError("pos must be one int32 element on q's device")
    nsplit = -(-s // SPLIT)
    o = torch.empty((b, hq, 1, d), dtype=q.dtype, device=q.device)
    part_ml = torch.empty((2, b, hq, nsplit), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((b, hq, nsplit, d), dtype=torch.float32,
                           device=q.device)
    lib = _build.load("decode_attention", "decode_attention_launch",
                      _ARGTYPES)
    rc = lib.decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        pos.data_ptr(), o.data_ptr(), part_ml[0].data_ptr(),
        part_ml[1].data_ptr(), part_acc.data_ptr(),
        b, hq, hkv, s, d, nsplit,
        q.stride(0), q.stride(1), *k_cache.stride()[:3],
        *v_cache.stride()[:3], d ** -0.5, code, _build.stream())
    decode_attention.launches += 1
    _build.check(rc, "decode_attention")
    return o


decode_attention.launches = 0
