"""Mamba-2 SSD chunk scan: CUDA kernel ``csrc/ssd.cu``.

Replaces ``repro/kernels/ssd/kernel.py::ssd_pallas``. The kernel walks the
sequence of each (batch, head) in sub-chunks of its own size (``SUBCHUNK``
steps), so ``chunk`` only sets the plain version's chunking on the CPU;
the result does not depend on it. B and C are read through strides: a
group broadcast over heads passes as an ``expand`` view with head stride 0
and is never copied.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import ssd_chunked

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 7 + [_I] * 5 + [_L] * 15 + [_I, _P]
# the (N, P) the kernel is built for: mamba2-370m and its reduced config
SIZES = ((128, 64), (16, 16))
SUBCHUNK = 32             # steps per sub-chunk (kQ in csrc/ssd.cu)


def _seq_strides(t: torch.Tensor) -> tuple[int, int, int]:
    return t.stride(0), t.stride(1), t.stride(2)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, chunk: int = 64
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P); dt (B,S,H); A (H,); B, C (B,S,H,N). Returns
    (y (B,S,H,P) in x's dtype, final state (B,H,N,P) fp32), the contract of
    ``repro/kernels/ssd/ops.py::ssd``.

    A CPU tensor runs the plain ``ssd_chunked``; a CUDA tensor launches the
    kernel or raises. On the card x, B and C share one dtype (float32 or
    bfloat16) and a unit last stride, dt is float32, and (N, P) is one of
    ``SIZES``."""
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, B, C, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd: unsupported device {x.device}")
    code = _build.dtype_code(x)
    if x.dim() != 4 or x.shape[1] == 0:
        raise ValueError(f"x must be a non-empty (B,S,H,P) tensor, got "
                         f"{tuple(x.shape)}")
    b, s, h, p = x.shape
    n = B.shape[-1]
    for name, t in (("x", x), ("B", B), ("C", C)):
        if (t.device != x.device or t.dtype != x.dtype or t.dim() != 4
                or t.stride(-1) != 1):
            raise ValueError(f"{name} must be 4-D on {x.device} in {x.dtype} "
                             "with unit last stride")
    if B.shape != (b, s, h, n) or C.shape != B.shape:
        raise ValueError(f"B and C must be (B,S,H,N) = {(b, s, h, n)}, got "
                         f"{tuple(B.shape)} and {tuple(C.shape)}")
    if (n, p) not in SIZES:
        raise ValueError(f"(N, P) = {(n, p)} must be one of {SIZES}")
    if (dt.shape != (b, s, h) or dt.dtype != torch.float32
            or dt.device != x.device):
        raise ValueError(f"dt must be float32 (B,S,H) = {(b, s, h)} on "
                         f"{x.device}")
    if A.shape != (h,) or A.device != x.device:
        raise ValueError(f"A must be ({h},) on {x.device}")
    a = A.float().contiguous()
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
    lib = _build.load("ssd", "ssd_launch", _ARGTYPES)
    rc = lib.ssd_launch(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), state.data_ptr(), b, s, h, n, p,
        *_seq_strides(x), *_seq_strides(dt), *_seq_strides(B),
        *_seq_strides(C), *_seq_strides(y), code, _build.stream())
    ssd.launches += 1
    _build.check(rc, "ssd")
    return y, state


ssd.launches = 0
