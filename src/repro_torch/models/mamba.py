"""Mamba-2 (SSD) block: projections + causal depthwise conv + SSD scan +
gated RMSNorm + output projection, as ``repro/models/mamba.py``.

Prefill runs the SSD chunk-scan kernel; decode runs the plain one-step
recurrence (``ssd_decode_step``), as the JAX decode step does. The gated
norm goes through the fused RMSNorm kernel without a residual. The
projections stay ``torch.matmul``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.rmsnorm.kernel import fused_residual_rmsnorm
from ..kernels.ssd.kernel import ssd
from ..kernels.ssd.ref import ssd_decode_step
from .common import ArchConfig


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Depthwise causal conv. x: (B,S,C), w: (K,C). state: (B,K-1,C) carry
    for decode. Returns (y, new_state)."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                  # (B,S+K-1,C)
    s = x.shape[1]
    y = xp[:, :s] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i]
    new_state = xp[:, -(k - 1):].contiguous() if k > 1 else None
    return y, new_state


def _project_streams(h: torch.Tensor, p: dict):
    z = h @ p["in_z"]                                # (B,S,di)
    xs = h @ p["in_x"]
    bs = h @ p["in_B"]                               # (B,S,G*N)
    cs = h @ p["in_C"]
    dt = F.softplus((h @ p["in_dt"] + p["dt_bias"]).float())   # (B,S,H)
    return z, xs, bs, cs, dt


def _to_heads(xs: torch.Tensor, bs: torch.Tensor, cs: torch.Tensor,
              cfg: ArchConfig):
    """(B,S,H,P) heads and (B,S,H,N) maps. The maps of the one group are
    an ``expand`` view over the heads (head stride 0), which the kernel
    reads as it is, where ``jnp.repeat`` copies them."""
    if cfg.ssm_ngroups != 1:
        raise NotImplementedError(f"{cfg.name}: more than one SSM group is "
                                  "not ported yet")
    b, s, _ = xs.shape
    nh, n = cfg.ssm_heads, cfg.ssm_state
    x = xs.reshape(b, s, nh, cfg.ssm_headdim)
    return (x, bs.reshape(b, s, 1, n).expand(b, s, nh, n),
            cs.reshape(b, s, 1, n).expand(b, s, nh, n))


def _silu(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.silu(t.float()).to(dtype)


def _gated_out(y: torch.Tensor, x: torch.Tensor, z: torch.Tensor, p: dict,
               cfg: ArchConfig) -> torch.Tensor:
    """D skip, gate by silu(z), gated RMSNorm (the fused kernel without a
    residual), output projection."""
    b, s = z.shape[:2]
    y = y + x * p["D"].to(x.dtype)[None, None, :, None]
    y = (y.reshape(b, s, cfg.d_inner) * _silu(z, y.dtype)).reshape(
        b * s, cfg.d_inner)
    y, _ = fused_residual_rmsnorm(y, None, p["gate_norm"], cfg.norm_eps)
    return y.view(b, s, cfg.d_inner) @ p["out_proj"]


def mamba_forward(h: torch.Tensor, p: dict, cfg: ArchConfig) -> torch.Tensor:
    """Full-sequence forward without the cache. h: (B,S,d)."""
    return mamba_prefill(h, p, cfg)[0]


def mamba_prefill(h: torch.Tensor, p: dict, cfg: ArchConfig
                  ) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward that also returns the recurrent cache for
    decode. h: (B,S,d)."""
    z, xs, bs, cs, dt = _project_streams(h, p)
    xs, conv_x = _causal_conv(xs, p["conv_x"])
    bs, conv_b = _causal_conv(bs, p["conv_B"])
    cs, conv_c = _causal_conv(cs, p["conv_C"])
    x, bm, cm = _to_heads(*(_silu(t, h.dtype) for t in (xs, bs, cs)), cfg)
    A = -torch.exp(p["A_log"].float())
    y, state = ssd(x, dt, A, bm, cm, chunk=cfg.ssm_chunk)
    cache = {"ssm": state,                                  # (B,H,N,P) fp32
             "conv_x": conv_x, "conv_B": conv_b, "conv_C": conv_c}
    return _gated_out(y, x, z, p, cfg), cache


def mamba_decode(h: torch.Tensor, p: dict, cfg: ArchConfig, cache: dict
                 ) -> tuple[torch.Tensor, dict]:
    """One-token step. h: (B,1,d). cache: {'ssm','conv_x','conv_B','conv_C'}
    of this layer. Returns (out, the new cache entries)."""
    z, xs, bs, cs, dt = _project_streams(h, p)
    xs, cx = _causal_conv(xs, p["conv_x"], cache["conv_x"])
    bs, cb = _causal_conv(bs, p["conv_B"], cache["conv_B"])
    cs, cc = _causal_conv(cs, p["conv_C"], cache["conv_C"])
    x, bm, cm = _to_heads(*(_silu(t, h.dtype) for t in (xs, bs, cs)), cfg)
    A = -torch.exp(p["A_log"].float())
    y, state = ssd_decode_step(cache["ssm"], x[:, 0], dt[:, 0], A, bm[:, 0],
                               cm[:, 0])
    new_cache = {"ssm": state, "conv_x": cx, "conv_B": cb, "conv_C": cc}
    return _gated_out(y[:, None], x, z, p, cfg), new_cache


def mamba_cache_shape(cfg: ArchConfig, batch: int) -> dict:
    """Per-layer cache shapes (fp32 state, conv carries in ``cfg.dtype``)."""
    k, gn = cfg.ssm_conv, cfg.ssm_ngroups * cfg.ssm_state
    return {
        "ssm": ((batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim),
                torch.float32),
        "conv_x": ((batch, k - 1, cfg.d_inner), cfg.dtype),
        "conv_B": ((batch, k - 1, gn), cfg.dtype),
        "conv_C": ((batch, k - 1, gn), cfg.dtype),
    }
