"""Shared model infrastructure: the config, parameter templates (shape +
init in one place), norms, rope and masks.

Conventions, as in the JAX package
----------------------------------
* Params are nested dicts of tensors; per-layer params are STACKED with a
  leading ``num_layers`` axis.
* Every parameter is declared once as a ``ParamDef`` carrying its shape,
  dtype and initializer; ``init_params`` materializes it on a device from a
  ``torch.Generator``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from ..kernels.flash_attention.ref import causal_mask
from ..kernels.rmsnorm.ref import fused_residual_rmsnorm_plain

__all__ = ["ArchConfig", "ParamDef", "apply_rope", "causal_mask",
           "init_params", "param_template", "rms_norm", "rope_freqs",
           "unflatten"]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    ffn: str = "swiglu"            # swiglu | sq_relu | gelu
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    attn_shard: str = "heads"
    sliding_window: int = 0        # 0 = full attention
    full_attn_layers: tuple[int, ...] = ()
    meta_tokens: int = 0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # MLA (deepseek)
    kv_lora: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # SSM (mamba2 / hymba heads)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_ngroups: int = 1
    ssm_chunk: int = 256
    ssm_conv: int = 4
    # encoder-decoder (whisper)
    enc_layers: int = 0
    enc_seq: int = 0
    # vlm (llava)
    img_tokens: int = 0
    img_embed_dim: int = 0
    # numerics
    dtype: Any = torch.bfloat16
    kv_quant: bool = False
    moe_chunk_dispatch: bool = False
    subquadratic: bool = False

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def param_count(self) -> int:
        """Total parameters N (embeddings included)."""
        return sum(math.prod(d.shape) for d in param_template(self).values())


@dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    init: str = "normal"             # normal | ones | ssm_a | ssm_dt
    dtype: Any = torch.bfloat16
    fan_in: int | None = None


def param_template(cfg: ArchConfig) -> dict[str, ParamDef]:
    """Flat dict 'path/like/this' -> ParamDef."""
    from . import families            # local import to avoid cycles
    return families.template(cfg)


def _uniform(d: ParamDef, generator: torch.Generator, device: torch.device,
             lo: float, hi: float) -> torch.Tensor:
    u = torch.rand(d.shape, generator=generator, device=device,
                   dtype=torch.float32)
    return lo + (hi - lo) * u


def _init_leaf(d: ParamDef, generator: torch.Generator,
               device: torch.device) -> torch.Tensor:
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    if d.init == "ssm_a":            # mamba A_log in [0, ~ln16]
        return torch.log(_uniform(d, generator, device, 1.0, 16.0)
                         ).to(d.dtype)
    if d.init == "ssm_dt":           # dt_bias ~ softplus^-1(U(1e-3, 0.1))
        u = _uniform(d, generator, device, 1e-3, 0.1)
        return torch.log(torch.expm1(u)).to(d.dtype)
    if d.init != "normal":
        raise NotImplementedError(f"init {d.init!r}: not ported yet")
    fan_in = d.fan_in or (d.shape[-2] if len(d.shape) >= 2 else d.shape[-1])
    std = 1.0 / math.sqrt(max(1, fan_in))
    w = torch.randn(d.shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (w * std).to(d.dtype)


def unflatten(flat: dict[str, Any]) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device: str | torch.device) -> dict:
    """Random parameters with the JAX package's distributions
    (``normal * 1/sqrt(fan_in)``, ones for norms and the SSM skip ``D``,
    ``log U(1, 16)`` for ``A_log`` and ``log expm1 U(1e-3, 0.1)`` for
    ``dt_bias``). The generator lives on
    ``device``; its numbers differ from ``jax.random`` for the same seed."""
    device = torch.device(device)
    return unflatten({path: _init_leaf(d, generator, device)
                      for path, d in sorted(param_template(cfg).items())})


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with fp32 statistics: the plain version of the fused kernel
    without a residual. ``causal_mask`` likewise is the flash kernel's."""
    return fused_residual_rmsnorm_plain(x, None, scale, eps)[0]


def rope_freqs(d_head: int, theta: float,
               device: torch.device | None = None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """Split-half rope. x: (..., S, H, dh) or (..., S, dh);
    positions: (..., S)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                  # (dh/2,)
    angles = positions[..., None].float() * freqs            # (..., S, dh/2)
    if x.dim() == angles.dim() + 1:                          # head axis
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
