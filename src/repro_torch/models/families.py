"""Parameter templates per architecture family — the dense template only.

The same flat paths and shapes as the JAX package: ``(in, out)`` weight
layout and a leading ``num_layers`` axis on per-layer tensors.
"""
from __future__ import annotations

from .common import ArchConfig, ParamDef


def _attn_defs(cfg: ArchConfig, L: int, prefix: str) -> dict[str, ParamDef]:
    h, kv, dh, d, t = (cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_model,
                       cfg.dtype)
    return {
        f"{prefix}/wq": ParamDef((L, d, h * dh), dtype=t),
        f"{prefix}/wk": ParamDef((L, d, kv * dh), dtype=t),
        f"{prefix}/wv": ParamDef((L, d, kv * dh), dtype=t),
        f"{prefix}/wo": ParamDef((L, h * dh, d), dtype=t),
    }


def _ffn_defs(cfg: ArchConfig, L: int, prefix: str) -> dict[str, ParamDef]:
    d, f, t = cfg.d_model, cfg.d_ff, cfg.dtype
    return {
        f"{prefix}/wi_gate": ParamDef((L, d, f), dtype=t),
        f"{prefix}/wi_up": ParamDef((L, d, f), dtype=t),
        f"{prefix}/wo": ParamDef((L, f, d), dtype=t),
    }


def _norm(L: int, d: int, name: str, t) -> dict[str, ParamDef]:
    return {name: ParamDef((L, d), init="ones", dtype=t)}


def template(cfg: ArchConfig) -> dict[str, ParamDef]:
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r}: not ported yet")
    if cfg.qk_norm or cfg.meta_tokens or cfg.ffn != "swiglu":
        raise NotImplementedError(
            f"{cfg.name}: qk_norm, meta tokens and non-SwiGLU FFNs are not "
            "ported yet")
    d, t, L, V = cfg.d_model, cfg.dtype, cfg.num_layers, cfg.vocab_size
    out: dict[str, ParamDef] = {
        "embed": ParamDef((V, d), dtype=t, fan_in=d),
        "lm_head": ParamDef((d, V), dtype=t),
        "final_norm": ParamDef((d,), init="ones", dtype=t),
    }
    out.update(_norm(L, d, "layers/attn_norm", t))
    out.update(_attn_defs(cfg, L, "layers/attn"))
    out.update(_norm(L, d, "layers/ffn_norm", t))
    out.update(_ffn_defs(cfg, L, "layers/ffn"))
    return out
