"""Parameter templates per architecture family: dense and ssm.

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


def _ssm_defs(cfg: ArchConfig, L: int, prefix: str) -> dict[str, ParamDef]:
    d, t = cfg.d_model, cfg.dtype
    di, h = cfg.d_inner, cfg.ssm_heads
    gn = cfg.ssm_ngroups * cfg.ssm_state
    k = cfg.ssm_conv
    return {
        f"{prefix}/in_z": ParamDef((L, d, di), dtype=t),
        f"{prefix}/in_x": ParamDef((L, d, di), dtype=t),
        f"{prefix}/in_B": ParamDef((L, d, gn), dtype=t),
        f"{prefix}/in_C": ParamDef((L, d, gn), dtype=t),
        f"{prefix}/in_dt": ParamDef((L, d, h), dtype=t),
        f"{prefix}/dt_bias": ParamDef((L, h), init="ssm_dt", dtype=t),
        f"{prefix}/conv_x": ParamDef((L, k, di), dtype=t, fan_in=k),
        f"{prefix}/conv_B": ParamDef((L, k, gn), dtype=t, fan_in=k),
        f"{prefix}/conv_C": ParamDef((L, k, gn), dtype=t, fan_in=k),
        f"{prefix}/A_log": ParamDef((L, h), init="ssm_a", dtype=t),
        f"{prefix}/D": ParamDef((L, h), init="ones", dtype=t),
        f"{prefix}/gate_norm": ParamDef((L, di), init="ones", dtype=t),
        f"{prefix}/out_proj": ParamDef((L, di, d), dtype=t, fan_in=di),
    }


def _norm(L: int, d: int, name: str, t) -> dict[str, ParamDef]:
    return {name: ParamDef((L, d), init="ones", dtype=t)}


def template(cfg: ArchConfig) -> dict[str, ParamDef]:
    if cfg.family not in ("dense", "ssm"):
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
    if cfg.family == "ssm":
        out.update(_norm(L, d, "layers/norm", t))
        out.update(_ssm_defs(cfg, L, "layers/ssm"))
        return out
    out.update(_norm(L, d, "layers/attn_norm", t))
    out.update(_attn_defs(cfg, L, "layers/attn"))
    out.update(_norm(L, d, "layers/ffn_norm", t))
    out.update(_ffn_defs(cfg, L, "layers/ffn"))
    return out
