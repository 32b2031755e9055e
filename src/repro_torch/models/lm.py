"""The language model, dense family only, with two entry points:

  prefill(params, tokens, max_len)  — full-sequence forward → (last logits, cache)
  decode_step(params, cache, tokens) — one token against the KV cache

Params are the nested dict of tensors that ``init`` (or
``weights.params_from_jax``) gives, with per-layer tensors stacked on a
leading ``num_layers`` axis, as in the JAX package. The residual stream goes
through the fused residual+RMSNorm kernel: ``h + attn`` is fused with the
layer's ``ffn_norm``, and ``h + ffn`` with the next layer's ``attn_norm``
(or ``final_norm`` after the last layer), so a forward launches it 2L+1
times. Attention runs the flash kernel in prefill and the decode kernel in
decode.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..kernels.rmsnorm.kernel import fused_residual_rmsnorm
from .attention import attention_decode, attention_prefill, update_kv_cache
from .common import (ArchConfig, apply_rope, init_params, param_template,
                     unflatten)
from .ffn import ffn_forward


def _layer(tree: dict, index: int) -> dict:
    """One layer's params out of the stacked per-layer tree (views)."""
    return {k: _layer(v, index) if isinstance(v, dict) else v[index]
            for k, v in tree.items()}


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig) -> None:
        super().__init__()
        param_template(cfg)          # raises for what is not ported yet
        if cfg.sliding_window or cfg.kv_quant:
            raise NotImplementedError(
                f"{cfg.name}: sliding-window and int8 KV caches are not "
                "ported yet")
        self.cfg = cfg

    # -- params ----------------------------------------------------------------
    def init(self, generator: torch.Generator,
             device: str | torch.device = "cuda") -> dict:
        return init_params(self.cfg, generator, resolve_device(device))

    # -- blocks ----------------------------------------------------------------
    def _norm(self, x: torch.Tensor, residual: torch.Tensor | None,
              scale: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(y, h) = fused residual+RMSNorm over the rows of (B, S, d)."""
        shape = x.shape
        d = shape[-1]
        y, h = fused_residual_rmsnorm(
            x.reshape(-1, d),
            None if residual is None else residual.reshape(-1, d),
            scale, self.cfg.norm_eps)
        return y.view(shape), h.view(shape)

    def _qkv(self, x: torch.Tensor, ap: dict, positions: torch.Tensor):
        cfg = self.cfg
        b, s, _ = x.shape
        q = (x @ ap["wq"]).reshape(b, s, cfg.n_heads, cfg.d_head)
        k = (x @ ap["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
        v = (x @ ap["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        return q, k, v

    def _stack(self, params: dict, h: torch.Tensor,
               attn: Callable[[int, torch.Tensor, dict], torch.Tensor]
               ) -> torch.Tensor:
        """The dense layer stack from the embedded tokens to the logits;
        ``attn(layer, x, attn_params)`` is the attention sub-block."""
        cfg = self.cfg
        lp = params["layers"]
        x, h = self._norm(h, None, lp["attn_norm"][0])
        for i in range(cfg.num_layers):
            p = _layer(lp, i)
            x, h = self._norm(attn(i, x, p["attn"]), h, p["ffn_norm"])
            nxt = (lp["attn_norm"][i + 1] if i + 1 < cfg.num_layers
                   else params["final_norm"])
            x, h = self._norm(ffn_forward(x, p["ffn"], cfg.ffn), h, nxt)
        return x @ params["lm_head"]

    # -- full-sequence forward (prefill) ----------------------------------------
    def forward(self, params: dict, tokens: torch.Tensor,
                mode: str = "prefill") -> tuple[torch.Tensor, dict]:
        """tokens: (B, S) int. Returns (logits (B,S,V), cache) where the
        cache holds each layer's K/V, stacked: (L, B, S, Hkv, dh)."""
        if mode != "prefill":
            raise NotImplementedError(f"mode {mode!r}: not ported yet")
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
        ks, vs = [], []

        def attn(i: int, x: torch.Tensor, ap: dict) -> torch.Tensor:
            q, k, v = self._qkv(x, ap, positions)
            ks.append(k)
            vs.append(v)
            o = attention_prefill(q, k, v)
            return o.reshape(b, s, -1) @ ap["wo"]

        logits = self._stack(params, F.embedding(tokens, params["embed"]),
                             attn)
        return logits, {"layers": {"k": torch.stack(ks),
                                   "v": torch.stack(vs)}}

    def prefill(self, params: dict, tokens: torch.Tensor,
                max_len: int | None = None) -> tuple[torch.Tensor, dict]:
        """max_len reserves cache room for subsequent decode_step growth.
        Returns the last position's logits (B, V), pad or not, and the
        cache with ``pos`` = S."""
        logits, cache = self.forward(params, tokens, mode="prefill")
        b, s = tokens.shape
        if max_len is not None and max_len > s:
            cache = self._grow_cache(cache, b, s, max_len)
        cache["pos"] = torch.tensor(s, dtype=torch.int32,
                                    device=tokens.device)
        return logits[:, -1], cache

    def _grow_cache(self, cache: dict, batch_size: int, s: int,
                    max_len: int) -> dict:
        """Zero-pad the sequence axis up to the decode-time template."""
        template = self.cache_template(batch_size, max_len)
        out = {}
        for name, x in cache["layers"].items():
            shape, dtype = template[f"layers/{name}"]
            grown = torch.zeros(shape, dtype=dtype, device=x.device)
            grown[:, :, :s] = x
            out[name] = grown
        return {"layers": out}

    # -- decode ----------------------------------------------------------------
    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor
                    ) -> tuple[torch.Tensor, dict]:
        """tokens: (B, 1). Writes the token's K/V at ``cache['pos']`` in
        place and attends to rows ``<= pos``; returns (logits (B, V), the
        cache with pos + 1). ``pos`` stays on the device: no host sync."""
        b = tokens.shape[0]
        pos = cache["pos"]
        positions = pos.reshape(1, 1).expand(b, 1)
        kc, vc = cache["layers"]["k"], cache["layers"]["v"]

        def attn(i: int, x: torch.Tensor, ap: dict) -> torch.Tensor:
            q, k_new, v_new = self._qkv(x, ap, positions)
            update_kv_cache(kc[i], vc[i], k_new, v_new, pos)
            o = attention_decode(q, kc[i], vc[i], pos)
            return o.reshape(b, 1, -1) @ ap["wo"]

        logits = self._stack(params, F.embedding(tokens, params["embed"]),
                             attn)
        return logits[:, 0], {"pos": pos + 1, "layers": cache["layers"]}

    # -- cache construction ------------------------------------------------------
    def cache_template(self, batch: int, max_len: int) -> dict[str, tuple]:
        """Flat path -> (shape, dtype)."""
        cfg = self.cfg
        kv = (cfg.num_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
        return {"pos": ((), torch.int32), "layers/k": (kv, cfg.dtype),
                "layers/v": (kv, cfg.dtype)}

    def init_cache(self, batch: int, max_len: int,
                   device: str | torch.device = "cuda") -> dict:
        device = resolve_device(device)
        return unflatten({
            path: torch.zeros(shape, dtype=dtype, device=device)
            for path, (shape, dtype) in self.cache_template(
                batch, max_len).items()})
