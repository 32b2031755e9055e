"""The language model, dense and ssm families, with two entry points:

  prefill(params, tokens, max_len)  — full-sequence forward → (last logits, cache)
  decode_step(params, cache, tokens) — one token against the cache

Params are the nested dict of tensors that ``init`` (or
``weights.params_from_jax``) gives, with per-layer tensors stacked on a
leading ``num_layers`` axis, as in the JAX package. The residual stream goes
through the fused residual+RMSNorm kernel: each sub-block's output is added
to the stream in the same launch that normalises it for the next sub-block
(or for ``final_norm`` after the last). A dense layer has two sub-blocks
(attention, then the FFN), so a forward launches it 2L+1 times; an ssm layer
has one (the Mamba-2 mixer, whose gated norm launches it once more), so
again 2L+1. Attention runs the flash kernel in prefill and the decode kernel
in decode; the mixer runs the SSD kernel in prefill.
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
from .mamba import mamba_cache_shape, mamba_decode, mamba_prefill

SubBlock = Callable[[int, torch.Tensor, dict], torch.Tensor]


def _layer(tree: dict, index: int) -> dict:
    """One layer's params out of the stacked per-layer tree (views)."""
    return {k: _layer(v, index) if isinstance(v, dict) else v[index]
            for k, v in tree.items()}


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig) -> None:
        super().__init__()
        param_template(cfg)          # raises for families not ported yet
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

    def _stack(self, params: dict, tokens: torch.Tensor,
               mixer: SubBlock) -> torch.Tensor:
        """The layer stack from the tokens to the logits. ``mixer(layer, x,
        layer_params)`` is the family's sequence mixer: attention (followed
        by the FFN) for dense, the Mamba-2 block for ssm."""
        cfg = self.cfg
        if cfg.family == "ssm":
            blocks: list[tuple[str, SubBlock]] = [("norm", mixer)]
        else:
            blocks = [("attn_norm", lambda i, x, p: mixer(i, x, p["attn"])),
                      ("ffn_norm",
                       lambda i, x, p: ffn_forward(x, p["ffn"], cfg.ffn))]
        lp = params["layers"]
        norms = [lp[name][i] for i in range(cfg.num_layers)
                 for name, _ in blocks] + [params["final_norm"]]
        x, h = self._norm(F.embedding(tokens, params["embed"]), None,
                          norms[0])
        k = 0
        for i in range(cfg.num_layers):
            p = _layer(lp, i)
            for _, block in blocks:
                k += 1
                x, h = self._norm(block(i, x, p), h, norms[k])
        return x @ params["lm_head"]

    # -- full-sequence forward (prefill) ----------------------------------------
    def forward(self, params: dict, tokens: torch.Tensor,
                mode: str = "prefill") -> tuple[torch.Tensor, dict]:
        """tokens: (B, S) int. Returns (logits (B,S,V), cache) where the
        cache holds each layer's entries stacked on a leading layer axis:
        K/V (L, B, S, Hkv, dh) for dense; for ssm the SSD state
        (L, B, H, N, P) fp32 and the conv carries (L, B, K-1, ·)."""
        if mode != "prefill":
            raise NotImplementedError(f"mode {mode!r}: not ported yet")
        cfg = self.cfg
        b, s = tokens.shape
        caches: list[dict] = []

        if cfg.family == "ssm":
            def mixer(i: int, x: torch.Tensor, p: dict) -> torch.Tensor:
                y, c = mamba_prefill(x, p["ssm"], cfg)
                caches.append(c)
                return y
        else:
            positions = torch.arange(s, device=tokens.device)[None].expand(
                b, s)

            def mixer(i: int, x: torch.Tensor, ap: dict) -> torch.Tensor:
                q, k, v = self._qkv(x, ap, positions)
                caches.append({"k": k, "v": v})
                o = attention_prefill(q, k, v)
                return o.reshape(b, s, -1) @ ap["wo"]

        logits = self._stack(params, tokens, mixer)
        return logits, {"layers": {
            name: torch.stack([c[name] for c in caches])
            for name in caches[0]}}

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
        """Zero-pad the sequence axis up to the decode-time template; the
        SSM leaves already have their final shapes and stay as they are."""
        template = self.cache_template(batch_size, max_len)
        out = {}
        for name, x in cache["layers"].items():
            shape, dtype = template[f"layers/{name}"]
            if tuple(x.shape) == shape:
                out[name] = x
                continue
            grown = torch.zeros(shape, dtype=dtype, device=x.device)
            grown[:, :, :s] = x
            out[name] = grown
        return {"layers": out}

    # -- decode ----------------------------------------------------------------
    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor
                    ) -> tuple[torch.Tensor, dict]:
        """tokens: (B, 1). Updates the cache in place: dense writes the
        token's K/V at ``cache['pos']`` and attends to rows ``<= pos``; ssm
        overwrites each layer's SSD state and conv carries. Returns
        (logits (B, V), the cache with pos + 1). ``pos`` stays on the
        device: no host sync."""
        cfg = self.cfg
        b = tokens.shape[0]
        pos = cache["pos"]
        layers = cache["layers"]

        if cfg.family == "ssm":
            def mixer(i: int, x: torch.Tensor, p: dict) -> torch.Tensor:
                y, new = mamba_decode(
                    x, p["ssm"], cfg, {n: c[i] for n, c in layers.items()})
                for name, c in layers.items():
                    c[i].copy_(new[name])
                return y
        else:
            positions = pos.reshape(1, 1).expand(b, 1)
            kc, vc = layers["k"], layers["v"]

            def mixer(i: int, x: torch.Tensor, ap: dict) -> torch.Tensor:
                q, k_new, v_new = self._qkv(x, ap, positions)
                update_kv_cache(kc[i], vc[i], k_new, v_new, pos)
                o = attention_decode(q, kc[i], vc[i], pos)
                return o.reshape(b, 1, -1) @ ap["wo"]

        logits = self._stack(params, tokens, mixer)
        return logits[:, 0], {"pos": pos + 1, "layers": layers}

    # -- cache construction ------------------------------------------------------
    def cache_template(self, batch: int, max_len: int) -> dict[str, tuple]:
        """Flat path -> (shape, dtype). Dense: K/V (L,B,max_len,Hkv,dh);
        ssm: the per-layer ``mamba_cache_shape`` stacked on L (max_len does
        not enter)."""
        cfg = self.cfg
        out: dict[str, tuple] = {"pos": ((), torch.int32)}
        if cfg.family == "ssm":
            for name, (shape, dtype) in mamba_cache_shape(cfg, batch).items():
                out[f"layers/{name}"] = ((cfg.num_layers, *shape), dtype)
            return out
        kv = (cfg.num_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
        out["layers/k"] = (kv, cfg.dtype)
        out["layers/v"] = (kv, cfg.dtype)
        return out

    def init_cache(self, batch: int, max_len: int,
                   device: str | torch.device = "cuda") -> dict:
        device = resolve_device(device)
        return unflatten({
            path: torch.zeros(shape, dtype=dtype, device=device)
            for path, (shape, dtype) in self.cache_template(
                batch, max_len).items()})
