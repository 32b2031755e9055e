"""Attention for prefill and decode, in the model's (B, S, H, dh) layout.

Both modes go through the hand-written kernels, which take GQA natively
(q head h reads KV head h // (Hq/Hkv)) and read the model's layout through
strides, so neither the KV heads nor the tensors are copied.
"""
from __future__ import annotations

import torch

from ..kernels.decode_attention.kernel import decode_attention
from ..kernels.flash_attention.kernel import flash_attention


def attention_prefill(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """Causal attention over a full sequence.
    q: (B,S,Hq,dh); k/v: (B,S,Hkv,dh) -> (B,S,Hq,dh)."""
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=True)
    return o.transpose(1, 2)


def attention_decode(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor
                     ) -> torch.Tensor:
    """q: (B,1,Hq,dh); caches: (B,Smax,Hkv,dh); pos: int32 tensor, the
    index of the new token — cache rows ``<= pos`` are attended to.
    Returns (B,1,Hq,dh)."""
    o = decode_attention(q.transpose(1, 2), k_cache.transpose(1, 2),
                         v_cache.transpose(1, 2), pos.reshape(1))
    return o.transpose(1, 2)


def update_kv_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor,
                    pos: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Write the new K/V rows at ``pos`` along axis 1. Unlike the JAX
    version, which returns new arrays, this updates the caches in place (no
    copy of the cache per step); ``pos`` stays on the device."""
    idx = pos.reshape(1).long()
    k_cache.index_copy_(1, idx, k_new.to(k_cache.dtype))
    v_cache.index_copy_(1, idx, v_new.to(v_cache.dtype))
    return k_cache, v_cache
