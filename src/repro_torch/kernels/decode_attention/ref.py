"""Plain PyTorch version of decode attention: masked single-token attention
over a KV cache, in fp32."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_plain(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, pos: torch.Tensor | int
                 ) -> torch.Tensor:
    """q: (B,Hq,1,d); caches: (B,Hkv,S,d); positions ``<= pos`` are valid.
    Returns (B,Hq,1,d) in q's dtype."""
    d = q.shape[-1]
    skv = k_cache.shape[2]
    rep = q.shape[1] // k_cache.shape[1]
    kf = k_cache.float().repeat_interleave(rep, dim=1)
    vf = v_cache.float().repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * (d ** -0.5)
    valid = torch.arange(skv, device=q.device) <= torch.as_tensor(
        pos, device=q.device)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
