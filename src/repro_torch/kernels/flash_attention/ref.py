"""Plain PyTorch version of flash attention: naive masked softmax attention
in fp32, GQA by repeating KV heads."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def causal_mask(s_q: int, s_kv: int, q_offset: int = 0,
                device: torch.device | None = None) -> torch.Tensor:
    """True where attention is allowed."""
    qi = torch.arange(s_q, device=device)[:, None] + q_offset
    kj = torch.arange(s_kv, device=device)[None, :]
    return qi >= kj


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B,Hq,Sq,d); k/v: (B,Hkv,Skv,d) -> (B,Hq,Sq,d) in q's dtype."""
    d = q.shape[-1]
    sq, skv = q.shape[2], k.shape[2]
    rep = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * (d ** -0.5)
    mask = (causal_mask(sq, skv, device=q.device) if causal
            else torch.ones((sq, skv), dtype=torch.bool, device=q.device))
    if window:                      # keep i - j < window: drop i - window >= j
        mask &= ~causal_mask(sq, skv, -window, q.device)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
