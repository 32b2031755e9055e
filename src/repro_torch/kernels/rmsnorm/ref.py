"""Plain PyTorch version of fused residual+RMSNorm."""
from __future__ import annotations

import torch


def fused_residual_rmsnorm_plain(x: torch.Tensor,
                                 residual: torch.Tensor | None,
                                 scale: torch.Tensor, eps: float = 1e-5
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """h = x + residual (x alone when residual is None);
    y = h * rsqrt(mean(h^2) + eps) * scale with fp32 statistics.
    Returns (y, h) in x's dtype."""
    h = x.float() if residual is None else x.float() + residual.float()
    ms = torch.mean(h * h, dim=-1, keepdim=True)
    y = h * torch.rsqrt(ms + eps) * scale.float()[None, :]
    return y.to(x.dtype), (x if residual is None else h.to(x.dtype))
