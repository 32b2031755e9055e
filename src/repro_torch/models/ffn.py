"""Feed-forward: SwiGLU (llama family), the only variant ported."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ffn_forward(h: torch.Tensor, p: dict, kind: str) -> torch.Tensor:
    """h: (B,S,d). p holds wi_gate/wi_up/wo for this layer."""
    if kind != "swiglu":
        raise NotImplementedError(f"ffn kind {kind!r}: not ported yet")
    g = h @ p["wi_gate"]
    u = h @ p["wi_up"]
    z = F.silu(g.float()).to(h.dtype) * u          # silu in fp32
    return z @ p["wo"]
