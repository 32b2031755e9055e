"""Plain PyTorch versions of the Mamba-2 SSD (state-space dual) scan, fp32
inside:

  ssd_sequential  — the literal per-step recurrence (the oracle)
  ssd_chunked     — the chunked algorithm (Mamba-2 paper §6): quadratic
                    attention-like work inside chunks, the state passed
                    linearly between chunks
  ssd_decode_step — one recurrent step, for decode

Shapes, as in the JAX package:
  x  (B, S, H, P)   head channels
  dt (B, S, H)      post-softplus step sizes
  A  (H,)           negative decay rates
  B  (B, S, H, N)   input maps (groups already broadcast to heads)
  C  (B, S, H, N)   output maps
returning y (B, S, H, P) in x's dtype and the final state (B, H, N, P) fp32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _f32(*ts: torch.Tensor) -> list[torch.Tensor]:
    return [t.float() for t in ts]


def ssd_sequential(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor,
                   initial_state: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    b, s, h, p = x.shape
    n = B.shape[-1]
    xf, dtf, Bf, Cf, Af = _f32(x, dt, B, C, A)
    state = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * Af)                        # (b,h)
        upd = torch.einsum("bhn,bhp->bhnp", Bf[:, t] * dtf[:, t, :, None],
                           xf[:, t])
        state = state * decay[..., None, None] + upd
        ys.append(torch.einsum("bhn,bhnp->bhp", Cf[:, t], state))
    return torch.stack(ys, dim=1).to(x.dtype), state


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int = 64,
                initial_state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:            # pad to a chunk multiple; dt=0 ⇒ padded steps
        pad = chunk - s % chunk  # are identity on the state and emit y=0
        def padder(t: torch.Tensor) -> torch.Tensor:
            return F.pad(t, [0, 0] * (t.dim() - 2) + [0, pad])
        y, state = ssd_chunked(padder(x), padder(dt), A, padder(B),
                               padder(C), chunk, initial_state)
        return y[:, :s], state
    nc, q = s // chunk, chunk
    xf = x.float().reshape(b, nc, q, h, p)
    dtf = dt.float().reshape(b, nc, q, h)
    Bf = B.float().reshape(b, nc, q, h, n)
    Cf = C.float().reshape(b, nc, q, h, n)
    Af = A.float()

    cum = torch.cumsum(dtf * Af, dim=2)             # (b,c,q,h) inclusive

    # ---- intra-chunk (quadratic within chunk) -----------------------------
    scores = torch.einsum("bcihn,bcjhn->bchij", Cf, Bf)
    cum_h = cum.transpose(2, 3)                     # (b,c,h,q)
    diff = cum_h[..., :, None] - cum_h[..., None, :]   # (b,c,h,i,j)
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    # exp only where i >= j: above the diagonal the difference is positive
    # and may overflow
    L = torch.exp(torch.where(causal, diff, torch.full_like(diff, -torch.inf)))
    M = scores * L * dtf.transpose(2, 3)[..., None, :]          # dt_j
    y_intra = torch.einsum("bchij,bcjhp->bcihp", M, xf)

    # ---- chunk summaries ----------------------------------------------------
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)           # (b,c,j,h)
    Bx = torch.einsum("bcjhn,bcjhp->bchnp",
                      Bf * (dtf * decay_to_end)[..., None], xf)
    chunk_decay = torch.exp(cum[:, :, -1, :])                   # (b,c,h)
    state = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    y_inter = []
    for c in range(nc):
        cin = Cf[:, c] * torch.exp(cum[:, c])[..., None]        # (b,i,h,n)
        y_inter.append(torch.einsum("bihn,bhnp->bihp", cin, state))
        state = state * chunk_decay[:, c, :, None, None] + Bx[:, c]
    y = y_intra + torch.stack(y_inter, dim=1)
    return y.reshape(b, s, h, p).to(x.dtype), state


def ssd_decode_step(state: torch.Tensor, x_t: torch.Tensor,
                    dt_t: torch.Tensor, A: torch.Tensor, B_t: torch.Tensor,
                    C_t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One recurrent step. state (B,H,N,P) fp32; x_t (B,H,P); dt_t (B,H);
    B_t/C_t (B,H,N). Returns (y (B,H,P) in x_t's dtype, new state)."""
    dtf = dt_t.float()
    decay = torch.exp(dtf * A.float())
    upd = torch.einsum("bhn,bhp->bhnp", B_t.float() * dtf[..., None],
                       x_t.float())
    state = state * decay[..., None, None] + upd
    y = torch.einsum("bhn,bhnp->bhp", C_t.float(), state)
    return y.to(x_t.dtype), state
