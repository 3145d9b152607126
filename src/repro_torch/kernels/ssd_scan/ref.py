"""Plain PyTorch version of the SSD chunk-scan kernel's function.

It computes what the Pallas kernel (``repro/kernels/ssd_scan/kernel.py``)
and the CUDA kernel compute, with the per-chunk math of the JAX model's
``ssd_chunked`` (``repro/models/ssm.py``), on any ``S``: per (b, h), chunk
by chunk, a float32 ``(P, N)`` state carried from zero;
``L = cumsum(dt * a)`` within the chunk, ``a = -exp(a_log[h])``;

    y     = (C . state^T) * exp(L)
            + ((C . B^T) * exp(min(L_i - L_j, 0)) * causal * dt_j) . x
    state = exp(L_last) * state + (exp(L_last - L) * dt * x)^T . B

in float32 from inputs cast to float32, ``y`` cast to x's dtype.  A ragged
tail (``S`` not a multiple of ``chunk``) is padded with ``dt = 0`` steps,
which decay nothing and add nothing, as ``ssd_chunked`` pads.  ``B`` and
``C`` carry ``G`` groups; head ``h`` reads group ``h // (H // G)``, the
JAX model's ``_broadcast_groups`` without its copy.

It is differentiable: the model trains through it with autograd (the
kernels are forward-only), and CPU tensors take it for prefill.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def ssd_scan_plain(xs: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                   bs: torch.Tensor, cs: torch.Tensor, chunk: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xs (B,S,H,P), dt (B,S,H) float32, a_log (H,) float32, bs and cs
    (B,S,G,N) with H % G == 0.  Returns (y (B,S,H,P) in xs's dtype, final
    state (B,H,P,N) float32).

    Every chunk's own terms are computed at once (a chunk dim C), then the
    state is carried across the chunks in order; each element of y and of
    the state is the per-chunk formula above, summed in the same order."""
    b, s, h, p = xs.shape
    g, n = bs.shape[2], bs.shape[3]
    r = h // g
    f32 = torch.float32
    pad = -s % chunk
    if pad:
        xs_, dt_, bs_, cs_ = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                              for t in (xs, dt, bs, cs))
    else:
        xs_, dt_, bs_, cs_ = xs, dt, bs, cs
    nc = (s + pad) // chunk
    a = -torch.exp(a_log.to(f32))                         # (H,)
    x_ = xs_.to(f32).reshape(b, nc, chunk, g, r, p)
    dtc = dt_.to(f32).reshape(b, nc, chunk, h)
    b_ = bs_.to(f32).reshape(b, nc, chunk, g, n)
    c_ = cs_.to(f32).reshape(b, nc, chunk, g, n)
    l_ = torch.cumsum(dtc * a, dim=2)                     # (B,C,Q,H)
    total = l_[:, :, -1]                                  # (B,C,H)
    # intra-chunk: the masked (Q, Q) SSD "attention"
    scores = torch.einsum("bcign,bcjgn->bcgij", c_, b_)   # (B,C,G,Q,Q)
    lt = l_.transpose(2, 3).reshape(b, nc, g, r, chunk)   # (B,C,G,R,Q)
    # valid (i >= j) entries have rel <= 0; the clamp keeps the masked
    # upper triangle from overflowing exp (inf * 0 -> NaN gradients)
    rel = torch.clamp(lt[..., :, None] - lt[..., None, :], max=0.0)
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=xs.device).tril()
    m = torch.where(causal, scores[:, :, :, None] * torch.exp(rel), 0.0)
    m = m * dtc.transpose(2, 3).reshape(b, nc, g, r, 1, chunk)  # dt_j
    y_intra = torch.einsum("bcgrij,bcjgrp->bcigrp", m, x_)
    # each chunk's own state contribution, then the carry across chunks
    w = torch.exp(total[:, :, None] - l_) * dtc           # (B,C,Q,H)
    s_chunk = torch.einsum("bcqgr,bcqgn,bcqgrp->bcgrpn",
                           w.reshape(b, nc, chunk, g, r), b_, x_)
    decay = torch.exp(total).reshape(b, nc, g, r, 1, 1)
    state = torch.zeros(b, g, r, p, n, dtype=f32, device=xs.device)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * decay[:, c] + s_chunk[:, c]
    # inter-chunk: the state each chunk starts from
    y_inter = torch.einsum("bcign,bcgrpn->bcigrp", c_,
                           torch.stack(entering, dim=1)) \
        * torch.exp(l_).reshape(b, nc, chunk, g, r, 1)
    y = (y_inter + y_intra).reshape(b, nc * chunk, h, p)[:, :s]
    return y.to(xs.dtype), state.reshape(b, h, p, n)
