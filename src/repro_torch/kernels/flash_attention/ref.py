"""Plain PyTorch version of the flash-attention kernel's function.

It computes what the Pallas kernel (``repro/kernels/flash_attention/
kernel.py``) and the CUDA kernel compute, on any ``Sk``: q cast to float32
and multiplied by the softmax scale (``float32(Dqk ** -0.5)`` unless the
caller names one), float32 scores, the causal mask
top-left (query position i sees keys 0..i, both counted from 0, masked
scores set to ``NEG_INF``), float32 ``exp(s - max)`` weights and float32
``p . v``, then ``acc / max(l, 1e-30)`` cast to q's dtype.  v may carry
a head dim of its own (``Dv``, MLA's 128 beside q and k's 192); the
output has ``Dv`` columns.

The JAX package's oracle ``attention_ref`` masks bottom-right
(``jnp.tril(..., k=sk - sq)``); the kernel and the model's ``attend`` mask
top-left.  The port follows the kernel, so causal results agree with that
oracle only at ``Sq == Sk``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30


def softmax_scale(head_dim: int) -> float:
    """``D ** -0.5`` rounded to float32, as the kernels multiply by it."""
    return float(np.float32(head_dim ** -0.5))


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Sq, H, Dqk), k (B, Sk, G, Dqk), v (B, Sk, G, Dv), H % G ==
    0; query head h reads kv head h // (H // G); ``scale`` defaults to
    ``softmax_scale(Dqk)``.  Returns (B, Sq, H, Dv) in q's dtype."""
    b, sq, h, d = q.shape
    sk, g = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    r = h // g
    scale = softmax_scale(d) if scale is None else float(np.float32(scale))
    qs = q.to(torch.float32).reshape(b, sq, g, r, d) * scale
    s = torch.einsum("bqgrd,bkgd->bgrqk", qs, k.to(torch.float32))
    if causal:
        q_pos = torch.arange(sq, device=q.device)
        k_pos = torch.arange(sk, device=q.device)
        s = s.masked_fill(q_pos[:, None] < k_pos[None, :], NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    den = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bgrqk,bkgd->bgrqd", p, v.to(torch.float32)) / den
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv).to(q.dtype)
