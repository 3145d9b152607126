"""Grouped-query attention (llama-style), training path without a cache.

Plain matmul and softmax, as the JAX package's jnp path runs it: bf16
projections, float32 scores and softmax, bf16 weighted sum.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.modules import apply_rope

NEG_INF = -1e30


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k, v: (B, Sk, G, Dh) with H % G == 0; query head
    h reads kv head h // (H // G).  Returns (B, Sq, H, Dh)."""
    b, sq, h, dh = q.shape
    g = k.shape[2]
    if h % g:
        raise ValueError(f"heads {h} not divisible by kv heads {g}")
    r = h // g
    qg = q.reshape(b, sq, g, r, dh) * (dh ** -0.5)
    # bf16 x bf16 products are exact in float32: this is the float32-
    # accumulated score of the bf16 operands.
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg.to(torch.float32),
                          k.to(torch.float32))
    if causal:
        sk = k.shape[1]
        q_pos = q_offset + torch.arange(sq, device=q.device)
        mask = q_pos[:, None] >= torch.arange(sk, device=q.device)[None, :]
        scores = scores.masked_fill(~mask, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", w, v)
    return out.reshape(b, sq, h, v.shape[-1])


def gqa_forward(p: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ModelConfig, *, positions: torch.Tensor,
                causal: bool = True) -> torch.Tensor:
    """One self-attention layer over ``x`` (B, S, D); weights wq (D,H,Dh),
    wk/wv (D,G,Dh), wo (H,Dh,D)."""
    cd = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(cd))
    q = apply_rope(q, positions, cfg.rope_theta)
    k = torch.einsum("bsd,dgk->bsgk", x, p["wk"].to(cd))
    v = torch.einsum("bsd,dgk->bsgk", x, p["wv"].to(cd))
    k = apply_rope(k, positions, cfg.rope_theta)
    out = attend(q, k, v, causal=causal)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(cd))
