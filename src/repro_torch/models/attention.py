"""Grouped-query attention (llama-style) with the JAX package's cache modes.

- **Training** (no cache, no ``return_kv``): plain matmul and softmax, as the
  JAX package's jnp path runs it: bf16 projections, float32 scores and
  softmax, bf16 weighted sum (``attend``).  Training stays on this path: the
  flash-attention kernel is forward-only (the JAX package's Pallas kernel
  has no backward either), and the backward pass needs the plain ops.
- **Prefill** (``return_kv=True``) and **decode** (``cache`` and
  ``cache_pos``) are serving: their attention runs through
  ``repro_torch.kernels.flash_attention`` (the CUDA kernel on the card).

The GQA cache of one layer is ``{"k": (B, S, G, Dh), "v": (B, S, G, Dh)}``
in bf16; a decode step writes its k/v at ``cache_pos`` in place (the JAX
server donates the cache to the step) and attends over the first
``cache_pos + S`` positions, the cache prefix view, with ``causal=False``.
The JAX model masks the padded tail with ``k_valid`` instead; both give the
padded keys zero weight.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.model_api import TensorSpec
from repro_torch.models.modules import apply_rope

NEG_INF = -1e30


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, q_offset: int = 0,
           k_valid: Optional[int] = None) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k, v: (B, Sk, G, Dh) with H % G == 0; query head
    h reads kv head h // (H // G); ``k_valid`` masks keys at positions >=
    it (a padded cache).  Returns (B, Sq, H, Dh)."""
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
    sk = k.shape[1]
    k_idx = torch.arange(sk, device=q.device)
    mask = None
    if causal:
        q_pos = q_offset + torch.arange(sq, device=q.device)
        mask = q_pos[:, None] >= k_idx[None, :]
    if k_valid is not None:
        valid = (k_idx < k_valid)[None, :]
        mask = valid if mask is None else mask & valid
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", w, v)
    return out.reshape(b, sq, h, v.shape[-1])


def gqa_forward(p: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ModelConfig, *, positions: torch.Tensor,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_pos: Optional[int] = None, causal: bool = True,
                return_kv: bool = False
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One self-attention layer over ``x`` (B, S, D); weights wq (D,H,Dh),
    wk/wv (D,G,Dh), wo (H,Dh,D).

    Training without a cache, prefill with ``return_kv`` (returns the
    post-RoPE k and v), or decode with ``cache`` + ``cache_pos`` (see the
    module doc).  Returns (output, new k/v or the updated cache or None)."""
    cd = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(cd))
    q = apply_rope(q, positions, cfg.rope_theta)
    k = torch.einsum("bsd,dgk->bsgk", x, p["wk"].to(cd))
    v = torch.einsum("bsd,dgk->bsgk", x, p["wv"].to(cd))
    k = apply_rope(k, positions, cfg.rope_theta)
    if cache is not None:
        end = cache_pos + x.shape[1]
        cache["k"][:, cache_pos:end] = k.to(cache["k"].dtype)
        cache["v"][:, cache_pos:end] = v.to(cache["v"].dtype)
        out = flash_attention(q, cache["k"][:, :end], cache["v"][:, :end],
                              causal=False)
        new_kv = cache
    elif return_kv:
        out = flash_attention(q, k, v, causal=causal)
        new_kv = {"k": k, "v": v}
    else:
        out = attend(q, k, v, causal=causal)
        new_kv = None
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(cd)), new_kv


def gqa_cache_spec(cfg: ModelConfig, batch: int, seq: int,
                   dtype: torch.dtype) -> Dict[str, TensorSpec]:
    shape = (batch, seq, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": TensorSpec(shape, dtype), "v": TensorSpec(shape, dtype)}
