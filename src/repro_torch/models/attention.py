"""Grouped-query attention (llama-style) and multi-head latent attention
(MLA, DeepSeek-V2) with the JAX package's cache modes.

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

MLA (``mla_forward``, the JAX package's ``repro/models/attention.py:235-
321``) trains on ``attend`` and prefills through the kernel latent-
expanded: k is each head's ``latent . w_uk`` beside the shared RoPE key,
v is ``latent . w_uv`` (Dqk 192, Dv 128 at full width), causal.  Decode is
*absorbed*: q's no-RoPE part is folded through ``w_uk`` and attention runs
over the latent cache itself, one kv head for all query heads, scaled by
``(qk_nope + qk_rope) ** -0.5``.  The cache of one layer is JAX's
``{"latent": (B, S, R), "rope": (B, S, Dr)}``, which the port keeps as two
views of one ``(B, S, R + Dr)`` buffer (``mla_cache``): a step writes one
row, and the kernel reads the rows' first ``R + Dr`` columns as K and
their first ``R`` as V through the strides, with no copy.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.model_api import TensorSpec
from repro_torch.models.modules import apply_rope, rms_norm

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
        if end > cache["k"].shape[1]:   # a slice past the end takes nothing
            raise ValueError(f"decode at positions {cache_pos}..{end - 1} "
                             f"past a cache of {cache['k'].shape[1]}")
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


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention)
# ---------------------------------------------------------------------------

def mla_leaves(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...], Tuple]]:
    """Leaf shapes and init rules of one MLA layer (``init_mla``)."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    dense = ("dense", None)
    return {"wq": ((d, h, qk), dense),
            "w_dkv": ((d, m.kv_lora_rank), dense),
            "w_kr": ((d, m.qk_rope_head_dim), dense),
            "latent_norm": ((m.kv_lora_rank,), ("ones", None)),
            "w_uk": ((m.kv_lora_rank, h, m.qk_nope_head_dim), dense),
            "w_uv": ((m.kv_lora_rank, h, m.v_head_dim), dense),
            "wo": ((h, m.v_head_dim, d), dense)}


def mla_latent(p: Dict[str, torch.Tensor], x: torch.Tensor,
               cfg: ModelConfig, positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The normed latent (B, S, R) and the post-RoPE shared key (B, S,
    Dr) of ``x`` (``_mla_latent``)."""
    cd = x.dtype
    latent = rms_norm(torch.matmul(x, p["w_dkv"].to(cd)), p["latent_norm"],
                      cfg.norm_eps)
    k_rope = torch.matmul(x, p["w_kr"].to(cd))
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]
    return latent, k_rope


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, R) x (R, H, K) -> (B, S, H, K), contiguous."""
    b, s, r = x.shape
    return torch.matmul(x, w.reshape(r, -1).to(x.dtype)).view(
        b, s, w.shape[1], w.shape[2])


def mla_rows(cache: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The cache's rows ``[latent | rope]`` (B, S, R + Dr), a view of the
    buffer ``mla_cache`` allocates; raises for a cache whose two parts
    lie apart (a copy of every row at every decode step)."""
    lat, rope = cache["latent"], cache["rope"]
    r = lat.shape[-1]
    if not (lat.stride() == rope.stride() and lat.stride(-1) == 1
            and rope.data_ptr() == lat.data_ptr() + r * lat.element_size()):
        raise ValueError("an MLA cache's latent and rope must be views of "
                         "one row buffer (attention.mla_cache)")
    return lat.as_strided(lat.shape[:-1] + (r + rope.shape[-1],),
                          lat.stride())


def mla_forward(p: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ModelConfig, *, positions: torch.Tensor,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_pos: Optional[int] = None, return_kv: bool = False
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One MLA layer over ``x`` (B, S, D): training (plain ``attend``),
    prefill with ``return_kv`` (the kernel; returns the latent and the
    shared key) or absorbed decode with ``cache`` + ``cache_pos`` (the
    kernel over the latent cache, written in place).  Returns (output,
    the new latent/rope, the updated cache or None)."""
    m = cfg.mla
    cd = x.dtype
    b, s, _ = x.shape
    h = cfg.num_heads
    dn, dr = m.qk_nope_head_dim, m.qk_rope_head_dim
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(cd))
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    wo = p["wo"].to(cd)

    if cache is None:
        latent, k_rope = mla_latent(p, x, cfg, positions)
        k = torch.cat([_heads(latent, p["w_uk"]),
                       k_rope[:, :, None, :].expand(b, s, h, dr)], dim=-1)
        v = _heads(latent, p["w_uv"])
        qf = torch.cat([q_nope, q_rope], dim=-1)
        if return_kv:
            out = flash_attention(qf, k, v, causal=True)
        else:
            out = attend(qf, k, v, causal=True)
        kv = {"latent": latent, "rope": k_rope} if return_kv else None
        return torch.einsum("bshk,hkd->bsd", out, wo), kv

    # ---- absorbed decode ----
    end = cache_pos + s
    if end > cache["latent"].shape[1]:
        raise ValueError(f"decode at positions {cache_pos}..{end - 1} past "
                         f"a cache of {cache['latent'].shape[1]}")
    latent_new, rope_new = mla_latent(p, x, cfg, positions)
    cache["latent"][:, cache_pos:end] = latent_new.to(cache["latent"].dtype)
    cache["rope"][:, cache_pos:end] = rope_new.to(cache["rope"].dtype)
    w_uk = p["w_uk"].to(cd)
    q_abs = torch.einsum("bshk,rhk->bshr", q_nope, w_uk)
    qc = torch.cat([q_abs, q_rope], dim=-1)                # (B,S,H,R+Dr)
    keys = mla_rows(cache)[:, :end, None, :]               # (B,T,1,R+Dr)
    ctx = flash_attention(qc, keys, keys[..., :m.kv_lora_rank],
                          causal=False, scale=(dn + dr) ** -0.5)
    out = torch.einsum("bshr,rhk->bshk", ctx, p["w_uv"].to(cd))
    return torch.einsum("bshk,hkd->bsd", out, wo), cache


def mla_cache_spec(cfg: ModelConfig, batch: int, seq: int,
                   dtype: torch.dtype) -> Dict[str, TensorSpec]:
    m = cfg.mla
    return {"latent": TensorSpec((batch, seq, m.kv_lora_rank), dtype),
            "rope": TensorSpec((batch, seq, m.qk_rope_head_dim), dtype)}


def mla_cache(cfg: ModelConfig, lead: Tuple[int, ...], batch: int,
              seq: int, dtype: torch.dtype, device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """A zero MLA cache of shape ``lead + (batch, seq, ...)``: one buffer
    of rows ``[latent | rope]``, returned as the two views."""
    m = cfg.mla
    r = m.kv_lora_rank
    buf = torch.zeros(tuple(lead) + (batch, seq, r + m.qk_rope_head_dim),
                      dtype=dtype, device=device)
    return {"latent": buf[..., :r], "rope": buf[..., r:]}
