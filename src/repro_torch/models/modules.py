"""Common layers as plain functions over tensors, with the JAX package's
numerics: bf16 compute, float32 statistics, float32 logits.

Params are nested dicts of leaf tensors in the einsum layouts of the JAX
package (e.g. ``w_gate`` is ``(d_model, d_ff)``), not ``nn.Module``s.
"""
from __future__ import annotations

import zlib
from typing import Optional

import torch
import torch.nn.functional as F

COMPUTE_DTYPE = torch.bfloat16     # a model's default (``build_model``)


def leaf_seed(seed: int, path: str) -> int:
    """Deterministic per-leaf generator seed (stable across processes)."""
    return (seed * 1_000_003 + zlib.crc32(path.encode())) % (2**63)


def truncated_normal(shape, scale: float, seed: int, path: str,
                     device: torch.device) -> torch.Tensor:
    """float32 N(0, 1) truncated to [-2, 2], times ``scale``, from a
    generator seeded by (seed, path)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, path))
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(scale)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with float32 statistics, output in the input dtype."""
    x32 = x.to(torch.float32)
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (B, S, H, D); positions: (S,)."""
    d = x.shape[-1]
    inv = rope_frequencies(d, theta, x.device)
    ang = positions[:, None].to(torch.float32) * inv        # (S, d/2)
    sin = torch.sin(ang)[:, None, :]                         # (S, 1, d/2)
    cos = torch.cos(ang)[:, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def embed_lookup(embedding: torch.Tensor, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    return F.embedding(tokens.long(), embedding.to(dtype))


def unembed_logits(x: torch.Tensor, kernel: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """Hidden states -> float32 vocab logits.  kernel: (D, V), rounded to
    the compute ``dtype``.  bf16 inputs multiply exactly in float32, so
    this is the float32-accumulated product of the bf16 operands."""
    return torch.matmul(x.to(torch.float32),
                        kernel.to(dtype).to(torch.float32))


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: silu(x@Wg) * (x@Wu) @ Wd.  Weights (D,F), (D,F), (F,D)."""
    g = torch.matmul(x, w_gate.to(x.dtype))
    u = torch.matmul(x, w_up.to(x.dtype))
    h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    return torch.matmul(h, w_down.to(x.dtype))


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy in float32.  logits (..., V), targets (...)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        mask = mask.to(torch.float32)
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()
