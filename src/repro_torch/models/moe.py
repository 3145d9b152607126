"""Mixture-of-experts FFN of the port, with the JAX package's routing,
capacity slots and combine weights (``repro/models/moe.py``).

Tokens are grouped by batch row (group == row), as in the JAX package:

- **Routing**: bf16 router logits, a float32 softmax, the top-k
  probabilities (``jax.lax.top_k``'s order: among equal probabilities the
  lower expert index first, which ``torch.topk`` does not promise, so the
  port sorts stably), renormalised to sum to 1.
- **Slots**: each (token, choice) takes the next free slot of its expert
  in its group, token-major (t, then k); a choice whose slot is past the
  capacity ``C`` is dropped (``keep`` false).
- **Aux loss**: ``aux_loss_coef * E * sum(mean prob * mean assignment)``.
- **Combine**: each token's output is the sum over its kept choices of the
  expert's output times the renormalised gate rounded to bf16 (the JAX
  package's ``comb`` is a bf16 tensor), then the shared experts' and the
  dense residual's SwiGLU.

Where the JAX package multiplies one-hot (G, T, E, C) dispatch and combine
tensors into per-(group, expert) capacity buffers, the port copies each
kept token into its (expert, group, slot) row of such a buffer with one
index copy, runs the experts as one batched matmul over the experts on
the rows up to the fullest slot in use (the rows past it are zero in the
JAX buffer and give zero output there), and gathers each token's kept
rows back.  Reading the fullest slot costs one host sync per layer.

A single-token call (decode) runs every expert densely on every token and
combines with the gates, the JAX package's ``moe_decode_forward``.  The
mesh-only parts of the JAX module (the data-shard branch of
``_row_parallel_expert_matmul``, ``maybe_constrain``) are ROADMAP A4.2.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.modules import swiglu


def moe_leaves(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...],
                                                      Tuple]]:
    """Leaf shapes and init rules of one MoE FFN (``init_moe``)."""
    m: MoEConfig = cfg.moe
    d, e, f = cfg.d_model, m.num_experts, m.d_ff_expert
    dense = ("dense", None)
    out = {"router": ((d, e), ("dense", 0.02)),
           "we_gate": ((e, d, f), dense),
           "we_up": ((e, d, f), dense),
           "we_down": ((e, f, d), dense)}
    if m.num_shared_experts:
        fs = f * m.num_shared_experts
        out.update({"ws_gate": ((d, fs), dense), "ws_up": ((d, fs), dense),
                    "ws_down": ((fs, d), dense)})
    if m.d_ff_dense_residual:
        fd = m.d_ff_dense_residual
        out.update({"wd_gate": ((d, fd), dense), "wd_up": ((d, fd), dense),
                    "wd_down": ((fd, d), dense)})
    return out


def capacity(tokens_per_group: int, m: MoEConfig) -> int:
    """Slots per expert and group: the JAX package's ``_capacity``."""
    cap = int(tokens_per_group * m.top_k * m.capacity_factor
              / m.num_experts)
    return max(8, -(-cap // 8) * 8)


def route(logits: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """float32 router logits (..., E) -> (probs (..., E), renormalised
    gates (..., k), expert indices (..., k)), in ``jax.lax.top_k``'s order:
    larger first, and among equal probabilities the lower index first."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = vals[..., :top_k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gates, idx[..., :top_k]


def slots(idx: torch.Tensor, num_experts: int, cap: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Expert choices (G, T, K) -> (slot (G, T, K) int64, clipped to
    ``cap - 1`` as the JAX package clips it; keep (G, T, K) bool; tokens
    each expert got in each group (G, E)).  A choice's slot is the number
    of earlier choices of its expert in its group, token-major."""
    g, t, k = idx.shape
    onehot = F.one_hot(idx.reshape(g, t * k), num_experts)     # (G,TK,E)
    rank = (onehot.cumsum(1) * onehot).sum(-1) - 1             # (G,TK)
    slot = rank.reshape(g, t, k)
    keep = slot < cap
    return slot.clamp(0, cap - 1), keep, onehot.sum(1)


def aux_loss(probs: torch.Tensor, idx: torch.Tensor,
             m: MoEConfig) -> torch.Tensor:
    """The load-balancing loss: coef * E * sum(mean prob * mean count)."""
    e = m.num_experts
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(idx, e).to(torch.float32).sum(2).mean(dim=(0, 1))
    return m.aux_loss_coef * e * torch.sum(me * ce)


def _experts(buf: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Every expert's SwiGLU on its rows: buf (E, N, D) -> (E, N, D)."""
    cd = buf.dtype
    g = torch.bmm(buf, p["we_gate"].to(cd))
    u = torch.bmm(buf, p["we_up"].to(cd))
    h = F.silu(g.to(torch.float32)).to(cd) * u
    return torch.bmm(h, p["we_down"].to(cd))


def _residuals(p: Dict[str, torch.Tensor], x: torch.Tensor,
               out: torch.Tensor, m: MoEConfig) -> torch.Tensor:
    if m.num_shared_experts:
        out = out + swiglu(x, p["ws_gate"], p["ws_up"], p["ws_down"])
    if m.d_ff_dense_residual:
        out = out + swiglu(x, p["wd_gate"], p["wd_up"], p["wd_down"])
    return out


def moe_decode_forward(p: Dict[str, torch.Tensor], x: torch.Tensor,
                       cfg: ModelConfig
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token MoE: every expert on every token, combined with the
    gates (zero off the token's top k); the aux loss is 0."""
    m: MoEConfig = cfg.moe
    cd = x.dtype
    b, s, d = x.shape
    if s != 1:
        raise ValueError(f"moe_decode_forward takes one token, not {s}")
    xt = x[:, 0]                                                 # (B, D)
    _, gate_vals, idx = route(torch.matmul(xt, p["router"].to(cd)),
                              m.top_k)
    gates = torch.zeros((b, m.num_experts), dtype=torch.float32,
                        device=x.device).scatter(1, idx, gate_vals)
    y = _experts(xt.unsqueeze(0).expand(m.num_experts, b, d), p)  # (E,B,D)
    out = (y.to(torch.float32)
           * gates.to(cd).to(torch.float32).t()[:, :, None]).sum(0)
    out = _residuals(p, x, out.to(cd)[:, None], m)
    return out.to(x.dtype), torch.zeros((), dtype=torch.float32,
                                        device=x.device)


def moe_forward(p: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), aux loss, a float32 scalar).  A
    single-token call takes ``moe_decode_forward``."""
    m: MoEConfig = cfg.moe
    cd = x.dtype
    b, s, d = x.shape
    if s == 1:
        return moe_decode_forward(p, x, cfg)
    e, k = m.num_experts, m.top_k
    cap = capacity(s, m)
    logits = torch.matmul(x, p["router"].to(cd))
    probs, gate_vals, idx = route(logits, k)
    aux = aux_loss(probs, idx, m)
    slot, keep, counts = slots(idx, e, cap)

    # rows of the (E, G, fill) buffer: the fullest slot in use bounds it
    fill = int(counts.clamp(max=cap).max())
    dev = x.device
    gi = torch.arange(b, device=dev).view(b, 1, 1)
    rows = ((idx * b + gi) * fill + slot.clamp(max=fill - 1)).reshape(-1)
    kept = keep.reshape(-1).nonzero().squeeze(1)
    # each kept (token, choice) from the token's copies: no index repeats,
    # so the backward adds no two gradients into one row in an order the
    # card chooses (k choices of a token repeat its row: an index_add with
    # repeats sums in a varying order on CUDA, and a varied bf16 rounding
    # flips later routing ties)
    xk = x.unsqueeze(2).expand(b, s, k, d).reshape(b * s * k, d)
    buf = x.new_zeros((e * b * fill, d)).index_copy(
        0, rows.index_select(0, kept), xk.index_select(0, kept))
    y = _experts(buf.view(e, b * fill, d), p).reshape(e * b * fill, d)

    comb = (gate_vals * keep).to(cd).to(torch.float32)           # (G,T,K)
    yk = y.index_select(0, rows).view(b, s, k, d).to(torch.float32)
    out = (yk * comb[..., None]).sum(2).to(cd)
    out = _residuals(p, x, out, m)
    return out.to(x.dtype), aux
