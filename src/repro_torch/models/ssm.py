"""Mamba2 / SSD (state-space duality) blocks of the port.

The counterparts of the JAX package's ``repro/models/ssm.py``:

- **Training** (no cache): the chunked SSD function in plain PyTorch
  (``kernels/ssd_scan/ref.py``'s ``ssd_scan_plain``, the one copy of that
  math) under autograd: the kernels are forward-only, as the JAX package's
  Pallas kernel has no backward.
- **Prefill** (``prefill=True``): the same function through
  ``repro_torch.kernels.ssd_scan`` (the CUDA kernel on the card); it also
  returns the decode cache of the layer.
- **Decode** (a ``cache`` with ``state`` and ``conv``): one recurrent step
  (``ssd_decode_step``) that updates the cache's state and conv window in
  place, where the JAX server donates the cache.

B and C keep their ``ngroups`` groups throughout (head h reads group
``h // (H / G)``): the port never makes the per-head copy of the JAX
model's ``_broadcast_groups`` (32 copies of B and C at Mamba2-370m).

Numerics follow the JAX model (bf16 projections and conv, float32 dt,
state and statistics) with one difference: ``a = -exp(A_log)`` is taken in
float32 from the bf16 parameter, where the JAX model's ``exp`` of a bf16
``A_log`` rounds to bf16; the tests' tolerances cover it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
from repro_torch.models.model_api import Rule, TensorSpec
from repro_torch.models.modules import rms_norm


def _a_log_init(shape) -> torch.Tensor:
    """A in (-16, -1): ``A_log = log(linspace(1, 16, H))``."""
    return torch.log(torch.linspace(1.0, 16.0, shape[0],
                                    dtype=torch.float32))


def init_mamba2(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...], Rule]]:
    """The Mamba2 mixer's leaves (path -> (shape, init rule)), the JAX
    ``init_mamba2``'s tree and initialisation."""
    s: SSMConfig = cfg.ssm
    d = cfg.d_model
    d_in = s.d_inner(d)
    h = d_in // s.head_dim
    gn = s.ngroups * s.state_dim
    conv_dim = d_in + 2 * gn
    dense = ("dense", None)
    return {
        "w_z": ((d, d_in), dense),
        "w_x": ((d, d_in), dense),
        "w_B": ((d, gn), dense),
        "w_C": ((d, gn), dense),
        "w_dt": ((d, h), dense),
        "dt_bias": ((h,), ("zeros", None)),
        "A_log": ((h,), ("value", _a_log_init)),
        "D_skip": ((h,), ("ones", None)),
        "conv_w": ((s.conv_kernel, conv_dim), ("dense", 0.2)),
        "conv_b": ((conv_dim,), ("zeros", None)),
        "out_norm": ((d_in,), ("ones", None)),
        "w_out": ((d_in, d), dense),
    }


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                    b_: torch.Tensor, c_: torch.Tensor, state: torch.Tensor
                    ) -> torch.Tensor:
    """One recurrent step: x (B,H,P), dt (B,H) float32, a_log (H,), b_ and
    c_ (B,G,N), state (B,H,P,N) float32, updated in place to
    ``state * exp(dt * a) + dt * x (x) B``.  Returns y = C . state (B,H,P)
    in x's dtype."""
    bsz, h, p = x.shape
    g, n = b_.shape[1], b_.shape[2]
    r = h // g
    a = -torch.exp(a_log.to(torch.float32))
    da = torch.exp(dt * a)                                     # (B,H)
    upd = torch.einsum("bgr,bgn,bgrp->bgrpn", dt.reshape(bsz, g, r),
                       b_.to(torch.float32),
                       x.to(torch.float32).reshape(bsz, g, r, p))
    state.mul_(da[..., None, None]).add_(upd.reshape(bsz, h, p, n))
    y = torch.einsum("bgn,bgrpn->bgrp", c_.to(torch.float32),
                     state.reshape(bsz, g, r, p, n))
    return y.reshape(bsz, h, p).to(x.dtype)


def _split_xbc(xbc: torch.Tensor, s: SSMConfig, d_in: int):
    gn = s.ngroups * s.state_dim
    return xbc[..., :d_in], xbc[..., d_in:d_in + gn], xbc[..., d_in + gn:]


def mamba2_forward(p: Dict[str, torch.Tensor], x: torch.Tensor,
                   cfg: ModelConfig, *,
                   cache: Optional[Dict[str, torch.Tensor]] = None,
                   prefill: bool = False
                   ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One Mamba2 mixer over ``x`` (B, S, D) in bf16.

    Training (no cache), prefill (``prefill=True``: returns the layer's
    decode cache ``{"state": (B,H,P,N) float32, "conv": (B, K-1, conv_dim)}``,
    the last K-1 conv inputs, zero-padded on the left for a shorter
    prompt) or a single-step decode (``cache``: updated in place and
    returned).  Returns (output (B, S, D), cache or None)."""
    s: SSMConfig = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    h = d_in // s.head_dim
    k = s.conv_kernel
    cd = x.dtype
    bsz, seq, _ = x.shape

    z = torch.matmul(x, p["w_z"].to(cd))
    xbc = torch.cat([torch.matmul(x, p["w_x"].to(cd)),
                     torch.matmul(x, p["w_B"].to(cd)),
                     torch.matmul(x, p["w_C"].to(cd))], dim=-1)
    dt = torch.logaddexp(
        torch.matmul(x, p["w_dt"].to(cd)).to(torch.float32)
        + p["dt_bias"].to(torch.float32), torch.zeros((), device=x.device))
    conv_w = p["conv_w"].to(cd)                           # (K, conv_dim)
    conv_b = p["conv_b"].to(cd)
    a_log = p["A_log"].to(torch.float32)
    new_cache = None

    if cache is not None:
        window = torch.cat([cache["conv"].to(cd), xbc], dim=1)  # (B,K,C)
        conv_out = torch.einsum("bkc,kc->bc", window, conv_w) + conv_b
        conv_out = F.silu(conv_out.to(torch.float32)).to(cd)
        cache["conv"].copy_(window[:, 1:])
        xs, bs, cs = _split_xbc(conv_out, s, d_in)
        xh = xs.reshape(bsz, h, s.head_dim)
        y = ssd_decode_step(
            xh, dt[:, 0], a_log, bs.reshape(bsz, s.ngroups, s.state_dim),
            cs.reshape(bsz, s.ngroups, s.state_dim), cache["state"])
        y = (y + p["D_skip"].to(cd)[None, :, None] * xh)[:, None]
        new_cache = cache
    else:
        # causal depthwise conv along time, summed in bf16 in the JAX
        # model's order
        pad = F.pad(xbc, (0, 0, k - 1, 0))
        conv_out = 0
        for i in range(k):
            conv_out = conv_out + pad[:, i:i + seq] * conv_w[i]
        conv_out = F.silu((conv_out + conv_b).to(torch.float32)).to(cd)
        xs, bs, cs = _split_xbc(conv_out, s, d_in)
        xh = xs.unflatten(-1, (h, s.head_dim))
        bg = bs.unflatten(-1, (s.ngroups, s.state_dim))
        cg = cs.unflatten(-1, (s.ngroups, s.state_dim))
        chunk = min(s.chunk_size, seq)
        scan = ssd_scan if prefill else ssd_scan_plain
        y, final_state = scan(xh, dt, a_log, bg, cg, chunk)
        y = y + p["D_skip"].to(cd)[None, None, :, None] * xh
        if prefill:
            conv = xbc.new_zeros((bsz, k - 1, xbc.shape[-1]))
            tail = xbc[:, -(k - 1):]
            conv[:, k - 1 - tail.shape[1]:] = tail
            new_cache = {"state": final_state, "conv": conv}

    y = y.reshape(bsz, -1, d_in)
    y = y * F.silu(z.to(torch.float32)).to(cd)
    y = rms_norm(y, p["out_norm"], cfg.norm_eps)
    return torch.matmul(y, p["w_out"].to(cd)), new_cache


def mamba2_cache_spec(cfg: ModelConfig, batch: int,
                      dtype: torch.dtype) -> Dict[str, TensorSpec]:
    """One layer's cache: the float32 state and the conv window in the
    compute ``dtype``."""
    s: SSMConfig = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    h = d_in // s.head_dim
    conv_dim = d_in + 2 * s.ngroups * s.state_dim
    return {
        "state": TensorSpec((batch, h, s.head_dim, s.state_dim),
                            torch.float32),
        "conv": TensorSpec((batch, s.conv_kernel - 1, conv_dim), dtype),
    }
