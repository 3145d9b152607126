"""Fused AdamW over a unit's leaves: the CUDA kernel and its plain PyTorch
version.

Both update in place: ``master``, ``m`` and ``v`` (float32) and the bf16
``param`` copy receive the new values; the gradient (bf16 or float32) is
scaled by ``gscale``, the global-norm clip factor, on the way in.  CUDA
tensors go to the kernel (``csrc/fused_adamw.cu``, one launch per unit);
CPU tensors take the plain version.  There is no fallback from one to the
other.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels._build import CudaKernel

MAX_LEAVES = 48  # ADAM_MAX_LEAVES in csrc/fused_adamw.cu


class _AdamLeaf(ctypes.Structure):
    _fields_ = [("g", ctypes.c_void_p), ("master", ctypes.c_void_p),
                ("m", ctypes.c_void_p), ("v", ctypes.c_void_p),
                ("p", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("wd", ctypes.c_float), ("pad", ctypes.c_int)]


KERNEL = CudaKernel("fused_adamw", "fused_adamw_launch", [
    ctypes.POINTER(_AdamLeaf), ctypes.c_int, ctypes.c_longlong,
    ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
    ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p])


def bias_corrections(step: int, b1: float, b2: float) -> Tuple[float, float]:
    """(1 - b1^t, 1 - b2^t) with t = step + 1, in float32 as the TPU
    kernel's host-side scalars are."""
    t = np.float32(step) + np.float32(1.0)
    c1 = np.float32(1.0) - np.float32(b1) ** t
    c2 = np.float32(1.0) - np.float32(b2) ** t
    return float(c1), float(c2)


def fused_adamw_plain(grads, masters, ms, vs, params, wds, *, lr: float,
                      b1: float, b2: float, eps: float, step: int,
                      gscale: torch.Tensor) -> None:
    """The kernel's function in plain PyTorch, in place, leaf by leaf."""
    c1, c2 = bias_corrections(step, b1, b2)
    lr32 = torch.tensor(lr, dtype=torch.float32)
    with torch.no_grad():
        _plain_update(grads, masters, ms, vs, params, wds, lr32, b1, b2,
                      eps, c1, c2, gscale)


def _plain_update(grads, masters, ms, vs, params, wds, lr32, b1, b2, eps,
                  c1, c2, gscale) -> None:
    for g, ma, m, v, p, wd in zip(grads, masters, ms, vs, params, wds):
        g32 = g.to(torch.float32) * gscale.to(g.device)
        m.mul_(b1).add_(g32 * (1.0 - b1))
        v.mul_(b2).add_(g32 * g32 * (1.0 - b2))
        upd = (m / c1) / (torch.sqrt(v / c2) + eps)
        ma.sub_(lr32.to(ma.device) * (upd + wd * ma))
        p.copy_(ma.to(p.dtype))


def fused_adamw(grads: Sequence[torch.Tensor], masters: Sequence[torch.Tensor],
                ms: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
                params: Sequence[torch.Tensor], wds: Sequence[float], *,
                lr: float, b1: float, b2: float, eps: float, step: int,
                gscale: torch.Tensor) -> None:
    """One AdamW update of a unit's leaves, in place (see module doc).

    ``grads`` bf16 (the kernel's input type; the plain version also takes
    float32), ``masters``/``ms``/``vs`` float32, ``params`` bf16, ``wds``
    the weight decay of each leaf, ``step`` the 0-based step the update
    completes, ``gscale`` a one-element float32 tensor on the leaves'
    device."""
    n = len(masters)
    if not (len(grads) == len(ms) == len(vs) == len(params) == len(wds) == n):
        raise ValueError("fused_adamw needs one of each tensor per leaf")
    dev = masters[0].device
    for ts in (grads, masters, ms, vs, params):
        for t in ts:
            if t.device != dev:
                raise ValueError("a unit's tensors must share one device")
    if dev.type == "cpu":
        fused_adamw_plain(grads, masters, ms, vs, params, wds, lr=lr, b1=b1,
                          b2=b2, eps=eps, step=step, gscale=gscale)
        return
    if dev.type != "cuda":
        raise ValueError(f"fused_adamw does not run on {dev}")
    for g, ma, m, v, p in zip(grads, masters, ms, vs, params):
        if g.dtype != torch.bfloat16 or p.dtype != torch.bfloat16:
            raise TypeError("fused_adamw kernel takes bf16 grads and params")
        if not all(t.dtype == torch.float32 for t in (ma, m, v)):
            raise TypeError("fused_adamw kernel takes float32 master/m/v")
        if not all(t.is_contiguous() and t.numel() == ma.numel()
                   for t in (g, ma, m, v, p)):
            raise ValueError("fused_adamw needs contiguous leaves of one size")
    if gscale.device != dev or gscale.dtype != torch.float32:
        raise ValueError("gscale must be float32 on the leaves' device")
    c1, c2 = bias_corrections(step, b1, b2)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for lo in range(0, n, MAX_LEAVES):
            idx = range(lo, min(n, lo + MAX_LEAVES))
            table = (_AdamLeaf * len(idx))()
            total = 0
            for j, i in enumerate(idx):
                table[j] = _AdamLeaf(grads[i].data_ptr(),
                                     masters[i].data_ptr(), ms[i].data_ptr(),
                                     vs[i].data_ptr(), params[i].data_ptr(),
                                     masters[i].numel(), float(wds[i]), 0)
                total += masters[i].numel()
            if total == 0:
                continue
            KERNEL.launch(table, len(idx), total, lr, b1, b2, eps, c1, c2,
                          gscale.data_ptr(), sms, stream)
