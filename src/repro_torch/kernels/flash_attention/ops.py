"""Grouped-query flash attention, forward only: the CUDA kernel and its
plain PyTorch version behind one wrapper.

``flash_attention(q, k, v, causal=...)`` takes the public layout of the
JAX package's wrapper (``repro/kernels/flash_attention/ops.py``): q
``(B, Sq, H, D)``, k and v ``(B, Sk, G, D)``, out ``(B, Sq, H, D)`` in q's
dtype.  CUDA tensors go to the kernel (``csrc/flash_attention.cu``, one
launch per call), which reads q, k and v through their strides (the last
dimension contiguous), so a decode step passes the cache prefix
``cache[:, :pos + 1]`` as it is.  CPU tensors take the plain version
(``ref.py``).  There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel, check_strided_operand
from repro_torch.kernels.flash_attention.ref import (attention_plain,
                                                     softmax_scale)

HEAD_DIMS = (64, 128)

KERNEL = CudaKernel("flash_attention", "flash_attention_launch", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention takes q (B,Sq,H,D) and k, v "
                         f"(B,Sk,G,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    _, sk, g, dk = k.shape
    if k.shape[0] != b or dk != d or g == 0 or h % g:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k/v {tuple(k.shape)} (batch, head dim, H % G)")
    if sq == 0 or sk == 0:
        raise ValueError("flash_attention needs at least one query and key")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Attention forward over (B, S, heads, D) tensors (see module doc).
    The causal mask is top-left: query i sees keys 0..i."""
    _check_shapes(q, k, v)
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("flash_attention: q, k and v must share a device")
    if dev.type == "cpu":
        return attention_plain(q, k, v, causal=causal)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention does not run on {dev}")
    if q.dtype not in (torch.bfloat16, torch.float32) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention kernel takes bf16 or float32 q, k, "
                        "v of one dtype")
    b, sq, h, d = q.shape
    sk, g = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dim "
                         f"{HEAD_DIMS}, not {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_strided_operand("flash_attention", name, t)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), strides, b, sq, sk, h, g, d,
                      int(causal), int(q.dtype == torch.bfloat16),
                      softmax_scale(d), stream)
    return out
