"""Grouped-query flash attention, forward only: the CUDA kernels and their
plain PyTorch version behind one wrapper.

``flash_attention(q, k, v, causal=...)`` takes the public layout of the
JAX package's wrapper (``repro/kernels/flash_attention/ops.py``): q
``(B, Sq, H, D)``, k and v ``(B, Sk, G, D)``, out ``(B, Sq, H, D)`` in q's
dtype.  CPU tensors take the plain version (``ref.py``).  CUDA tensors go
to ``csrc/flash_attention.cu`` (one C entry call per wrapper call, so
``KERNEL.launches`` counts calls) by one of three routes, picked from the
dtype and ``Sq`` alone (``pick_route``):

- ``prefill``: bf16 with ``Sq >= PREFILL_MIN_QUERIES``; bf16 tensor cores
  (wgmma), K/V tiles fed by TMA, p entering P.V as bf16 hi + lo;
- ``decode``: bf16 with fewer queries; split-K over the keys
  (``decode_split``) on the CUDA cores in float32, then a merge kernel;
- ``f32``: float32; the CUDA cores throughout.

Every route reads q, k and v through their strides (the last dimension
contiguous), so a decode step passes the cache prefix ``cache[:, :end]``
as it is.  A route launches its kernels or raises: there is no fallback
from one to another or to the plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels._build import CudaKernel, check_strided_operand
from repro_torch.kernels.flash_attention.ref import (attention_plain,
                                                     softmax_scale)

HEAD_DIMS = (64, 128)
ROUTES = {"f32": 0, "prefill": 1, "decode": 2}
# bf16 calls with at least this many queries take the prefill route: its
# CTA holds 128 positions of one query head in two 64-row wgmma tiles, so
# its time stays flat below 64 queries, while the decode route re-reads
# the keys once per 8 (position, head of group) rows; they cross between
# 2 and 3 queries at Yi-9B's heads over ~1 K keys (scripts/flash_routes.py;
# PERF.md, section 6, PR 16).
PREFILL_MIN_QUERIES = 3
# The decode route (DC_ROWS, DC_KEYS of the .cu): query rows
# (position, head of group) per CTA and keys per pipeline stage.
DECODE_ROWS = 8
DECODE_CHUNK = 32
DECODE_MIN_SPLIT = 64       # the shortest key slice a CTA takes
DECODE_CTAS_PER_SM = 2      # the split length aims at this many (1, 4 and
                            # 8 read slower: PERF.md, section 6, PR 16)

KERNEL = CudaKernel("flash_attention", "flash_attention_launch", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p])


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pick_route(dtype: torch.dtype, sq: int) -> str:
    """The route a CUDA call takes, from its dtype and query count."""
    if dtype == torch.float32:
        return "f32"
    return "prefill" if sq >= PREFILL_MIN_QUERIES else "decode"


def decode_rows(batch: int, sq: int, heads: int, kv_heads: int) -> int:
    """CTAs of the decode route per key slice: batch x kv heads x tiles of
    DECODE_ROWS (position, head of group) rows."""
    return batch * kv_heads * _cdiv(sq * (heads // kv_heads), DECODE_ROWS)


def decode_split(batch: int, sq: int, heads: int, kv_heads: int, sk: int,
                 sms: int) -> Tuple[int, int]:
    """(keys per slice, slices) of the decode route: slices of whole
    stages, at least DECODE_MIN_SPLIT keys, as many as give
    DECODE_CTAS_PER_SM CTAs on each of ``sms`` SMs; every key lies in
    exactly one slice and no slice is empty."""
    want = _cdiv(DECODE_CTAS_PER_SM * sms,
                 decode_rows(batch, sq, heads, kv_heads))
    split = max(DECODE_MIN_SPLIT,
                DECODE_CHUNK * _cdiv(sk, DECODE_CHUNK * want))
    return split, _cdiv(sk, split)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    return _launch(q, k, v, causal, pick_route(q.dtype, q.shape[1]))


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           route: str) -> torch.Tensor:
    """One C entry call by ``route`` on CUDA tensors (``flash_attention``
    picks the route; a caller may name one to time it)."""
    _check_shapes(q, k, v)
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError("flash_attention kernels take q, k, v on one CUDA "
                         "device")
    return _launch(q, k, v, causal, route)


_SCALES = {d: softmax_scale(d) for d in HEAD_DIMS}


def _launch(q, k, v, causal, route):
    # The decode step calls this 48 times on a host-bound step: keep the
    # host work to checks, two allocations and one ctypes call.
    want = torch.float32 if route == "f32" else torch.bfloat16
    if route not in ROUTES or q.dtype != want or k.dtype != want \
            or v.dtype != want:
        raise TypeError(f"flash_attention: route {route!r} takes {want} q, "
                        f"k, v, not {q.dtype}/{k.dtype}/{v.dtype}")
    b, sq, h, d = q.shape
    sk, g = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dim "
                         f"{HEAD_DIMS}, not {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_strided_operand("flash_attention", name, t)
    dev = q.device
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    split, splits, scratch = 0, 0, None
    if route == "decode":    # freed after the call: stream order keeps it
        split, splits = decode_split(b, sq, h, g, sk, _sm_count(dev.index))
        scratch = torch.empty(decode_rows(b, sq, h, g) * splits
                              * DECODE_ROWS * (d + 2), dtype=torch.float32,
                              device=dev)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            strides, b, sq, sk, h, g, d, int(causal), ROUTES[route],
            _SCALES[d], split, splits,
            None if scratch is None else scratch.data_ptr())
    if dev.index == torch.cuda.current_device():
        KERNEL.launch(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            KERNEL.launch(*args,
                          torch._C._cuda_getCurrentRawStream(dev.index))
    return out
