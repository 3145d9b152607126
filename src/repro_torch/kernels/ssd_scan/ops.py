"""Mamba2 SSD chunk scan, forward only: the CUDA kernel and its plain
PyTorch version behind one wrapper.

``ssd_scan(xs, dt, a_log, bs, cs, chunk)`` takes the public layout of the
JAX package's wrapper (``repro/kernels/ssd_scan/ops.py``), except that B
and C keep their ``G`` groups instead of one copy per head: xs
``(B, S, H, P)``, dt ``(B, S, H)`` float32, a_log ``(H,)`` float32, bs and
cs ``(B, S, G, N)`` with ``H % G == 0``; it returns y ``(B, S, H, P)`` in
xs's dtype and the final state ``(B, H, P, N)`` float32.  Any ``S`` works
(a ragged tail scans as ``dt = 0`` steps).  CUDA tensors go to the kernel
(``csrc/ssd_scan.cu``, one launch per call), which reads every input
through its strides (the last dimension of x, B and C contiguous), so the
model passes views of its conv output without a copy.  CPU tensors take
the plain version (``ref.py``).  There is no fallback from one to the
other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel, check_strided_operand
from repro_torch.kernels.ssd_scan.ref import ssd_scan_plain

HEAD_DIM = 64      # P the kernel takes (Mamba2's published head dim)
STATE_DIM = 128    # N the kernel takes (Mamba2's published state dim)
MAX_CHUNK = 256

KERNEL = CudaKernel("ssd_scan", "ssd_scan_launch", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p])


def _check_shapes(xs, dt, a_log, bs, cs, chunk: int) -> None:
    if xs.dim() != 4 or dt.dim() != 3 or a_log.dim() != 1 \
            or bs.dim() != 4 or cs.shape != bs.shape:
        raise ValueError(f"ssd_scan takes xs (B,S,H,P), dt (B,S,H), a_log "
                         f"(H,), bs and cs (B,S,G,N); got {tuple(xs.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(a_log.shape)}, "
                         f"{tuple(bs.shape)}, {tuple(cs.shape)}")
    b, s, h, _ = xs.shape
    g = bs.shape[2]
    if tuple(dt.shape) != (b, s, h) or a_log.shape[0] != h \
            or tuple(bs.shape[:2]) != (b, s) or g == 0 or h % g:
        raise ValueError(f"ssd_scan: xs {tuple(xs.shape)} does not fit dt "
                         f"{tuple(dt.shape)}, a_log {tuple(a_log.shape)} or "
                         f"bs/cs {tuple(bs.shape)} (batch, seq, H % G)")
    if s == 0 or chunk < 1:
        raise ValueError("ssd_scan needs at least one step and chunk >= 1")


def ssd_scan(xs: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             bs: torch.Tensor, cs: torch.Tensor, chunk: int):
    """The SSD chunk scan over (B, S, heads, ...) tensors (see module
    doc); returns (y, final state)."""
    _check_shapes(xs, dt, a_log, bs, cs, chunk)
    dev = xs.device
    if any(t.device != dev for t in (dt, a_log, bs, cs)):
        raise ValueError("ssd_scan: all inputs must share a device")
    if dev.type == "cpu":
        return ssd_scan_plain(xs, dt, a_log, bs, cs, chunk)
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan does not run on {dev}")
    if xs.dtype not in (torch.bfloat16, torch.float32) \
            or bs.dtype != xs.dtype or cs.dtype != xs.dtype \
            or dt.dtype != torch.float32 or a_log.dtype != torch.float32:
        raise TypeError("ssd_scan kernel takes bf16 or float32 xs, bs, cs of "
                        "one dtype and float32 dt and a_log")
    b, s, h, p = xs.shape
    g, n = bs.shape[2], bs.shape[3]
    if p != HEAD_DIM or n != STATE_DIM:
        raise ValueError(f"ssd_scan kernel takes P {HEAD_DIM} and N "
                         f"{STATE_DIM}, not {p} and {n}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"ssd_scan kernel takes chunks of at most "
                         f"{MAX_CHUNK} steps, not {chunk}")
    for name, t in (("xs", xs), ("bs", bs), ("cs", cs)):
        check_strided_operand("ssd_scan", name, t)
    a_log = a_log.contiguous()
    y = torch.empty((b, s, h, p), dtype=xs.dtype, device=dev)
    fin = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 15)(*xs.stride()[:3], *dt.stride(),
                                       *bs.stride()[:3], *cs.stride()[:3],
                                       *y.stride()[:3])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        KERNEL.launch(xs.data_ptr(), dt.data_ptr(), a_log.data_ptr(),
                      bs.data_ptr(), cs.data_ptr(), y.data_ptr(),
                      fin.data_ptr(), strides, b, s, h, g, p, n, chunk,
                      int(xs.dtype == torch.bfloat16), stream)
    return y, fin
