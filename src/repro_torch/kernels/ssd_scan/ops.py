"""Mamba2 SSD chunk scan, forward only: the CUDA kernel and its plain
PyTorch version behind one wrapper.

``ssd_scan(xs, dt, a_log, bs, cs, chunk)`` takes the public layout of the
JAX package's wrapper (``repro/kernels/ssd_scan/ops.py``), except that B
and C keep their ``G`` groups instead of one copy per head: xs
``(B, S, H, P)``, dt ``(B, S, H)`` float32, a_log ``(H,)`` float32, bs and
cs ``(B, S, G, N)`` with ``H % G == 0``; it returns y ``(B, S, H, P)`` in
xs's dtype and the final state ``(B, H, P, N)`` float32.  Any ``S`` works
(a ragged tail scans as ``dt = 0`` steps).  CPU tensors take the plain
version (``ref.py``).  CUDA tensors go to ``csrc/ssd_scan.cu`` (one C entry
call per wrapper call, so ``KERNEL.launches`` counts calls) by one of two
routes:

- ``f32``: float32 arithmetic on the CUDA cores, one CTA per (batch, head)
  looping over the chunks, summing in the plain version's order (its y
  equals the plain version's bit for bit); takes float32 or bf16 xs, bs,
  cs.  ``ssd_scan`` takes this route for every dtype;
- ``bf16``: bf16 xs, bs, cs; chunk-parallel on the tensor cores (wgmma),
  three kernels: each chunk's L and own state, the states passed across
  the chunks in order, then y per 64-row tile; the float32 operands (w x,
  the entering state, the decayed scores) enter as three bf16 pieces that
  sum to them exactly.  Scratch (the per-chunk states, their pieces and
  L: ``scratch_specs``) comes from here.  It is faster than the f32
  route and as accurate (PERF.md, section 6), but it sums in another
  order, and the 48-layer Mamba2 prefill carries the one-ulp differences
  of y this gives past the bound to which ``chip_smoke.py`` holds it
  against the plain scan's forward (``SSD_PREFILL_TOL``).  So only
  ``launch`` takes it, until that bound is restated (ROADMAP.md, C4).

Both read every input through its strides (the last dimension of x, B and
C contiguous), so the model passes views of its conv output without a
copy.  A route launches its kernels or raises: there is no fallback from
one to another or to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel, check_strided_operand
from repro_torch.kernels.ssd_scan.ref import ssd_scan_plain

HEAD_DIM = 64      # P the kernel takes (Mamba2's published head dim)
STATE_DIM = 128    # N the kernel takes (Mamba2's published state dim)
MAX_CHUNK = 256
ROUTES = {"f32": 0, "bf16": 1}
ROUTE_DTYPES = {"f32": (torch.float32, torch.bfloat16),
                "bf16": (torch.bfloat16,)}

KERNEL = CudaKernel("ssd_scan", "ssd_scan_launch", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p])


def scratch_specs(b: int, s: int, h: int, chunk: int):
    """The bf16 route's scratch as (shape, dtype): each chunk's own state
    (B, H, NC, P, N) float32, the states entering the chunks as three bf16
    pieces in the kernel's swizzled layout (B, H, NC, 3, 2, P, 64) and L
    (B, H, NC, Q) float32."""
    nc = -(-s // chunk)
    return (((b, h, nc, HEAD_DIM, STATE_DIM), torch.float32),
            ((b, h, nc, 3, 2, HEAD_DIM, 64), torch.bfloat16),
            ((b, h, nc, chunk), torch.float32))


def scratch_bytes(b: int, s: int, h: int, chunk: int) -> int:
    """Bytes of scratch one bf16-route call takes (none on the f32 route)."""
    return sum(torch.Size(sh).numel() * kind.itemsize
               for sh, kind in scratch_specs(b, s, h, chunk))


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
    return _launch(xs, dt, a_log, bs, cs, chunk, "f32")


def launch(xs: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
           bs: torch.Tensor, cs: torch.Tensor, chunk: int, route: str):
    """One C entry call by ``route`` on CUDA tensors (``ssd_scan`` takes
    the f32 route; a caller names the bf16 route here)."""
    if route not in ROUTES:
        raise ValueError(f"ssd_scan: no route {route!r} (routes: "
                         f"{', '.join(ROUTES)})")
    _check_shapes(xs, dt, a_log, bs, cs, chunk)
    if xs.device.type != "cuda" or any(t.device != xs.device
                                       for t in (dt, a_log, bs, cs)):
        raise ValueError("ssd_scan kernels take inputs on one CUDA device")
    return _launch(xs, dt, a_log, bs, cs, chunk, route)


def _launch(xs, dt, a_log, bs, cs, chunk, route):
    want = ROUTE_DTYPES[route]
    if xs.dtype not in want or bs.dtype != xs.dtype or cs.dtype != xs.dtype \
            or dt.dtype != torch.float32 or a_log.dtype != torch.float32:
        raise TypeError(f"ssd_scan: route {route!r} takes xs, bs, cs of one "
                        f"dtype of {want} and float32 dt and a_log, not "
                        f"{xs.dtype}/{bs.dtype}/{cs.dtype}, {dt.dtype}, "
                        f"{a_log.dtype}")
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
    dev = xs.device
    a_log = a_log.contiguous()
    y = torch.empty((b, s, h, p), dtype=xs.dtype, device=dev)
    fin = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    scratch = [None] * 3   # the bf16 route's; freed after the call (stream
    if route == "bf16":    # order keeps it alive for the kernels)
        scratch = [torch.empty(sh, dtype=kind, device=dev)
                   for sh, kind in scratch_specs(b, s, h, chunk)]
    strides = (ctypes.c_longlong * 15)(*xs.stride()[:3], *dt.stride(),
                                       *bs.stride()[:3], *cs.stride()[:3],
                                       *y.stride()[:3])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        KERNEL.launch(xs.data_ptr(), dt.data_ptr(), a_log.data_ptr(),
                      bs.data_ptr(), cs.data_ptr(), y.data_ptr(),
                      fin.data_ptr(), strides, b, s, h, g, p, n, chunk,
                      ROUTES[route], int(xs.dtype == torch.bfloat16),
                      *(x if x is None else x.data_ptr() for x in scratch),
                      stream)
    return y, fin
