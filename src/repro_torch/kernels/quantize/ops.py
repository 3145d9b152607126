"""Blockwise int8 quantize and dequantize of a unit's leaves: the CUDA
kernels, their plain PyTorch versions, and the record layout the int8
checkpoint codec stores.

A leaf's record is its ``q`` (``256 * ceil(n / 256)`` int8) followed by its
float32 scales, one per block.  :func:`quantize_unit` writes every leaf's
record into one buffer (records start on 16 bytes, so each record's scales
sit 4-aligned); :func:`dequantize_unit` writes the dequantized values
straight into the destination leaves.  CUDA tensors go to the kernels
(``csrc/quantize.cu``, one launch per unit of up to 48 leaves); CPU tensors
take the plain versions (``ref.py``).  Both give the same bytes.  There is
no fallback from one to the other.

The kernels read and write float32 and bfloat16; a leaf of another dtype is
cast to float32 on its device first (quantize) or dequantized to float32
and cast into the leaf (dequantize), as the plain version does.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels.quantize.ref import (QUANT_BLOCK, dequantize_plain,
                                              n_quant_blocks, quantize_plain)

MAX_LEAVES = 48  # QUANT_MAX_LEAVES in csrc/quantize.cu
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class _QuantLeaf(ctypes.Structure):
    _fields_ = [("x", ctypes.c_void_p), ("q", ctypes.c_void_p),
                ("s", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("first_block", ctypes.c_longlong), ("dtype", ctypes.c_int),
                ("pad", ctypes.c_int)]


_ARGS = [ctypes.POINTER(_QuantLeaf), ctypes.c_int, ctypes.c_longlong,
         ctypes.c_void_p]
QUANTIZE = CudaKernel("quantize", "quantize_launch", _ARGS)
DEQUANTIZE = CudaKernel("quantize", "dequantize_launch", _ARGS)


def record_nbytes(n: int) -> int:
    """Bytes of the int8 record of an ``n``-element leaf: q, then scales."""
    nb = n_quant_blocks(n)
    return nb * QUANT_BLOCK + 4 * nb


@dataclasses.dataclass
class QuantizedUnit:
    """Every leaf's int8 record in one uint8 buffer on the leaves'
    device; ``offsets[i]`` is where leaf i's record starts."""
    buf: torch.Tensor
    offsets: List[int]
    sizes: List[int]           # elements of each leaf

    def n_blocks(self, i: int) -> int:
        return n_quant_blocks(self.sizes[i])

    def record(self, i: int) -> torch.Tensor:
        """Leaf i's record bytes (uint8): q, then scales."""
        off = self.offsets[i]
        return self.buf[off:off + record_nbytes(self.sizes[i])]

    def q(self, i: int) -> torch.Tensor:
        off, nb = self.offsets[i], self.n_blocks(i)
        return self.buf[off:off + nb * QUANT_BLOCK].view(torch.int8).view(
            nb, QUANT_BLOCK)

    def scales(self, i: int) -> torch.Tensor:
        nb = self.n_blocks(i)
        off = self.offsets[i] + nb * QUANT_BLOCK
        return self.buf[off:off + 4 * nb].view(torch.float32).view(nb, 1)


def _device_of(ts: Sequence[torch.Tensor], what: str) -> torch.device:
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"{what}: a unit's tensors must share one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} does not run on {dev}")
    return dev


def _launch(kernel: CudaKernel, rows: List[Tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor]]) -> None:
    """One launch per MAX_LEAVES of (leaf, q, scales) rows."""
    dev = rows[0][0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for lo in range(0, len(rows), MAX_LEAVES):
            chunk = rows[lo:lo + MAX_LEAVES]
            table = (_QuantLeaf * len(chunk))()
            first = 0
            for j, (x, q, s) in enumerate(chunk):
                table[j] = _QuantLeaf(x.data_ptr(), q.data_ptr(),
                                      s.data_ptr(), x.numel(), first,
                                      _KERNEL_DTYPES[x.dtype], 0)
                first += n_quant_blocks(x.numel())
            kernel.launch(table, len(chunk), first, stream)


def quantize_unit(leaves: Sequence[torch.Tensor]) -> QuantizedUnit:
    """Every leaf's int8 record in one buffer on the leaves' device (one
    kernel launch on the card, on the current stream)."""
    if not leaves:
        raise ValueError("quantize_unit needs at least one tensor")
    dev = _device_of(leaves, "quantize")
    offsets, sizes, total = [], [], 0
    for x in leaves:
        offsets.append(total)
        sizes.append(x.numel())
        total += -(-record_nbytes(x.numel()) // 16) * 16
    unit = QuantizedUnit(torch.empty(max(total, 1), dtype=torch.uint8,
                                     device=dev), offsets, sizes)
    if dev.type == "cpu":
        for i, x in enumerate(leaves):
            q, s = quantize_plain(x)
            unit.q(i).copy_(q)
            unit.scales(i).copy_(s)
        return unit
    rows = []
    for i, x in enumerate(leaves):
        if x.numel() == 0:
            continue
        x = x.detach()
        if x.dtype not in _KERNEL_DTYPES:
            x = x.to(torch.float32)
        if not x.is_contiguous():
            raise ValueError("the quantize kernel needs contiguous leaves")
        rows.append((x, unit.q(i), unit.scales(i)))
    if rows:
        _launch(QUANTIZE, rows)
    return unit


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q int8 (nq, 256), scales float32 (nq, 1))`` of one tensor."""
    unit = quantize_unit([x])
    return unit.q(0), unit.scales(0)


def dequantize_unit(records: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                    dsts: Sequence[torch.Tensor]) -> None:
    """Write ``dequantize(q, scales)`` into each destination leaf in place
    (one kernel launch on the card, on the current stream).  ``records[i]``
    is ``(q, scales)`` of ``dsts[i]``: ``ceil(n / 256)`` blocks of int8 and
    one float32 scale per block, on the leaves' device."""
    if len(records) != len(dsts) or not dsts:
        raise ValueError("dequantize_unit needs one record per leaf")
    dev = _device_of([*dsts, *[t for r in records for t in r]],
                     "dequantize")
    for (q, s), dst in zip(records, dsts):
        nb = n_quant_blocks(dst.numel())
        if (q.dtype != torch.int8 or s.dtype != torch.float32
                or q.numel() != nb * QUANT_BLOCK or s.numel() != nb):
            raise ValueError(f"an int8 record of {q.numel()} q and "
                             f"{s.numel()} scales does not fit a leaf of "
                             f"{dst.numel()} elements")
        if not dst.is_contiguous():
            raise ValueError("dequantize writes contiguous leaves")
    if dev.type == "cpu":
        with torch.no_grad():
            for (q, s), dst in zip(records, dsts):
                dst.view(-1).copy_(dequantize_plain(q, s, dst.numel(),
                                                    dst.dtype))
        return
    rows, casts = [], []
    for (q, s), dst in zip(records, dsts):
        if dst.numel() == 0:
            continue
        if not (q.is_contiguous() and s.is_contiguous()):
            raise ValueError("the dequantize kernel needs contiguous q and "
                             "scales")
        out = dst
        if dst.dtype not in _KERNEL_DTYPES:
            out = torch.empty(dst.shape, dtype=torch.float32, device=dev)
            casts.append((dst, out))
        rows.append((out, q, s))
    if rows:
        _launch(DEQUANTIZE, rows)
    with torch.no_grad():
        for dst, out in casts:
            dst.copy_(out)


def dequantize(q: torch.Tensor, scales: torch.Tensor, size: int,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The first ``size`` dequantized elements of one record, flat."""
    out = torch.empty(size, dtype=out_dtype, device=q.device)
    dequantize_unit([(q, scales)], [out])
    return out


__all__ = ["DEQUANTIZE", "MAX_LEAVES", "QUANTIZE", "QuantizedUnit",
           "dequantize", "dequantize_unit", "quantize", "quantize_unit",
           "record_nbytes"]
