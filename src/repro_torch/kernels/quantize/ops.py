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

A launch takes its leaf table by value: :func:`record_rows` finds each
record's q and scales by integer arithmetic on the buffer's address (no
tensor views), and :func:`leaf_tables` gives each leaf its first block and
first quantize stage and packs the rows as the kernel's ``QuantLeaf``
array.

The kernels read and write float32 and bfloat16; a leaf of another dtype is
cast to float32 on its device first (quantize) or dequantized to float32
and cast into the leaf (dequantize), as the plain version does.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import struct
from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels.quantize.ref import (QUANT_BLOCK, dequantize_plain,
                                              n_quant_blocks, quantize_plain)

MAX_LEAVES = 48             # QUANT_MAX_LEAVES in csrc/quantize.cu
STAGE_BYTES = 16384         # QUANT_STAGE_BYTES in csrc/quantize.cu
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ELEM_BYTES = (4, 2)        # by kernel dtype code

_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
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


def stage_blocks(dtype: int) -> int:
    """Blocks of a quantize stage for kernel dtype code ``dtype``."""
    return STAGE_BYTES // (QUANT_BLOCK * _ELEM_BYTES[dtype])


def leaf_stages(n: int, dtype: int) -> int:
    """Quantize stages of an ``n``-element leaf: its whole blocks in runs
    of ``stage_blocks``, then the zero-padded tail block alone."""
    return -(-(n // QUANT_BLOCK) // stage_blocks(dtype)) + (
        n % QUANT_BLOCK != 0)


@dataclasses.dataclass
class LeafTable:
    """One launch's leaf table: a row ``(x, q, s, n, first_block,
    first_stage, dtype)`` per leaf, pointers as integers, the blocks and
    stages of the launch, and the rows packed as the kernel's
    ``QuantLeaf`` array."""
    rows: List[Tuple[int, int, int, int, int, int, int]]
    blocks: int
    stages: int
    packed: bytes


@functools.lru_cache(maxsize=None)
def _packer(n_rows: int) -> struct.Struct:
    """``n_rows`` rows of csrc/quantize.cu's QuantLeaf: x, q, s, n,
    first_block, first_stage, then dtype in the low half of the last
    eight bytes (little-endian; the high half is its padding)."""
    return struct.Struct(f"<{7 * n_rows}q")


def leaf_tables(rows: Sequence[Tuple[int, int, int, int, int]]
                ) -> List[LeafTable]:
    """The launch tables of ``(x, q, s, n, dtype)`` rows (pointers as
    integers, n > 0), ``MAX_LEAVES`` a launch: each row gets its first
    block and first stage in its launch."""
    tables = []
    for lo in range(0, len(rows), MAX_LEAVES):
        out, flat, blocks, stages = [], [], 0, 0
        for x, q, s, n, dtype in rows[lo:lo + MAX_LEAVES]:
            row = (x, q, s, n, blocks, stages, dtype)
            out.append(row)
            flat += row
            blocks += n_quant_blocks(n)
            stages += leaf_stages(n, dtype)
        tables.append(LeafTable(out, blocks, stages,
                                _packer(len(out)).pack(*flat)))
    return tables


def record_rows(unit: QuantizedUnit, leaves: Sequence[torch.Tensor]
                ) -> List[Tuple[int, int, int, int, int]]:
    """``(x, q, s, n, dtype)`` of every non-empty leaf, its record's q and
    scales found by integer arithmetic on ``unit.buf``'s address (no
    tensor views); the leaves are float32 or bfloat16 and contiguous."""
    base = unit.buf.data_ptr()
    return [(x.data_ptr(), base + off,
             base + off + n_quant_blocks(n) * QUANT_BLOCK, n,
             _KERNEL_DTYPES[x.dtype])
            for x, off, n in zip(leaves, unit.offsets, unit.sizes) if n]


def _device_of(ts: Sequence[torch.Tensor], what: str) -> torch.device:
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"{what}: a unit's tensors must share one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} does not run on {dev}")
    return dev


def _launch(kernel: CudaKernel, dev: torch.device,
            rows: List[Tuple[int, int, int, int, int]], quant: bool) -> None:
    """One launch per MAX_LEAVES rows, on the current stream."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for t in leaf_tables(rows):
            kernel.launch(t.packed, len(t.rows),
                          t.stages if quant else t.blocks, stream)


def quantize_unit(leaves: Sequence[torch.Tensor]) -> QuantizedUnit:
    """Every leaf's int8 record in one buffer on the leaves' device (one
    kernel launch on the card, on the current stream)."""
    if not leaves:
        raise ValueError("quantize_unit needs at least one tensor")
    dev = _device_of(leaves, "quantize")
    sizes = [x.numel() for x in leaves]
    offsets, total = [], 0
    for n in sizes:
        offsets.append(total)
        total += -(-record_nbytes(n) // 16) * 16
    unit = QuantizedUnit(torch.empty(max(total, 1), dtype=torch.uint8,
                                     device=dev), offsets, sizes)
    if dev.type == "cpu":
        for i, x in enumerate(leaves):
            q, s = quantize_plain(x)
            unit.q(i).copy_(q)
            unit.scales(i).copy_(s)
        return unit
    xs = [x if x.dtype in _KERNEL_DTYPES else x.detach().to(torch.float32)
          for x in leaves]
    if not all(x.is_contiguous() for x in xs):
        raise ValueError("the quantize kernel needs contiguous leaves")
    rows = record_rows(unit, xs)
    if rows:
        _launch(QUANTIZE, dev, rows, True)
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
        n = dst.numel()
        if n == 0:
            continue
        if not (q.is_contiguous() and s.is_contiguous()):
            raise ValueError("the dequantize kernel needs contiguous q and "
                             "scales")
        out = dst
        if dst.dtype not in _KERNEL_DTYPES:
            out = torch.empty(dst.shape, dtype=torch.float32, device=dev)
            casts.append((dst, out))
        rows.append((out.data_ptr(), q.data_ptr(), s.data_ptr(), n,
                     _KERNEL_DTYPES[out.dtype]))
    if rows:
        _launch(DEQUANTIZE, dev, rows, False)
    with torch.no_grad():
        for dst, out in casts:
            dst.copy_(out)


def dequantize(q: torch.Tensor, scales: torch.Tensor, size: int,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The first ``size`` dequantized elements of one record, flat."""
    out = torch.empty(size, dtype=out_dtype, device=q.device)
    dequantize_unit([(q, scales)], [out])
    return out


__all__ = ["DEQUANTIZE", "LeafTable", "MAX_LEAVES", "QUANTIZE",
           "QuantizedUnit", "STAGE_BYTES", "dequantize", "dequantize_unit",
           "leaf_stages", "leaf_tables", "quantize", "quantize_unit",
           "record_nbytes", "record_rows", "stage_blocks"]
