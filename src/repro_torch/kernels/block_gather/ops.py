"""Fused fingerprint + compare + dirty-block compaction of a unit's tensors:
the CUDA kernel, its plain PyTorch version, and the per-leaf and per-unit
wrappers the overlapped saver calls.

A CUDA tensor goes to the kernel (``csrc/block_gather.cu``, one launch per
unit over all its leaves); a CPU tensor takes the plain version.  Both give
the same uint32 pairs (held as int32 bits, as ``block_fp`` does), indices,
block bytes and counts bit for bit, and the same float32 sums of squares as
``block_fp`` on the same device.  There is no fallback from one to the
other, and no capacity or memory limit that changes the route.

Capacity is chosen by the caller (advisory, from the saver's dirty-block
predictor) and rounded up to a power of two by :func:`round_capacity`;
the returned ``count`` is authoritative: ``count > capacity`` means the
prediction was short, the first ``capacity`` dirty blocks are still exact,
and the caller gathers again with a larger buffer.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Any, List, Optional, Sequence

import torch

from repro_torch.dtypes import byte_view
from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels.block_fp.ops import (_DTYPE_CODES, _check_block_bytes,
                                              _fp_bits, fingerprint_plain,
                                              n_blocks_of)
from repro_torch.kernels.block_fp.ref import DEFAULT_BLOCK_BYTES

MAX_LEAVES = 32  # GB_MAX_LEAVES in csrc/block_gather.cu


class _GatherLeaf(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p), ("nbytes", ctypes.c_longlong),
                ("first_block", ctypes.c_longlong),
                ("n_blocks", ctypes.c_longlong), ("ref", ctypes.c_void_p),
                ("cap_offset", ctypes.c_longlong),
                ("capacity", ctypes.c_longlong), ("dtype", ctypes.c_int),
                ("itemsize", ctypes.c_int)]


KERNEL = CudaKernel("block_gather", "block_gather_launch", [
    ctypes.POINTER(_GatherLeaf), ctypes.c_int, ctypes.c_longlong,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p])


@dataclasses.dataclass
class GatherResult:
    """One leaf's fused gather, on the leaf's device (fetch only what you
    need: ``fp``/``idx``/``count`` are tiny, ``blocks`` is the payload)."""
    fp: torch.Tensor      # (n_blocks, 2) int32 bits of the uint32 pairs
    sumsq: torch.Tensor   # (n_blocks,) float32 — advisory
    idx: torch.Tensor     # (capacity,) int32, dirty indices ascending, -1
    blocks: torch.Tensor  # (capacity, block elems) leaf dtype (bool: uint8)
    count: torch.Tensor   # () int32 — TOTAL dirty blocks (may exceed cap)

    @property
    def capacity(self) -> int:
        return int(self.idx.shape[0])

    def block_bytes(self) -> torch.Tensor:
        """``blocks`` as (capacity, block_bytes) uint8."""
        return self.blocks.view(torch.uint8)


def round_capacity(n: int, n_blocks: int) -> int:
    """Round a predicted dirty-block count up to a power of two, clamped to
    [1, n_blocks]: a leaf sees O(log n_blocks) distinct buffer sizes, so the
    caching allocator reuses them."""
    n = max(1, min(int(n), int(n_blocks)))
    cap = 1
    while cap < n:
        cap *= 2
    return min(cap, int(n_blocks))


def _elem_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.uint8 if x.dtype == torch.bool else x.dtype


def _ref_bits(ref_fp, nb: int, device: torch.device
              ) -> Optional[torch.Tensor]:
    """The reference table as (nb, 2) int32 bits on ``device``, or None
    when there is none or it is not comparable (every block is dirty)."""
    if ref_fp is None:
        return None
    if tuple(ref_fp.shape) != (nb, 2):
        return None
    return _fp_bits(ref_fp, device).reshape(nb, 2).contiguous()


# ------------------------------------------------------------ plain version
def gather_dirty_plain(x: torch.Tensor, ref_fp, *, capacity: int,
                       block_bytes: int = DEFAULT_BLOCK_BYTES
                       ) -> GatherResult:
    """The kernel's function for one tensor in plain PyTorch, at exactly
    ``capacity`` output slots."""
    _check_block_bytes(x, block_bytes)
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    x = x.detach().contiguous()
    dev = x.device
    fp, ss = fingerprint_plain(x, block_bytes)
    nb = fp.shape[0]
    ref = _ref_bits(ref_fp, nb, dev)
    if ref is None:
        dirty = torch.ones(nb, dtype=torch.bool, device=dev)
    else:
        dirty = (fp != ref).any(1)
    count = dirty.sum(dtype=torch.int32)
    where = torch.nonzero(dirty).reshape(-1)[:capacity]
    k = where.numel()
    idx = torch.full((capacity,), -1, dtype=torch.int32, device=dev)
    idx[:k] = where.to(torch.int32)
    raw = byte_view(x)
    padded = torch.zeros(nb * block_bytes, dtype=torch.uint8, device=dev)
    padded[:raw.numel()] = raw
    out = torch.zeros((capacity, block_bytes), dtype=torch.uint8, device=dev)
    out[:k] = padded.view(nb, block_bytes).index_select(0, where)
    return GatherResult(fp=fp, sumsq=ss, idx=idx,
                        blocks=out.view(_elem_dtype(x)), count=count)


# ------------------------------------------------------------ kernel launch
def _gather_cuda(arrs: Sequence[torch.Tensor], refs: Sequence[Any],
                 caps: Sequence[int], block_bytes: int) -> List[GatherResult]:
    dev = arrs[0].device
    nbs = [n_blocks_of(a, block_bytes) for a in arrs]
    total_blocks, total_slots = sum(nbs), sum(caps)
    fp = torch.empty((total_blocks, 2), dtype=torch.int32, device=dev)
    ss = torch.empty((total_blocks,), dtype=torch.float32, device=dev)
    flags = torch.empty((total_blocks,), dtype=torch.uint8, device=dev)
    idx = torch.empty((total_slots,), dtype=torch.int32, device=dev)
    out = torch.empty((total_slots, block_bytes), dtype=torch.uint8,
                      device=dev)
    count = torch.empty((len(arrs),), dtype=torch.int32, device=dev)
    ref_bits = [_ref_bits(r, nb, dev) for r, nb in zip(refs, nbs)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        first = slot = 0
        for lo in range(0, len(arrs), MAX_LEAVES):
            hi = min(len(arrs), lo + MAX_LEAVES)
            table = (_GatherLeaf * (hi - lo))()
            nb_chunk = slots_chunk = 0
            for j, i in enumerate(range(lo, hi)):
                a, r = arrs[i], ref_bits[i]
                table[j] = _GatherLeaf(
                    a.data_ptr(), a.numel() * a.element_size(), nb_chunk,
                    nbs[i], r.data_ptr() if r is not None else None,
                    slots_chunk, caps[i], _DTYPE_CODES[a.dtype],
                    a.element_size())
                nb_chunk += nbs[i]
                slots_chunk += caps[i]
            KERNEL.launch(table, hi - lo, block_bytes, nb_chunk, slots_chunk,
                          fp.data_ptr() + first * 8,
                          ss.data_ptr() + first * 4,
                          flags.data_ptr() + first,
                          idx.data_ptr() + slot * 4,
                          out.data_ptr() + slot * block_bytes,
                          count.data_ptr() + lo * 4, stream)
            first += nb_chunk
            slot += slots_chunk
    results, first, slot = [], 0, 0
    for i, (a, nb, cap) in enumerate(zip(arrs, nbs, caps)):
        results.append(GatherResult(
            fp=fp[first:first + nb], sumsq=ss[first:first + nb],
            idx=idx[slot:slot + cap],
            blocks=out[slot:slot + cap].view(_elem_dtype(a)),
            count=count[i]))
        first += nb
        slot += cap
    return results


def gather_tree_dirty(arrs: Sequence[torch.Tensor], ref_fps: Sequence[Any],
                      capacities: Sequence[int], *,
                      block_bytes: int = DEFAULT_BLOCK_BYTES,
                      quantize_int8: bool = False) -> List[GatherResult]:
    """Per-unit fused gather, leaves in caller order (the canonical sorted
    path order when called from the saver).  ``ref_fps[i]`` is the leaf's
    reference table (host uint32 or device int32 bits; None for "every
    block dirty").  CUDA tensors: one kernel launch (per 32 leaves); CPU
    tensors: the plain version."""
    if quantize_int8:
        raise NotImplementedError(
            "the int8 composition of block_gather comes with the port's "
            "quantize kernel; it is not ported yet")
    if not (len(arrs) == len(ref_fps) == len(capacities)) or not arrs:
        raise ValueError("gather_tree_dirty needs one ref table and one "
                         "capacity per tensor, and at least one tensor")
    dev = arrs[0].device
    for a in arrs:
        if a.device != dev:
            raise ValueError("a unit's tensors must share one device")
        if a.dtype not in _DTYPE_CODES:
            raise TypeError(f"block_gather does not take dtype {a.dtype}")
        _check_block_bytes(a, block_bytes)
    caps = [round_capacity(c, n_blocks_of(a, block_bytes))
            for a, c in zip(arrs, capacities)]
    if dev.type == "cuda":
        for a in arrs:
            if not a.is_contiguous():
                raise ValueError("block_gather needs contiguous tensors")
        return _gather_cuda(list(arrs), list(ref_fps), caps, block_bytes)
    if dev.type == "cpu":
        return [gather_dirty_plain(a, r, capacity=c, block_bytes=block_bytes)
                for a, r, c in zip(arrs, ref_fps, caps)]
    raise ValueError(f"block_gather does not run on {dev}")


def gather_dirty(x: torch.Tensor, ref_fp, *, capacity: int,
                 block_bytes: int = DEFAULT_BLOCK_BYTES,
                 quantize_int8: bool = False) -> GatherResult:
    """Fused fingerprint + compare-vs-``ref_fp`` + dirty-block compaction of
    one tensor; ``capacity`` is rounded up by :func:`round_capacity`."""
    (res,) = gather_tree_dirty([x], [ref_fp], [capacity],
                               block_bytes=block_bytes,
                               quantize_int8=quantize_int8)
    return res


__all__ = ["GatherResult", "KERNEL", "MAX_LEAVES", "gather_dirty",
           "gather_dirty_plain", "gather_tree_dirty", "round_capacity"]
