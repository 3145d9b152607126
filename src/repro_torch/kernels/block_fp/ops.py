"""Block fingerprints of a unit's tensors: the CUDA kernel, its plain
PyTorch version, and the save path's wrappers around them.

A CUDA tensor goes to the kernel (``csrc/block_fp.cu``, one launch per
unit over all its leaves); a CPU tensor takes the plain version.  Both give
the same uint32 pairs bit for bit (held on the device as int32 bits: torch's
uint32 has thin CUDA coverage) and a float32 sum of squares per block.
There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.dtypes import byte_view, dtype_name
from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels.block_fp.ref import DEFAULT_BLOCK_BYTES, LeafFP

MAX_LEAVES = 64  # FP_MAX_LEAVES in csrc/block_fp.cu

_DTYPE_CODES = {
    torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.int32: 3,
    torch.uint8: 4, torch.bool: 4, torch.int8: 5, torch.int64: 6,
    torch.float64: 7, torch.int16: 8,
}


class _FpLeaf(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p), ("nbytes", ctypes.c_longlong),
                ("first_block", ctypes.c_longlong), ("dtype", ctypes.c_int),
                ("itemsize", ctypes.c_int)]


KERNEL = CudaKernel("block_fp", "block_fp_launch", [
    ctypes.POINTER(_FpLeaf), ctypes.c_int, ctypes.c_longlong,
    ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])

_MASK = 0xFFFFFFFF


def n_blocks_of(x: torch.Tensor, block_bytes: int) -> int:
    return max(1, -(-x.numel() * x.element_size() // block_bytes))


def _check_block_bytes(x: torch.Tensor, block_bytes: int) -> None:
    if block_bytes % 4 or block_bytes % x.element_size():
        raise ValueError(f"block_bytes {block_bytes} must be a multiple of 4 "
                         f"and of the itemsize of {x.dtype}")


# ------------------------------------------------------------ plain version
def fingerprint_plain(x: torch.Tensor, block_bytes: int = DEFAULT_BLOCK_BYTES
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function for one tensor in plain PyTorch:
    (fp (nb, 2) int32 bits of the uint32 pairs, sumsq (nb,) float32)."""
    _check_block_bytes(x, block_bytes)
    x = x.detach().contiguous()
    raw = byte_view(x)
    n = raw.numel()
    nb = n_blocks_of(x, block_bytes)
    buf = torch.zeros(nb * block_bytes, dtype=torch.uint8, device=x.device)
    buf[:n] = raw
    words = buf.view(torch.int32).reshape(nb, block_bytes // 4)
    words = words.to(torch.int64) & _MASK
    weights = torch.arange(1, block_bytes // 4 + 1, dtype=torch.int64,
                           device=x.device)
    fp1 = words.sum(1) & _MASK
    fp2 = ((words * weights) & _MASK).sum(1) & _MASK
    fp = torch.stack([fp1, fp2], 1)
    fp = torch.where(fp >= 2**31, fp - 2**32, fp).to(torch.int32)
    vals = (x.view(torch.uint8) if x.dtype == torch.bool else x).reshape(-1)
    epb = block_bytes // x.element_size()
    padded = torch.zeros(nb * epb, dtype=torch.float32, device=x.device)
    padded[:vals.numel()] = vals.to(torch.float32)
    padded = padded.reshape(nb, epb)
    return fp, (padded * padded).sum(1)


# ------------------------------------------------------------ kernel launch
def _fingerprint_cuda(arrs: Sequence[torch.Tensor], block_bytes: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = arrs[0].device
    nbs = [n_blocks_of(a, block_bytes) for a in arrs]
    total = sum(nbs)
    fp = torch.empty((total, 2), dtype=torch.int32, device=dev)
    ss = torch.empty((total,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        first = 0
        for lo in range(0, len(arrs), MAX_LEAVES):
            chunk = arrs[lo:lo + MAX_LEAVES]
            table = (_FpLeaf * len(chunk))()
            nb_chunk = 0
            for i, a in enumerate(chunk):
                table[i] = _FpLeaf(a.data_ptr(), a.numel() * a.element_size(),
                                   nb_chunk, _DTYPE_CODES[a.dtype],
                                   a.element_size())
                nb_chunk += nbs[lo + i]
            KERNEL.launch(table, len(chunk), block_bytes, nb_chunk,
                          fp.data_ptr() + first * 8, ss.data_ptr() + first * 4,
                          stream)
            first += nb_chunk
    return fp, ss


def fingerprint_unit(arrs: Sequence[torch.Tensor],
                     block_bytes: int = DEFAULT_BLOCK_BYTES
                     ) -> Tuple[torch.Tensor, torch.Tensor, List[int]]:
    """Fingerprints of all ``arrs`` in one pass: (fp (NB, 2) int32,
    sumsq (NB,) float32, blocks per leaf).  CUDA tensors: one kernel launch
    (per 64 leaves); CPU tensors: the plain version."""
    if not arrs:
        raise ValueError("fingerprint_unit needs at least one tensor")
    dev = arrs[0].device
    for a in arrs:
        if a.device != dev:
            raise ValueError("a unit's tensors must share one device")
        if a.dtype not in _DTYPE_CODES:
            raise TypeError(f"block_fp does not take dtype {a.dtype}")
        _check_block_bytes(a, block_bytes)
    nbs = [n_blocks_of(a, block_bytes) for a in arrs]
    if dev.type == "cuda":
        for a in arrs:
            if not a.is_contiguous():
                raise ValueError("block_fp needs contiguous tensors")
        fp, ss = _fingerprint_cuda(arrs, block_bytes)
    elif dev.type == "cpu":
        outs = [fingerprint_plain(a, block_bytes) for a in arrs]
        fp = torch.cat([o[0] for o in outs])
        ss = torch.cat([o[1] for o in outs])
    else:
        raise ValueError(f"block_fp does not run on {dev}")
    return fp, ss, nbs


# ---------------------------------------------------------- save-path wraps
def fingerprint_tree(tree, *, block_bytes: int = DEFAULT_BLOCK_BYTES
                     ) -> List[LeafFP]:
    """Fingerprint vectors for every leaf, in canonical (sorted path) order
    — the order ``serial.flatten_with_paths`` serializes — from one launch
    over the whole tree."""
    from repro_torch.checkpoint.serial import flatten_with_paths

    flat = flatten_with_paths(tree)
    arrs = [a for _, a in flat]
    fp, ss, nbs = fingerprint_unit(arrs, block_bytes)
    out, lo = [], 0
    for (path, a), nb in zip(flat, nbs):
        out.append(LeafFP(path=path, shape=tuple(a.shape),
                          dtype=dtype_name(a.dtype),
                          nbytes=a.numel() * a.element_size(),
                          block_bytes=block_bytes, fp=fp[lo:lo + nb],
                          sumsq=ss[lo:lo + nb]))
        lo += nb
    return out


def block_fingerprint(x: torch.Tensor, *,
                      block_bytes: int = DEFAULT_BLOCK_BYTES
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block (fp (nb, 2) int32 bits, sumsq (nb,)) of one tensor."""
    fp, ss, _ = fingerprint_unit([x], block_bytes)
    return fp, ss


def _fp_bits(fp, device: torch.device) -> torch.Tensor:
    if isinstance(fp, torch.Tensor):
        return fp.to(device)
    arr = np.ascontiguousarray(np.asarray(fp, dtype=np.uint32)).view(np.int32)
    return torch.from_numpy(arr).to(device)


def leaves_match(cur: Sequence[LeafFP], ref: Sequence[LeafFP]) -> bool:
    """True iff every leaf's checksum vector is identical: one compare on
    the device and one host sync for the unit.  ``ref`` may hold device
    vectors or host (numpy uint32) tables reloaded from an envelope."""
    if len(cur) != len(ref):
        return False
    if not all(c.meta_matches(r) for c, r in zip(cur, ref)):
        return False
    if not cur:
        return True
    if not isinstance(cur[0].fp, torch.Tensor):
        # host tables on both sides of the compare
        def flat(fp):
            if isinstance(fp, torch.Tensor):
                return fp.cpu().numpy().view(np.uint32).reshape(-1)
            return np.asarray(fp, np.uint32).reshape(-1)
        return bool(np.array_equal(np.concatenate([flat(c.fp) for c in cur]),
                                   np.concatenate([flat(r.fp) for r in ref])))
    dev = cur[0].fp.device
    a = torch.cat([c.fp.reshape(-1) for c in cur])
    host = [r.fp for r in ref if not isinstance(r.fp, torch.Tensor)]
    if len(host) == len(ref):
        flat = np.concatenate([np.asarray(f, np.uint32).reshape(-1)
                               for f in host])
        b = _fp_bits(flat, dev)
    else:
        b = torch.cat([_fp_bits(r.fp, dev).reshape(-1) for r in ref])
    return bool(torch.equal(a, b))


def gather_blocks(x: torch.Tensor, idx: np.ndarray, *,
                  block_bytes: int = DEFAULT_BLOCK_BYTES) -> torch.Tensor:
    """The listed blocks of ``x``'s bytes, gathered on its device:
    (len(idx), block_bytes) uint8, the tail block zero-padded as
    fingerprinted.  Plain indexing; it is not a kernel in either package."""
    raw = byte_view(x.contiguous())
    n = raw.numel()
    nb = max(1, -(-n // block_bytes))
    idx_t = torch.as_tensor(np.asarray(idx, np.int64), device=x.device)
    if n == nb * block_bytes:
        return raw.view(nb, block_bytes).index_select(0, idx_t)
    full = (nb - 1) * block_bytes
    tail = torch.zeros((1, block_bytes), dtype=torch.uint8, device=x.device)
    tail[0, :n - full] = raw[full:]
    blocks = torch.cat([raw[:full].view(nb - 1, block_bytes), tail])
    return blocks.index_select(0, idx_t)


def tree_to_host(leaves: Sequence[LeafFP]) -> List[LeafFP]:
    """Host (numpy) copies of device fingerprint vectors, in one transfer."""
    if not leaves:
        return []
    fp = torch.cat([l.fp.reshape(-1) for l in leaves]).cpu().numpy()
    fp = fp.view(np.uint32)
    has_ss = all(l.sumsq is not None for l in leaves)
    ss = (torch.cat([l.sumsq for l in leaves]).cpu().numpy()
          if has_ss else None)
    out, lo = [], 0
    for l in leaves:
        nb = l.n_blocks
        out.append(LeafFP(path=l.path, shape=l.shape, dtype=l.dtype,
                          nbytes=l.nbytes, block_bytes=l.block_bytes,
                          fp=fp[2 * lo:2 * (lo + nb)].reshape(nb, 2).copy(),
                          sumsq=(ss[lo:lo + nb].copy() if has_ss else None)))
        lo += nb
    return out
