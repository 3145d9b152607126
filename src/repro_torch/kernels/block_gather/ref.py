"""Numpy oracle of the fused gather kernel: the exact host-side semantics
the CUDA kernel (``csrc/block_gather.cu``) and the plain PyTorch version
(``ops.gather_dirty_plain``) reproduce bit for bit.

- fingerprints are ``block_fp.ref.fingerprint_bytes`` of the zero-padded
  raw little-endian bytes;
- a block is dirty iff its fingerprint pair differs from the reference
  table (all blocks dirty when the tables are not comparable);
- ``idx`` holds the first ``capacity`` dirty indices ascending, -1 fill;
- ``out`` holds those blocks' elements densely, zero fill beyond;
- ``count`` is the TOTAL dirty count, which may exceed ``capacity``
  (the overflow signal the advisory capacity predictor relies on).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.kernels.block_fp.ref import (DEFAULT_BLOCK_BYTES,
                                              fingerprint_bytes)


def gather_dirty_oracle(arr: np.ndarray, ref_fp: Optional[np.ndarray], *,
                        capacity: int,
                        block_bytes: int = DEFAULT_BLOCK_BYTES
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """-> (fp (nb, 2) u32, idx (capacity,) i32, out (capacity, epb)
    arr.dtype, count int)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.bool_:
        arr = arr.astype(np.uint8)
    itemsize = arr.dtype.itemsize
    assert block_bytes % itemsize == 0, (block_bytes, itemsize)
    epb = block_bytes // itemsize
    raw = arr.tobytes()
    fp = fingerprint_bytes(raw, block_bytes)
    nb = fp.shape[0]
    if ref_fp is None or np.asarray(ref_fp).shape != fp.shape:
        dirty = np.arange(nb)
    else:
        dirty = np.flatnonzero(
            np.any(fp != np.asarray(ref_fp, np.uint32), axis=1))
    count = int(dirty.size)

    buf = np.zeros(nb * epb, arr.dtype)
    buf[:arr.size] = arr.reshape(-1)
    blocks = buf.reshape(nb, epb)
    k = min(count, capacity)
    idx = np.full(capacity, -1, np.int32)
    idx[:k] = dirty[:k]
    out = np.zeros((capacity, epb), arr.dtype)
    out[:k] = blocks[dirty[:k]]
    return fp, idx, out, count
