"""Host oracle for the block fingerprint: the numpy definition the store
uses to verify fingerprints, and the per-leaf fingerprint record.

The fingerprint of a buffer is defined over its raw little-endian bytes,
independent of dtype: the buffer is zero-padded to a whole number of
``block_bytes`` blocks, viewed as uint32 words, and each block yields a
Fletcher-style pair computed in wrap-around uint32 arithmetic:

    fp1[b] = sum(words[b])                 mod 2**32
    fp2[b] = sum((i + 1) * words[b][i])    mod 2**32

Integer arithmetic makes the pair bit-reproducible between the CUDA kernel
and this oracle.  The advisory per-block sum of squares (drift scoring only,
never hashed or compared for equality) is a float reduction and is
therefore excluded from digests and dedup decisions.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np

DEFAULT_BLOCK_BYTES = 65536  # 64 KiB — the dedup/transfer granularity


@dataclasses.dataclass
class LeafFP:
    """Per-leaf fingerprint vector (device tensors or host numpy)."""
    path: str
    shape: Tuple[int, ...]
    dtype: str            # numpy-form dtype name, e.g. "bfloat16"
    nbytes: int           # unpadded byte length of the leaf
    block_bytes: int
    fp: Any               # (n_blocks, 2) uint32 numpy, or int32 bits (torch)
    sumsq: Optional[Any]  # (n_blocks,) float32 — advisory (drift scoring)

    @property
    def n_blocks(self) -> int:
        return int(self.fp.shape[0])

    def meta_matches(self, other: "LeafFP") -> bool:
        return (self.path == other.path
                and tuple(self.shape) == tuple(other.shape)
                and self.dtype == other.dtype
                and self.nbytes == other.nbytes
                and self.block_bytes == other.block_bytes)


def fingerprint_bytes(raw, block_bytes: int = DEFAULT_BLOCK_BYTES
                      ) -> np.ndarray:
    """(n_blocks, 2) uint32 fingerprint pairs of the bytes in ``raw``."""
    assert block_bytes % 4 == 0, block_bytes
    src = np.frombuffer(raw, np.uint8)
    n = src.size
    nb = max(1, -(-n // block_bytes))
    buf = np.zeros(nb * block_bytes, np.uint8)
    buf[:n] = src
    words = buf.view("<u4").reshape(nb, block_bytes // 4)
    weights = np.arange(1, words.shape[1] + 1, dtype=np.uint32)
    fp1 = np.sum(words, axis=1, dtype=np.uint32)
    # element-wise uint32 multiply wraps mod 2**32, matching the device
    fp2 = np.sum(words * weights, axis=1, dtype=np.uint32)
    return np.stack([fp1, fp2], axis=1)


def dirty_block_indices(cur: LeafFP, ref: Optional[LeafFP]) -> np.ndarray:
    """Indices of blocks whose fingerprints differ (all blocks when there is
    no comparable reference)."""
    cfp = np.asarray(cur.fp)
    if ref is None or not cur.meta_matches(ref):
        return np.arange(cfp.shape[0])
    return np.flatnonzero(np.any(cfp != np.asarray(ref.fp), axis=1))
