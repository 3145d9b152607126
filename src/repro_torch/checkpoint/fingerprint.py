"""Fingerprint tables and save packets for the block-sparse checkpoint path.

- The canonical **fingerprint table** blob (msgpack of per-leaf metadata +
  checksum bytes, sorted leaf order) and its blake2b **fp digest**, the
  content address of fingerprint-pipeline objects.  Two units hash to the
  same digest iff their tables match, so an unchanged re-save dedups with
  no payload transfer and no payload hashing.
- **FingerprintPacket**: what the saver hands the chunk store — per-leaf
  dirty block indices and gathered block bytes (delta path) or the full raw
  bytes, or under codec int8 a leaf's quantized record (full path), plus
  the table blob, which always describes the raw leaves.

The digest hashes only integer checksums and leaf metadata, never float
reductions, so device-side and host-side derivations agree bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.checkpoint import _msgpack
from repro_torch.checkpoint.workers import blake2_hex
from repro_torch.kernels.block_fp.ref import DEFAULT_BLOCK_BYTES, LeafFP

TABLE_VERSION = 1

__all__ = ["DEFAULT_BLOCK_BYTES", "FingerprintPacket", "LeafPayload",
           "fp_digest", "meta_table", "pack_table", "unpack_table"]


def pack_table(leaves: Sequence[LeafFP]) -> bytes:
    """Canonical fingerprint-table blob (fixed field order, checksums as
    little-endian uint32 bytes; sorted leaf order is the caller's
    contract)."""
    rows = []
    for l in leaves:
        fp = np.ascontiguousarray(np.asarray(l.fp, dtype="<u4"))
        rows.append([l.path, [int(d) for d in l.shape], l.dtype,
                     int(l.nbytes), int(l.block_bytes), fp.tobytes()])
    return _msgpack.packb({"v": TABLE_VERSION, "leaves": rows})


def unpack_table(blob) -> List[LeafFP]:
    d = _msgpack.unpackb(blob)
    if not isinstance(d, dict) or d.get("v") != TABLE_VERSION:
        raise ValueError("bad fingerprint table blob")
    out = []
    for path, shape, dtype, nbytes, block_bytes, fp_bytes in d["leaves"]:
        fp = np.frombuffer(fp_bytes, "<u4").reshape(-1, 2).astype(np.uint32)
        out.append(LeafFP(path=path, shape=tuple(shape), dtype=dtype,
                          nbytes=nbytes, block_bytes=block_bytes, fp=fp,
                          sumsq=None))
    return out


def fp_digest(table_blob) -> str:
    return blake2_hex(table_blob)


def meta_table(tree, block_bytes: int = DEFAULT_BLOCK_BYTES
               ) -> List[LeafFP]:
    """Structure-only table of a tree of tensors (paths, shapes, dtypes,
    byte lengths) with zeroed checksums and no device work: enough for
    ``meta_matches``, so the overlapped saver can plan a delta base before
    any fingerprint reaches the host.  Never pack or hash one."""
    from repro_torch.checkpoint.serial import flatten_with_paths
    from repro_torch.dtypes import dtype_name

    out = []
    for path, arr in flatten_with_paths(tree):
        nbytes = arr.numel() * arr.element_size()
        nb = max(1, -(-nbytes // block_bytes))
        out.append(LeafFP(path=path, shape=tuple(arr.shape),
                          dtype=dtype_name(arr.dtype), nbytes=nbytes,
                          block_bytes=block_bytes,
                          fp=np.zeros((nb, 2), np.uint32), sumsq=None))
    return out


@dataclasses.dataclass
class LeafPayload:
    """One leaf's share of a write: the full raw bytes (``idx is None``) or
    the gathered dirty blocks (whole blocks, ``idx`` listing them).
    ``data`` is a buffer (often a view into a pinned staging buffer).
    ``quant = (n_q, n_scale)`` says that ``data`` is the leaf's int8
    record instead (q, then scales; full writes only)."""
    path: str
    shape: tuple
    dtype: str
    nbytes: int
    block_bytes: int
    idx: Optional[np.ndarray]
    data: Any
    quant: Optional[Tuple[int, int]] = None


@dataclasses.dataclass
class FingerprintPacket:
    """Everything the chunk store needs to persist one unit."""
    digest: str               # fp digest (content address)
    table: bytes              # packed fingerprint table
    leaves: List[LeafPayload]
    full: bool                # True -> every leaf carries its full bytes
    base_digest: Optional[str] = None  # required when not full
    logical_bytes: int = 0    # sum of unpadded leaf bytes (accounting)
