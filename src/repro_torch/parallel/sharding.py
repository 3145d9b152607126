"""Block math of shard-native checkpoints, the port's copy of the mesh-free
half of the JAX package's ``parallel/sharding.py`` (its lines 240-380).

A *block* is the index rectangle a shard object covers in one leaf's
global array: ``((start, stop), ...)`` per dimension, ``()`` for a
scalar.  ``checkpoint/sharded.py`` keys everything on blocks; here they
come from the mesh-free uniform axis-0 split (``uniform_blocks``), the
ownership of virtual participants.  Plain Python, no device.

The ``NamedSharding`` half (a device mesh's index map per participant:
``device_blocks``, ``partition_leaf_blocks``, the layout rules and
``cache_shardings``) is ROADMAP A4.2.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

Block = Tuple[Tuple[int, int], ...]


def normalize_index(idx: Sequence[slice], shape: Sequence[int]) -> Block:
    """An index of unit-stride slices -> its concrete ``((start, stop),
    ...)`` block; missing trailing slices cover their whole dimension."""
    out = []
    for d, dim in enumerate(shape):
        sl = idx[d] if d < len(idx) else slice(None)
        start, stop, step = sl.indices(int(dim))
        if step != 1:
            raise ValueError(f"non-unit stride in shard index {sl!r}")
        out.append((int(start), int(stop)))
    return tuple(out)


def block_size(block: Block) -> int:
    """Number of elements a block covers (1 for the scalar block ``()``)."""
    n = 1
    for start, stop in block:
        n *= max(0, stop - start)
    return n


def block_slices(block: Block) -> Tuple[slice, ...]:
    return tuple(slice(start, stop) for start, stop in block)


def intersect_blocks(a: Block, b: Block) -> Optional[Block]:
    """The overlap rectangle of two same-rank blocks, or None if disjoint
    (or either block is empty)."""
    if len(a) != len(b):
        raise ValueError(f"rank mismatch: {a!r} vs {b!r}")
    out = []
    for (a0, a1), (b0, b1) in zip(a, b):
        lo, hi = max(a0, b0), min(a1, b1)
        if lo >= hi:
            return None
        out.append((lo, hi))
    blk = tuple(out)
    return blk if block_size(blk) > 0 else None


def blocks_cover_exactly(shape: Sequence[int],
                         blocks: Sequence[Block]) -> bool:
    """True iff ``blocks`` tile the whole array: pairwise disjoint, within
    bounds, and their sizes sum to the element count."""
    total = 1
    for d in shape:
        total *= int(d)
    covered = 0
    for i, blk in enumerate(blocks):
        if len(blk) != len(shape):
            return False
        for (start, stop), dim in zip(blk, shape):
            if start < 0 or stop > int(dim) or start >= stop:
                return False
        covered += block_size(blk)
        for other in blocks[i + 1:]:
            if len(other) == len(blk) and intersect_blocks(blk, other):
                return False
    return covered == total


def partition_devices(devices: Sequence[Any], n: int) -> list:
    """Contiguous even split of a device list into ``n`` participants
    (``np.array_split`` sizing; participants at the tail may be smaller,
    never empty while n <= len(devices))."""
    devices = list(devices)
    if n <= 0:
        raise ValueError("need at least one participant")
    out = []
    base, rem = divmod(len(devices), n)
    pos = 0
    for pid in range(n):
        take = base + (1 if pid < rem else 0)
        out.append(devices[pos:pos + take])
        pos += take
    return out


def uniform_blocks(shape: Sequence[int], pid: int, n: int
                   ) -> Tuple[Block, ...]:
    """Mesh-free owned slices: a contiguous axis-0 split of a leaf into
    ``n`` participant ranges (``np.array_split`` sizing), a scalar owned by
    participant 0, and nothing (``()``) for a participant past a short
    axis 0.  Exact cover by construction."""
    if not (0 <= pid < n):
        raise ValueError(f"participant {pid} outside 0..{n - 1}")
    if not shape:
        return ((),) if pid == 0 else ()
    d0 = int(shape[0])
    base, rem = divmod(d0, n)
    start = pid * base + min(pid, rem)
    stop = start + base + (1 if pid < rem else 0)
    if start >= stop:
        return ()
    return ((((start, stop),) + tuple((0, int(d)) for d in shape[1:])),)
