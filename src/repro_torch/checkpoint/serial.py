"""Tree <-> flat-item plumbing for checkpoint chunks.

A unit's tensors are serialized in canonical order: leaves sorted by their
``/``-joined dict path, exactly as the JAX package orders them, so tables,
payloads and digests line up between the two packages.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

from repro_torch.checkpoint import workers

PyTree = Any

ChunkCorruption = workers.CorruptObject


def flatten_with_paths(tree: PyTree, prefix: str = ""
                       ) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out: List[Tuple[str, Any]] = []
        for k in sorted(tree):
            out.extend(flatten_with_paths(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(flatten_with_paths(v, f"{prefix}{i}/"))
        return out
    return [(prefix.rstrip("/"), tree)]


# A shard object (``checkpoint/sharded.py``) serializes each owned block of
# a leaf as a tensor record of its own, the block's index in the record
# name, so its payload is an ordinary chunk to everything below the
# manifest.  Readers rebuild the names from the manifest's shard spec;
# nothing parses them back.
SHARD_KEY_SEP = "#b"


def shard_leaf_key(path: str, block_index: int) -> str:
    """Record name of block ``block_index`` of leaf ``path`` in a shard
    object's payload."""
    return f"{path}{SHARD_KEY_SEP}{block_index}"


def unflatten_from_paths(items: Dict[str, Any]) -> PyTree:
    root: Dict[str, Any] = {}
    for path, value in items.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return root
