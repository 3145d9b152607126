"""Per-layer update-magnitude tracker: the input to the dynamic
``topk_delta`` policy.

Instead of a reference copy of each unit's weights, the tracker keeps each
unit's block fingerprint vector (checksum pair + sum of squares per 64 KiB
block, ~0.02% of the data, from the ``block_fp`` kernel) and scores drift
from the fingerprints alone:

- magnitude: the per-block norm displacement
  sqrt(sum_b (||W_b|| - ||W_ref_b||)^2) / (||W_ref|| + eps), a lower bound
  on the relative drift ||W - W_ref|| / ||W_ref|| (reverse triangle
  inequality per block);
- a tiny dirty-block-fraction term ranks norm-preserving changes (e.g.
  sign flips) that the magnitude bound cannot see.

Unchanged units score exactly 0: their checksums and their float sums of
squares are bit-identical, because ``block_fp`` (and ``block_gather``,
whose snapshot fingerprints the overlapped saver hands back as references)
reduce in a fixed order on the card.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from repro_torch.core.layer_registry import LayerRegistry
from repro_torch.kernels.block_fp import (DEFAULT_BLOCK_BYTES, LeafFP,
                                          fingerprint_tree)

PyTree = Any

# Weight of the dirty-fraction tiebreak: small enough that any measurable
# norm displacement dominates, large enough to rank norm-preserving drift.
_DIRTY_WEIGHT = 1e-7


def _as_tensor(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A device tensor, or a host table (numpy; uint32 pairs as int32
    bits) on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    arr = np.ascontiguousarray(x)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(arr).to(device=device, dtype=dtype)


def _score(cur: List[LeafFP], ref: List[LeafFP]) -> float:
    dev = cur[0].sumsq.device
    ss_cur = torch.cat([_as_tensor(l.sumsq, dev, torch.float32)
                        for l in cur])
    ss_ref = torch.cat([_as_tensor(l.sumsq, dev, torch.float32)
                        for l in ref])
    num = torch.sqrt(torch.sum(torch.square(torch.sqrt(ss_cur)
                                            - torch.sqrt(ss_ref))))
    den = torch.sqrt(torch.sum(ss_ref)) + 1e-12
    dirty = torch.cat(
        [torch.any(_as_tensor(c.fp, dev, torch.int32).reshape(-1, 2)
                   != _as_tensor(r.fp, dev, torch.int32).reshape(-1, 2),
                   dim=1)
         for c, r in zip(cur, ref)])
    return float(num / den
                 + _DIRTY_WEIGHT * torch.mean(dirty.to(torch.float32)))


class DeltaTracker:
    def __init__(self, registry: LayerRegistry, *,
                 block_bytes: int = DEFAULT_BLOCK_BYTES):
        self.registry = registry
        self.block_bytes = block_bytes
        self._refs: Dict[str, List[LeafFP]] = {}

    def _fingerprint(self, params: PyTree, name: str) -> List[LeafFP]:
        sub = self.registry.extract_unit(params, name)
        return fingerprint_tree(sub, block_bytes=self.block_bytes)

    def reset(self, params: PyTree,
              units: Optional[Iterable[str]] = None) -> None:
        """Snapshot reference fingerprints for ``units`` (default: all).
        The vectors are fresh kernel outputs, never views of the params the
        in-place optimizer step overwrites."""
        names = list(units) if units is not None \
            else self.registry.unit_names()
        for n in names:
            self._refs[n] = self._fingerprint(params, n)

    def scores(self, params: PyTree) -> Dict[str, float]:
        return {n: _score(self._fingerprint(params, n), ref)
                for n, ref in self._refs.items()}

    def mark_saved(self, params: PyTree, units: Iterable[str]) -> None:
        """After a save event, the saved units' references advance."""
        self.reset(params, units)

    def set_reference(self, name: str, leaves: List[LeafFP]) -> None:
        """Advance one unit's reference to fingerprints captured at
        SNAPSHOT time (the overlapped saver's): by the time its event
        commits, the live params have drifted past what the checkpoint
        holds, and that drift belongs to the next event's scores."""
        self._refs[name] = list(leaves)
