"""Selective checkpoint policies (the paper's strategies and the dynamic
``topk_delta`` one).

A policy is consulted at every checkpoint event (every ``ckpt_interval``
training steps) and returns the layer-unit names to persist.  Aux units
follow the paper's conventions (embed with one parity class, lm_head with
the other; tiny norms always saved).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.models.model_api import LayerUnit

_TINY_AUX = ("final_norm", "enc_norm", "dec_norm")


@dataclasses.dataclass
class PolicyContext:
    """Inputs a policy may use."""
    event_index: int                      # 0, 1, 2, ... checkpoint events
    step: int                             # training step
    drift_scores: Optional[Dict[str, float]] = None  # unit -> ||dW||/||W||


class CheckpointPolicy:
    name = "base"

    def __init__(self, units: Sequence[LayerUnit]):
        self.units = list(units)
        self.blocks = [u.name for u in self.units if u.kind == "block"]
        self.aux = [u.name for u in self.units if u.kind != "block"]

    def select(self, ctx: PolicyContext) -> List[str]:
        raise NotImplementedError

    def all_units(self) -> List[str]:
        return [u.name for u in self.units]


class FullPolicy(CheckpointPolicy):
    """Baseline: save everything every event."""
    name = "full"

    def select(self, ctx: PolicyContext) -> List[str]:
        return self.all_units()


class ParityPolicy(CheckpointPolicy):
    """Alternate halves: even events save even blocks + lm_head (+tiny aux);
    odd events save odd blocks + embed (+tiny aux).  Any two consecutive
    events cover the full model."""
    name = "parity"

    def select(self, ctx: PolicyContext) -> List[str]:
        even = ctx.event_index % 2 == 0
        blocks = [b for i, b in enumerate(self.blocks) if (i % 2 == 0) == even]
        aux = [a for a in self.aux
               if a in _TINY_AUX
               or (even and a != "embed")
               or (not even and a == "embed")]
        return blocks + aux


class FilteredPolicy(CheckpointPolicy):
    """The first ``first_k`` and last ``last_k`` blocks every event; the
    remaining blocks alternate halves every ``rest_every``-th event.  Aux
    units ride with the frequent set."""
    name = "filtered"

    def __init__(self, units, *, first_k: int = 2, last_k: int = 2,
                 rest_every: int = 5):
        super().__init__(units)
        self.first_k = first_k
        self.last_k = last_k
        self.rest_every = rest_every

    def select(self, ctx: PolicyContext) -> List[str]:
        important = (self.blocks[:self.first_k]
                     + (self.blocks[-self.last_k:] if self.last_k else []))
        out = list(dict.fromkeys(important)) + list(self.aux)
        if ctx.event_index % self.rest_every == 0:
            rest = [b for b in self.blocks if b not in important]
            half = (ctx.event_index // self.rest_every) % 2
            out += [b for i, b in enumerate(rest) if i % 2 == half]
        return out


class IntervalPolicy(CheckpointPolicy):
    """Stripe blocks over ``stride`` events; aux units every event."""
    name = "interval"

    def __init__(self, units, *, stride: int = 4):
        super().__init__(units)
        self.stride = max(1, stride)

    def select(self, ctx: PolicyContext) -> List[str]:
        r = ctx.event_index % self.stride
        return ([b for i, b in enumerate(self.blocks)
                 if i % self.stride == r] + list(self.aux))


class TopKDeltaPolicy(CheckpointPolicy):
    """Dynamic policy: save the ``frac`` most-drifted blocks since their
    last save, by the ``DeltaTracker`` scores (``core/delta.py``); aux units
    every event.  Falls back to parity when no scores are available (the
    first event, or after a resume)."""
    name = "topk_delta"

    def __init__(self, units, *, frac: float = 0.5):
        super().__init__(units)
        self.frac = frac
        self._fallback = ParityPolicy(units)
        self._block_order = {b: i for i, b in enumerate(self.blocks)}

    def select(self, ctx: PolicyContext) -> List[str]:
        if not ctx.drift_scores:
            return self._fallback.select(ctx)
        k = max(1, int(len(self.blocks) * self.frac))
        # Ties break on registry block order, pinned in the sort key: the
        # selection must not depend on the order drift_scores was built in.
        ranked = sorted(self.blocks,
                        key=lambda b: (-ctx.drift_scores.get(b, 0.0),
                                       self._block_order[b]))
        return ranked[:k] + list(self.aux)


def make_policy(name: str, units: Sequence[LayerUnit],
                **kw) -> CheckpointPolicy:
    table = {p.name: p for p in (FullPolicy, ParityPolicy, FilteredPolicy,
                                 IntervalPolicy, TopKDeltaPolicy)}
    if name not in table:
        raise KeyError(f"unknown policy {name!r}; known: {sorted(table)}")
    return table[name](units, **kw)
