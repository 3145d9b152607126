"""Model API of the port: the surface the trainer, checkpointing and the
LLMTailor core use, independent of the architecture.

A "layer unit" is the granularity of LLMTailor selectivity: one transformer
block, or an auxiliary layer (embed, lm_head, final norm).  Units over the
stacked blocks address a slice along the leading 'layers' dim of the
stacked params, exactly as in the JAX package, so unit names, paths and
checkpoint contents agree between the two.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig

PyTree = Any


@dataclasses.dataclass(frozen=True)
class LayerUnit:
    """One independently checkpointable unit of model+optimizer state."""

    name: str                      # e.g. "block_003", "embed", "lm_head"
    path: Tuple[str, ...]          # path of the subtree in the params tree
    index: Optional[int] = None    # slice along leading 'layers' dim, or None
    kind: str = "block"            # "block" | "aux"


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a tensor that is not allocated."""

    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)


class BaseLM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def param_specs(self) -> PyTree:
        """Tree of float32 ``TensorSpec`` for the master params."""
        raise NotImplementedError

    def init(self, seed: int, device: torch.device) -> PyTree:
        raise NotImplementedError

    def loss(self, params: PyTree, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def layer_units(self) -> List[LayerUnit]:
        raise NotImplementedError


def build_model(cfg: ModelConfig) -> BaseLM:
    if cfg.family == "dense" and cfg.mla is None:
        from repro_torch.models.transformer import DecoderLM
        return DecoderLM(cfg)
    raise NotImplementedError(f"model family {cfg.family!r} is not ported "
                              "to repro_torch yet (dense GQA only)")
