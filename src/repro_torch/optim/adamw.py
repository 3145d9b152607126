"""AdamW with float32 master weights and per-leaf weight decay.

State layout (the paper's checkpoint anatomy): bf16 params (2 B/param) and
float32 master, m and v (12 B/param).  The update itself is the
``fused_adamw`` kernel (``repro_torch.kernels.fused_adamw``); this module
holds its configuration and the global-norm clip factor it folds in.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.optim.groups import tree_leaves, tree_map

PyTree = Any


class AdamWConfig(NamedTuple):
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    @staticmethod
    def from_train(tc: TrainConfig) -> "AdamWConfig":
        return AdamWConfig(b1=tc.adam_b1, b2=tc.adam_b2, eps=tc.adam_eps,
                           weight_decay=tc.weight_decay)


def init_opt_state(master: PyTree) -> Dict[str, PyTree]:
    """master = the float32 params (shared, not copied); m, v zeros."""
    return {"master": tree_map(lambda p: p.to(torch.float32), master),
            "m": tree_map(torch.zeros_like, master),
            "v": tree_map(torch.zeros_like, master)}


def global_norm(tree: PyTree) -> torch.Tensor:
    sq = [x.to(torch.float32).square().sum() for x in tree_leaves(tree)]
    return torch.stack(sq).sum().sqrt()


def clip_scale(grads: PyTree, max_norm: float):
    """(scale, norm): ``g * scale`` clips the grads to ``max_norm`` global
    norm.  Both stay on the device."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return scale.reshape(1), norm
