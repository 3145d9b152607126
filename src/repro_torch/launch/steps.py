"""Train state and train step of the port.

State layout (the JAX package's):
    state = {"params": bf16 tree, "opt": {"master","m","v"} float32 trees,
             "step": int32}
``step`` is a host int32 tensor, so the loop never waits on the device to
read it.  The update runs in place: the ``fused_adamw`` kernel (one launch
per layer unit) writes the new master, m, v and bf16 params over the old
ones under ``no_grad``, so the step allocates no second copy of the state.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.checkpoint.serial import flatten_with_paths
from repro_torch.configs.base import TrainConfig
from repro_torch.core.layer_registry import LayerRegistry
from repro_torch.kernels.fused_adamw import fused_adamw
from repro_torch.models.model_api import BaseLM, TensorSpec
from repro_torch.optim import (AdamWConfig, clip_scale, decay_mask, get_at,
                               init_opt_state, tree_leaves, tree_map,
                               warmup_cosine)

PyTree = Any


def state_specs(model: BaseLM) -> Dict[str, PyTree]:
    """Train-state structure as ``TensorSpec`` trees (no allocation)."""
    specs = model.param_specs()
    bf16 = tree_map(lambda s: TensorSpec(s.shape, torch.bfloat16), specs)
    f32 = tree_map(lambda s: TensorSpec(s.shape, torch.float32), specs)
    return {"params": bf16, "opt": {"master": f32, "m": f32, "v": f32}}


def init_state(model: BaseLM, seed: int,
               device: torch.device) -> Dict[str, PyTree]:
    master = model.init(seed, device)
    params = tree_map(lambda p: p.to(torch.bfloat16), master)
    return {"params": params, "opt": init_opt_state(master),
            "step": torch.tensor(0, dtype=torch.int32)}


def make_train_step(model: BaseLM, tcfg: TrainConfig,
                    registry: LayerRegistry = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``; the state is
    updated in place and returned."""
    acfg = AdamWConfig.from_train(tcfg)
    registry = registry or LayerRegistry(model,
                                         weight_decay=tcfg.weight_decay)
    mask = decay_mask(model, registry.group_spec)
    # Per unit: the weight decay of each leaf, in flatten order.
    unit_wds = {
        u.name: [acfg.weight_decay if d else 0.0
                 for _, d in flatten_with_paths(get_at(mask, u.path))]
        for u in registry.units}

    def leaves_of(tree: PyTree, unit: str) -> list:
        return [x for _, x in flatten_with_paths(
            registry.extract_unit(tree, unit))]

    def train_step(state: Dict[str, PyTree], batch: Dict[str, torch.Tensor]):
        params = state["params"]
        for p in tree_leaves(params):
            p.requires_grad_(True)
            p.grad = None
        loss, metrics = model.loss(params, batch)
        loss.backward()
        grads = tree_map(lambda p: p.grad, params)
        gscale, gnorm = clip_scale(grads, tcfg.grad_clip_norm)
        step = int(state["step"])
        lr = warmup_cosine(step, peak_lr=tcfg.learning_rate,
                           warmup_steps=tcfg.warmup_steps,
                           total_steps=tcfg.total_steps)
        opt = state["opt"]
        with torch.no_grad():
            for u in registry.units:
                fused_adamw(leaves_of(grads, u.name),
                            leaves_of(opt["master"], u.name),
                            leaves_of(opt["m"], u.name),
                            leaves_of(opt["v"], u.name),
                            leaves_of(params, u.name), unit_wds[u.name],
                            lr=lr, b1=acfg.b1, b2=acfg.b2, eps=acfg.eps,
                            step=step, gscale=gscale)
        for p in tree_leaves(params):
            p.grad = None
        state["step"] = torch.tensor(step + 1, dtype=torch.int32)
        metrics = dict(metrics, loss=loss.detach(), grad_norm=gnorm, lr=lr)
        return state, metrics

    return train_step

