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
from repro_torch.models.modules import (COMPUTE_DTYPE, cross_entropy_loss,
                                        embed_lookup, rms_norm,
                                        truncated_normal, unembed_logits)

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
    """``compute_dtype`` is the dtype of the activations, of the weights as
    the layers read them and of the cache (bf16 by default, as in the JAX
    package; float32 takes rounding out of a comparison)."""

    def __init__(self, cfg: ModelConfig,
                 compute_dtype: torch.dtype = COMPUTE_DTYPE):
        self.cfg = cfg
        self.compute_dtype = compute_dtype

    def param_specs(self) -> PyTree:
        """Tree of float32 ``TensorSpec`` for the master params."""
        raise NotImplementedError

    def init(self, seed: int, device: torch.device,
             dtype: torch.dtype = torch.float32) -> PyTree:
        raise NotImplementedError

    def loss(self, params: PyTree, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def prefill(self, params: PyTree, batch: Dict[str, torch.Tensor],
                cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, PyTree]:
        """(last-position logits (B, V), cache of ``cache_len`` positions)."""
        raise NotImplementedError

    def decode_step(self, params: PyTree, cache: PyTree,
                    batch: Dict[str, Any]) -> Tuple[torch.Tensor, PyTree]:
        """One token per sequence at ``batch["pos"]``; updates ``cache`` in
        place and returns (logits (B, V), cache)."""
        raise NotImplementedError

    def cache_spec(self, batch: int, seq: int) -> PyTree:
        """Tree of ``TensorSpec`` of the decode cache."""
        raise NotImplementedError

    def init_cache(self, batch: int, seq: int,
                   device: torch.device) -> PyTree:
        raise NotImplementedError

    def layer_units(self) -> List[LayerUnit]:
        raise NotImplementedError


# leaf init rule: ("dense", fan-in scale or None) | ("ones", None) |
# ("zeros", None) | ("value", fn(shape) -> float32 tensor)
Rule = Tuple[str, Any]


class StackedLM(BaseLM):
    """The JAX package's decoder layout: ``embed/w`` (V, D), the blocks'
    leaves stacked with the layer dim leading under ``blocks``,
    ``final_norm/scale`` and, untied, ``lm_head/w`` (D, V).  Subclasses
    name each block leaf's shape and init rule (``_block_leaves``) and run
    the blocks (``hidden``)."""

    def _block_leaves(self) -> Dict[str, Tuple[Tuple[int, ...], Rule]]:
        raise NotImplementedError

    def _aux_leaves(self) -> Dict[str, Tuple[Tuple[int, ...], Rule]]:
        cfg = self.cfg
        out = {"embed/w": ((cfg.vocab_size, cfg.d_model), ("dense", 0.02)),
               "final_norm/scale": ((cfg.d_model,), ("ones", None))}
        if not cfg.tie_embeddings:
            out["lm_head/w"] = ((cfg.d_model, cfg.vocab_size),
                                ("dense", 0.02))
        return out

    def param_specs(self) -> PyTree:
        tree: Dict[str, Any] = {}
        n = self.cfg.num_layers
        for path, (shape, _) in self._aux_leaves().items():
            set_path(tree, path, TensorSpec(shape, torch.float32))
        for path, (shape, _) in self._block_leaves().items():
            set_path(tree, "blocks/" + path,
                     TensorSpec((n,) + shape, torch.float32))
        return tree

    def init(self, seed: int, device: torch.device,
             dtype: torch.dtype = torch.float32) -> PyTree:
        """Params: truncated normal with 1/sqrt(fan_in) scale (0.02 for
        embeddings) from a generator per leaf (and per layer), ones, zeros
        or a fixed value by the leaf's rule, drawn in float32 and stored in
        ``dtype`` one layer at a time (bf16 serving weights never hold a
        float32 copy of the model)."""
        tree: Dict[str, Any] = {}

        def make(path: str, shape, rule: Rule) -> torch.Tensor:
            kind, arg = rule
            if kind == "ones":
                return torch.ones(shape, dtype=torch.float32, device=device)
            if kind == "zeros":
                return torch.zeros(shape, dtype=torch.float32, device=device)
            if kind == "value":
                return arg(shape).to(device)
            scale = arg
            if scale is None:
                scale = 1.0 / max(int(shape[0]), 1) ** 0.5
            return truncated_normal(shape, scale, seed, path, device)

        for path, (shape, rule) in self._aux_leaves().items():
            set_path(tree, path, make(path, shape, rule).to(dtype))
        n = self.cfg.num_layers
        for path, (shape, rule) in self._block_leaves().items():
            stacked = torch.empty((n,) + shape, dtype=dtype, device=device)
            for i in range(n):
                stacked[i] = make(f"block{i}/{path}", shape, rule)
            set_path(tree, "blocks/" + path, stacked)
        return tree

    def hidden(self, params: PyTree, tokens: torch.Tensor) -> torch.Tensor:
        """Final hidden states (B, S, D) of the training forward."""
        raise NotImplementedError

    def _layer_cache_spec(self, batch: int,
                          seq: int) -> Dict[str, TensorSpec]:
        """One layer's decode cache."""
        raise NotImplementedError

    def cache_spec(self, batch: int, seq: int) -> PyTree:
        """The layers' caches stacked with the layer dim leading."""
        return {"blocks": {k: TensorSpec((self.cfg.num_layers,) + s.shape,
                                         s.dtype)
                           for k, s in self._layer_cache_spec(
                               batch, seq).items()}}

    def _embed(self, params: PyTree, tokens: torch.Tensor) -> torch.Tensor:
        return embed_lookup(params["embed"]["w"], tokens, self.compute_dtype)

    def _logits(self, params: PyTree, h: torch.Tensor) -> torch.Tensor:
        h = rms_norm(h, params["final_norm"]["scale"], self.cfg.norm_eps)
        w = (params["embed"]["w"].t() if self.cfg.tie_embeddings
             else params["lm_head"]["w"])
        return unembed_logits(h, w, self.compute_dtype)

    def logits(self, params: PyTree, tokens: torch.Tensor) -> torch.Tensor:
        return self._logits(params, self.hidden(params, tokens))

    def loss(self, params, batch):
        tokens = batch["tokens"]
        logits = self.logits(params, tokens)
        ce = cross_entropy_loss(logits[:, :-1], tokens[:, 1:])
        aux = torch.zeros((), dtype=torch.float32, device=ce.device)
        return ce + aux, {"ce": ce, "aux_loss": aux}

    def init_cache(self, batch: int, seq: int,
                   device: torch.device) -> PyTree:
        """A zero cache of ``cache_spec(batch, seq)`` on ``device``."""
        return {"blocks": {k: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device)
                           for k, s in self.cache_spec(
                               batch, seq)["blocks"].items()}}

    def layer_units(self) -> List[LayerUnit]:
        units = [LayerUnit("embed", ("embed",), kind="aux")]
        for i in range(self.cfg.num_layers):
            units.append(LayerUnit(f"block_{i:03d}", ("blocks",), index=i))
        units.append(LayerUnit("final_norm", ("final_norm",), kind="aux"))
        if not self.cfg.tie_embeddings:
            units.append(LayerUnit("lm_head", ("lm_head",), kind="aux"))
        return units


def set_path(tree: Dict, path: str, value) -> None:
    parts = path.split("/")
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = value


def unbind_layers(tree) -> List[PyTree]:
    """Every layer of a tree of stacked leaves (views, one ``unbind`` per
    leaf).  In training the backward of ``unbind`` stacks the layers'
    gradients once per leaf, where indexing each layer would add a
    full-size zero gradient per layer and leaf."""
    if isinstance(tree, dict):
        per_key = {k: unbind_layers(v) for k, v in tree.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(tree.unbind(0))


def build_model(cfg: ModelConfig,
                compute_dtype: torch.dtype = COMPUTE_DTYPE) -> BaseLM:
    if cfg.family == "dense" and cfg.mla is None:
        from repro_torch.models.transformer import DecoderLM
        return DecoderLM(cfg, compute_dtype)
    if cfg.family == "ssm":
        from repro_torch.models.mamba_lm import MambaLM
        return MambaLM(cfg, compute_dtype)
    if cfg.family == "hybrid":
        raise NotImplementedError(
            f"model family 'hybrid' ({cfg.name}) is not ported to "
            "repro_torch yet (ROADMAP A5)")
    raise NotImplementedError(f"model family {cfg.family!r} is not ported "
                              "to repro_torch yet (dense GQA and ssm only)")
