"""Dense decoder-only LM (llama-style GQA + SwiGLU) of the port.

The param tree is the JAX package's: ``embed/w`` (V, D), stacked ``blocks``
with the layer dim leading, ``final_norm/scale`` and, untied, ``lm_head/w``
(D, V).  Layers run in a Python loop over slices of the stacked leaves,
each under ``torch.utils.checkpoint`` when ``remat != "none"`` (the JAX
package's per-layer ``jax.checkpoint``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import gqa_forward
from repro_torch.models.model_api import BaseLM, LayerUnit, TensorSpec
from repro_torch.models.modules import (
    cross_entropy_loss,
    embed_lookup,
    rms_norm,
    swiglu,
    truncated_normal,
    unembed_logits,
)

PyTree = Any

# leaf rule: ("dense", fan_in scale or None) | ("ones",)
_Rule = Tuple[str, Any]


class DecoderLM(BaseLM):
    # ------------------------------------------------------------ structure
    def _block_leaves(self) -> Dict[str, Tuple[Tuple[int, ...], _Rule]]:
        cfg = self.cfg
        d, f = cfg.d_model, cfg.d_ff
        h, g, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        dense = ("dense", None)
        return {
            "ln1": ((d,), ("ones", None)),
            "ln2": ((d,), ("ones", None)),
            "attn/wq": ((d, h, dh), dense),
            "attn/wk": ((d, g, dh), dense),
            "attn/wv": ((d, g, dh), dense),
            "attn/wo": ((h, dh, d), dense),
            "mlp/w_gate": ((d, f), dense),
            "mlp/w_up": ((d, f), dense),
            "mlp/w_down": ((f, d), dense),
        }

    def _aux_leaves(self) -> Dict[str, Tuple[Tuple[int, ...], _Rule]]:
        cfg = self.cfg
        out = {"embed/w": ((cfg.vocab_size, cfg.d_model), ("dense", 0.02)),
               "final_norm/scale": ((cfg.d_model,), ("ones", None))}
        if not cfg.tie_embeddings:
            out["lm_head/w"] = ((cfg.d_model, cfg.vocab_size),
                                ("dense", 0.02))
        return out

    @staticmethod
    def _set(tree: Dict, path: str, value) -> None:
        parts = path.split("/")
        for p in parts[:-1]:
            tree = tree.setdefault(p, {})
        tree[parts[-1]] = value

    def param_specs(self) -> PyTree:
        tree: Dict[str, Any] = {}
        n = self.cfg.num_layers
        for path, (shape, _) in self._aux_leaves().items():
            self._set(tree, path, TensorSpec(shape, torch.float32))
        for path, (shape, _) in self._block_leaves().items():
            self._set(tree, "blocks/" + path,
                      TensorSpec((n,) + shape, torch.float32))
        return tree

    def init(self, seed: int, device: torch.device) -> PyTree:
        """float32 master params: truncated normal with 1/sqrt(fan_in)
        scale (0.02 for embeddings) from a generator per leaf (and per
        layer), ones for norms."""
        tree: Dict[str, Any] = {}

        def make(path: str, shape, rule: _Rule) -> torch.Tensor:
            kind, scale = rule
            if kind == "ones":
                return torch.ones(shape, dtype=torch.float32, device=device)
            if scale is None:
                scale = 1.0 / max(int(shape[0]), 1) ** 0.5
            return truncated_normal(shape, scale, seed, path, device)

        for path, (shape, rule) in self._aux_leaves().items():
            self._set(tree, path, make(path, shape, rule))
        n = self.cfg.num_layers
        for path, (shape, rule) in self._block_leaves().items():
            stacked = torch.empty((n,) + shape, dtype=torch.float32,
                                  device=device)
            for i in range(n):
                stacked[i] = make(f"block{i}/{path}", shape, rule)
            self._set(tree, "blocks/" + path, stacked)
        return tree

    # --------------------------------------------------------------- forward
    def _block(self, p: Dict, h: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = h + gqa_forward(p["attn"], rms_norm(h, p["ln1"], cfg.norm_eps),
                            cfg, positions=positions)
        m_in = rms_norm(h, p["ln2"], cfg.norm_eps)
        return h + swiglu(m_in, p["mlp"]["w_gate"], p["mlp"]["w_up"],
                          p["mlp"]["w_down"])

    def hidden(self, params: PyTree, tokens: torch.Tensor) -> torch.Tensor:
        h = embed_lookup(params["embed"]["w"], tokens)
        positions = torch.arange(h.shape[1], device=h.device)
        blocks = params["blocks"]
        for i in range(self.cfg.num_layers):
            layer_p = _index_tree(blocks, i)
            if self.cfg.remat != "none":
                h = checkpoint(self._block, layer_p, h, positions,
                               use_reentrant=False)
            else:
                h = self._block(layer_p, h, positions)
        return h

    def logits(self, params: PyTree, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = self.hidden(params, tokens)
        h = rms_norm(h, params["final_norm"]["scale"], cfg.norm_eps)
        w = (params["embed"]["w"].t() if cfg.tie_embeddings
             else params["lm_head"]["w"])
        return unembed_logits(h, w)

    def loss(self, params, batch):
        tokens = batch["tokens"]
        logits = self.logits(params, tokens)
        ce = cross_entropy_loss(logits[:, :-1], tokens[:, 1:])
        aux = torch.zeros((), dtype=torch.float32, device=ce.device)
        return ce + aux, {"ce": ce, "aux_loss": aux}

    # ---------------------------------------------------------------- units
    def layer_units(self) -> List[LayerUnit]:
        units = [LayerUnit("embed", ("embed",), kind="aux")]
        for i in range(self.cfg.num_layers):
            units.append(LayerUnit(f"block_{i:03d}", ("blocks",), index=i))
        units.append(LayerUnit("final_norm", ("final_norm",), kind="aux"))
        if not self.cfg.tie_embeddings:
            units.append(LayerUnit("lm_head", ("lm_head",), kind="aux"))
        return units


def _index_tree(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]
