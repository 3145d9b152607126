"""Dense decoder-only LM (llama-style GQA + SwiGLU) of the port.

The param tree is the JAX package's: ``embed/w`` (V, D), stacked ``blocks``
with the layer dim leading, ``final_norm/scale`` and, untied, ``lm_head/w``
(D, V).  Layers run in a Python loop over slices of the stacked leaves,
each under ``torch.utils.checkpoint`` when ``remat != "none"`` (the JAX
package's per-layer ``jax.checkpoint``).

Serving (``prefill``, ``decode_step``, ``cache_spec``) follows the JAX
model: the cache is ``{"blocks": {"k", "v"}}`` stacked over the layers,
``(L, B, S, G, Dh)`` in bf16.  ``prefill`` may allocate the cache at the
decode length up front (``cache_len``) and writes each layer's k/v into
it, which is what the JAX server's ``_pad_cache_to`` gives; ``decode_step``
writes its k/v into the cache in place, where the JAX server donates it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import gqa_cache_spec, gqa_forward
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

    def init(self, seed: int, device: torch.device,
             dtype: torch.dtype = torch.float32) -> PyTree:
        """Params: truncated normal with 1/sqrt(fan_in) scale (0.02 for
        embeddings) from a generator per leaf (and per layer), ones for
        norms, drawn in float32 and stored in ``dtype`` one layer at a
        time (bf16 serving weights never hold a float32 copy of the
        model)."""
        tree: Dict[str, Any] = {}

        def make(path: str, shape, rule: _Rule) -> torch.Tensor:
            kind, scale = rule
            if kind == "ones":
                return torch.ones(shape, dtype=torch.float32, device=device)
            if scale is None:
                scale = 1.0 / max(int(shape[0]), 1) ** 0.5
            return truncated_normal(shape, scale, seed, path, device)

        for path, (shape, rule) in self._aux_leaves().items():
            self._set(tree, path, make(path, shape, rule).to(dtype))
        n = self.cfg.num_layers
        for path, (shape, rule) in self._block_leaves().items():
            stacked = torch.empty((n,) + shape, dtype=dtype, device=device)
            for i in range(n):
                stacked[i] = make(f"block{i}/{path}", shape, rule)
            self._set(tree, "blocks/" + path, stacked)
        return tree

    # --------------------------------------------------------------- forward
    def _block(self, p: Dict, h: torch.Tensor, positions: torch.Tensor,
               cache: Optional[Dict] = None, cache_pos: Optional[int] = None,
               return_kv: bool = False):
        cfg = self.cfg
        a_out, kv = gqa_forward(p["attn"], rms_norm(h, p["ln1"],
                                                    cfg.norm_eps),
                                cfg, positions=positions, cache=cache,
                                cache_pos=cache_pos, return_kv=return_kv)
        h = h + a_out
        m_in = rms_norm(h, p["ln2"], cfg.norm_eps)
        return h + swiglu(m_in, p["mlp"]["w_gate"], p["mlp"]["w_up"],
                          p["mlp"]["w_down"]), kv

    def _train_block(self, p: Dict, h: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
        return self._block(p, h, positions)[0]

    def hidden(self, params: PyTree, tokens: torch.Tensor) -> torch.Tensor:
        h = embed_lookup(params["embed"]["w"], tokens)
        positions = torch.arange(h.shape[1], device=h.device)
        blocks = params["blocks"]
        for i in range(self.cfg.num_layers):
            layer_p = _index_tree(blocks, i)
            if self.cfg.remat != "none":
                h = checkpoint(self._train_block, layer_p, h, positions,
                               use_reentrant=False)
            else:
                h = self._train_block(layer_p, h, positions)
        return h

    def _logits(self, params: PyTree, h: torch.Tensor) -> torch.Tensor:
        h = rms_norm(h, params["final_norm"]["scale"], self.cfg.norm_eps)
        w = (params["embed"]["w"].t() if self.cfg.tie_embeddings
             else params["lm_head"]["w"])
        return unembed_logits(h, w)

    def logits(self, params: PyTree, tokens: torch.Tensor) -> torch.Tensor:
        return self._logits(params, self.hidden(params, tokens))

    def loss(self, params, batch):
        tokens = batch["tokens"]
        logits = self.logits(params, tokens)
        ce = cross_entropy_loss(logits[:, :-1], tokens[:, 1:])
        aux = torch.zeros((), dtype=torch.float32, device=ce.device)
        return ce + aux, {"ce": ce, "aux_loss": aux}

    # --------------------------------------------------------------- serving
    @torch.no_grad()
    def prefill(self, params: PyTree, batch: Dict[str, torch.Tensor],
                cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, PyTree]:
        """Float32 logits of the last position (B, V) and the k/v cache of
        the prompt, allocated at ``cache_len`` positions (default: the
        prompt length) with the tail left zero for decoding."""
        tokens = batch["tokens"]
        b, t = tokens.shape
        h = embed_lookup(params["embed"]["w"], tokens)
        positions = torch.arange(t, device=h.device)
        cache = self.init_cache(b, cache_len or t, h.device)
        blocks = params["blocks"]
        for i in range(self.cfg.num_layers):
            h, kv = self._block(_index_tree(blocks, i), h, positions,
                                return_kv=True)
            for name in ("k", "v"):
                cache["blocks"][name][i, :, :t] = kv[name]
        # the last position only: full logits at 8 x 1024 tokens would be
        # a 2 GB float32 tensor
        return self._logits(params, h[:, -1:])[:, 0], cache

    @torch.no_grad()
    def decode_step(self, params: PyTree, cache: PyTree,
                    batch: Dict[str, Any]) -> Tuple[torch.Tensor, PyTree]:
        """One token per sequence (``tokens`` (B, 1)) at position ``pos``
        (an int): writes its k/v into ``cache`` in place and returns the
        float32 logits (B, V) and the cache."""
        tok = batch["tokens"]
        pos = int(batch["pos"])
        h = embed_lookup(params["embed"]["w"], tok)
        positions = pos + torch.arange(1, device=h.device)
        blocks, kv = params["blocks"], cache["blocks"]
        for i in range(self.cfg.num_layers):
            layer_cache = {"k": kv["k"][i], "v": kv["v"][i]}
            h, _ = self._block(_index_tree(blocks, i), h, positions,
                               cache=layer_cache, cache_pos=pos)
        return self._logits(params, h)[:, 0], cache

    def cache_spec(self, batch: int, seq: int) -> PyTree:
        one = gqa_cache_spec(self.cfg, batch, seq)
        return {"blocks": {k: TensorSpec((self.cfg.num_layers,) + s.shape,
                                         s.dtype)
                           for k, s in one.items()}}

    def init_cache(self, batch: int, seq: int,
                   device: torch.device) -> PyTree:
        """A zero cache of ``cache_spec(batch, seq)`` on ``device``."""
        return {"blocks": {k: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device)
                           for k, s in self.cache_spec(
                               batch, seq)["blocks"].items()}}

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
