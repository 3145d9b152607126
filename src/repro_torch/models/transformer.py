"""Decoder-only LM of the port for the dense and moe families: GQA or MLA
attention, a SwiGLU MLP or a mixture of experts.

The param tree is the JAX package's (``repro/models/transformer.py``):
``embed/w`` (V, D), ``dense_first_<i>`` for a MoE config's first-k dense
layers (DeepSeek-style, not stacked), the other layers' leaves stacked
with the layer dim leading under ``blocks``, ``final_norm/scale`` and,
untied, ``lm_head/w`` (D, V).  The layer units are the JAX package's:
``block_000`` of a first dense layer addresses ``("dense_first_0",)``
with no index, the stacked layers ``("blocks",)`` with theirs.  Layers
run in a Python loop over slices of the stacked leaves, each under
``torch.utils.checkpoint`` when ``remat != "none"`` (the JAX package's
per-layer ``jax.checkpoint``); the loss adds the MoE layers' summed aux
loss to the cross-entropy.

Serving (``prefill``, ``decode_step``, ``cache_spec``) follows the JAX
model: the cache is ``{"blocks": ...}`` stacked over the layers plus
``dense_first_<i>`` per first dense layer, bf16 by default; a GQA layer's
is ``{"k", "v"}`` ``(B, S, G, Dh)``, an MLA layer's ``{"latent",
"rope"}`` (two views of one row buffer, ``attention.mla_cache``).
``prefill`` may allocate the cache at the decode length up front
(``cache_len``) and writes each layer's entries into it, which is what
the JAX server's ``_pad_cache_to`` gives; ``decode_step`` writes its
entries into the cache in place, where the JAX server donates it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import (gqa_cache_spec, gqa_forward,
                                          mla_cache, mla_cache_spec,
                                          mla_forward, mla_leaves)
from repro_torch.models.model_api import (LayerUnit, Rule, StackedLM,
                                          TensorSpec, unbind_layers)
from repro_torch.models.modules import cross_entropy_loss, rms_norm, swiglu
from repro_torch.models.moe import moe_forward, moe_leaves

PyTree = Any
Leaves = Dict[str, Tuple[Tuple[int, ...], Rule]]


class DecoderLM(StackedLM):
    # ------------------------------------------------------------ structure
    @property
    def n_dense_first(self) -> int:
        m = self.cfg.moe
        if self.cfg.family == "moe" and m.first_k_dense:
            return m.first_k_dense
        return 0

    @property
    def n_stacked(self) -> int:
        return self.cfg.num_layers - self.n_dense_first

    def _layer_leaves(self, d_ff: Optional[int]) -> Leaves:
        """One layer's leaves: a SwiGLU MLP of width ``d_ff``, or the MoE
        FFN where ``d_ff`` is None."""
        cfg = self.cfg
        d = cfg.d_model
        dense = ("dense", None)
        out: Leaves = {"ln1": ((d,), ("ones", None)),
                       "ln2": ((d,), ("ones", None))}
        if cfg.mla is not None:
            attn = mla_leaves(cfg)
        else:
            h, g, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
            attn = {"wq": ((d, h, dh), dense), "wk": ((d, g, dh), dense),
                    "wv": ((d, g, dh), dense), "wo": ((h, dh, d), dense)}
        out.update({"attn/" + k: v for k, v in attn.items()})
        if d_ff is None:
            out.update({"moe/" + k: v for k, v in moe_leaves(cfg).items()})
        else:
            out.update({"mlp/w_gate": ((d, d_ff), dense),
                        "mlp/w_up": ((d, d_ff), dense),
                        "mlp/w_down": ((d_ff, d), dense)})
        return out

    def _block_leaves(self) -> Leaves:
        cfg = self.cfg
        return self._layer_leaves(None if cfg.family == "moe" else cfg.d_ff)

    def _aux_leaves(self) -> Leaves:
        out = super()._aux_leaves()
        if self.n_dense_first:
            ff = self.cfg.moe.d_ff_first_dense or self.cfg.d_ff
            for i in range(self.n_dense_first):
                out.update({f"dense_first_{i}/{k}": v
                            for k, v in self._layer_leaves(ff).items()})
        return out

    # --------------------------------------------------------------- forward
    def _block(self, p: Dict, h: torch.Tensor, positions: torch.Tensor,
               cache: Optional[Dict] = None, cache_pos: Optional[int] = None,
               return_kv: bool = False):
        """(h, aux loss or None (no MoE), new k/v or the updated cache or
        None)."""
        cfg = self.cfg
        attn = mla_forward if cfg.mla is not None else gqa_forward
        a_out, kv = attn(p["attn"], rms_norm(h, p["ln1"], cfg.norm_eps),
                         cfg, positions=positions, cache=cache,
                         cache_pos=cache_pos, return_kv=return_kv)
        h = h + a_out
        m_in = rms_norm(h, p["ln2"], cfg.norm_eps)
        if "moe" in p:
            f_out, aux = moe_forward(p["moe"], m_in, cfg)
        else:
            f_out = swiglu(m_in, p["mlp"]["w_gate"], p["mlp"]["w_up"],
                           p["mlp"]["w_down"])
            aux = None
        return h + f_out, aux, kv

    def _train_block(self, p: Dict, h: torch.Tensor,
                     positions: torch.Tensor):
        return self._block(p, h, positions)[:2]

    def _layers(self, params: PyTree) -> List[Dict]:
        """Every layer's params in order: the first dense ones, then views
        of the stacked ones."""
        return ([params[f"dense_first_{i}"]
                 for i in range(self.n_dense_first)]
                + unbind_layers(params["blocks"]))

    def backbone(self, params: PyTree, tokens: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Final hidden states (B, S, D) of the training forward and the
        layers' summed aux loss."""
        h = self._embed(params, tokens)
        positions = torch.arange(h.shape[1], device=h.device)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for layer_p in self._layers(params):
            if self.cfg.remat != "none":
                h, a = checkpoint(self._train_block, layer_p, h, positions,
                                  use_reentrant=False)
            else:
                h, a = self._train_block(layer_p, h, positions)
            if a is not None:
                aux = aux + a
        return h, aux

    def hidden(self, params: PyTree, tokens: torch.Tensor) -> torch.Tensor:
        return self.backbone(params, tokens)[0]

    def loss(self, params, batch):
        tokens = batch["tokens"]
        h, aux = self.backbone(params, tokens)
        logits = self._logits(params, h)
        ce = cross_entropy_loss(logits[:, :-1], tokens[:, 1:])
        return ce + aux, {"ce": ce, "aux_loss": aux}

    # --------------------------------------------------------------- serving
    def _layer_caches(self, cache: PyTree) -> List[Dict]:
        return ([cache[f"dense_first_{i}"]
                 for i in range(self.n_dense_first)]
                + unbind_layers(cache["blocks"]))

    @torch.no_grad()
    def prefill(self, params: PyTree, batch: Dict[str, torch.Tensor],
                cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, PyTree]:
        """Float32 logits of the last position (B, V) and the cache of the
        prompt, allocated at ``cache_len`` positions (default: the prompt
        length) with the tail left zero for decoding."""
        tokens = batch["tokens"]
        b, t = tokens.shape
        h = self._embed(params, tokens)
        positions = torch.arange(t, device=h.device)
        cache = self.init_cache(b, cache_len or t, h.device)
        for layer_p, layer_cache in zip(self._layers(params),
                                        self._layer_caches(cache)):
            h, _, kv = self._block(layer_p, h, positions, return_kv=True)
            for name, val in kv.items():
                layer_cache[name][:, :t] = val
        # the last position only: full logits at 8 x 1024 tokens would be
        # a 2 GB float32 tensor
        return self._logits(params, h[:, -1:])[:, 0], cache

    @torch.no_grad()
    def decode_step(self, params: PyTree, cache: PyTree,
                    batch: Dict[str, Any]) -> Tuple[torch.Tensor, PyTree]:
        """One token per sequence (``tokens`` (B, 1)) at position ``pos``
        (an int): writes its entries into ``cache`` in place and returns
        the float32 logits (B, V) and the cache."""
        tok = batch["tokens"]
        pos = int(batch["pos"])
        h = self._embed(params, tok)
        positions = pos + torch.arange(1, device=h.device)
        for layer_p, layer_cache in zip(self._layers(params),
                                        self._layer_caches(cache)):
            h, _, _ = self._block(layer_p, h, positions, cache=layer_cache,
                                  cache_pos=pos)
        return self._logits(params, h)[:, 0], cache

    def _layer_cache_spec(self, batch: int,
                          seq: int) -> Dict[str, TensorSpec]:
        if self.cfg.mla is not None:
            return mla_cache_spec(self.cfg, batch, seq, self.compute_dtype)
        return gqa_cache_spec(self.cfg, batch, seq, self.compute_dtype)

    def cache_spec(self, batch: int, seq: int) -> PyTree:
        spec = super().cache_spec(batch, seq)
        for i in range(self.n_dense_first):
            spec[f"dense_first_{i}"] = self._layer_cache_spec(batch, seq)
        return spec

    def init_cache(self, batch: int, seq: int,
                   device: torch.device) -> PyTree:
        """A zero cache of ``cache_spec(batch, seq)`` on ``device``."""
        if self.cfg.mla is None:
            return {part: {k: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device)
                           for k, s in specs.items()}
                    for part, specs in self.cache_spec(batch, seq).items()}
        cache = {"blocks": mla_cache(self.cfg, (self.n_stacked,), batch,
                                     seq, self.compute_dtype, device)}
        for i in range(self.n_dense_first):
            cache[f"dense_first_{i}"] = mla_cache(
                self.cfg, (), batch, seq, self.compute_dtype, device)
        return cache

    def layer_units(self) -> List[LayerUnit]:
        units = [LayerUnit("embed", ("embed",), kind="aux")]
        for i in range(self.n_dense_first):
            units.append(LayerUnit(f"block_{i:03d}", (f"dense_first_{i}",)))
        for i in range(self.n_stacked):
            units.append(LayerUnit(f"block_{i + self.n_dense_first:03d}",
                                   ("blocks",), index=i))
        units.append(LayerUnit("final_norm", ("final_norm",), kind="aux"))
        if not self.cfg.tie_embeddings:
            units.append(LayerUnit("lm_head", ("lm_head",), kind="aux"))
        return units
