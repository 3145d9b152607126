"""Mamba2 LM (ssm family) and the Zamba2-style hybrid LM (hybrid family)
of the port: the JAX package's ``MambaLM`` and ``HybridLM``
(``repro/models/mamba_lm.py``).

The param tree is the JAX package's: ``embed/w`` (V, D), stacked
``blocks/{ln, mixer/...}`` with the layer dim leading, ``final_norm/scale``
and, untied, ``lm_head/w``; mamba2-370m ties its embeddings.  Layers run in
a Python loop over slices of the stacked leaves, each under
``torch.utils.checkpoint`` when ``remat != "none"``.

Serving follows the JAX model: the cache is ``{"blocks": {"state",
"conv"}}`` stacked over the layers, ``(L, B, H, P, N)`` float32 and
``(L, B, K-1, conv_dim)`` bf16, whose size does not depend on the
sequence.  ``prefill`` runs the ``ssd_scan`` kernel (CUDA on the card) in
every layer and writes the layer's state and conv window into the cache;
``decode_step`` updates them in place.

``HybridLM`` adds one *shared-weight* transformer block (``shared``: the
JAX tree's ``ln1`` (2D), ``attn/wq`` (2D, H, Dh), ``attn/wk|wv`` (2D, G,
Dh), ``attn/wo`` (H, Dh, D), ``ln2`` (D), ``mlp/w_gate|w_up|w_down``),
run after every ``shared_period`` Mamba2 layers on ``concat(h, x0)``, x0
the embedding output.  Training checkpoints each group (its layers and the
shared block) as JAX's ``group_body``.  Each invocation keeps its own GQA
cache, ``{"shared": {"k", "v"}}`` stacked over the groups, ``(G, B, S,
KV, Dh)`` at the decode length, beside the Mamba2 caches; its attention
runs the ``flash_attention`` kernel in prefill and decode.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import gqa_cache_spec, gqa_forward
from repro_torch.models.model_api import (LayerUnit, Rule, StackedLM,
                                          TensorSpec, unbind_layers)
from repro_torch.models.modules import COMPUTE_DTYPE, rms_norm, swiglu
from repro_torch.models.ssm import (init_mamba2, mamba2_cache_spec,
                                    mamba2_forward)

PyTree = Any


class MambaLM(StackedLM):
    """Pure SSM decoder (mamba2-370m)."""

    def _block_leaves(self) -> Dict[str, Tuple[Tuple[int, ...], Rule]]:
        out = {"ln": ((self.cfg.d_model,), ("ones", None))}
        out.update({"mixer/" + k: v
                    for k, v in init_mamba2(self.cfg).items()})
        return out

    def _block(self, p: Dict, h: torch.Tensor, cache=None,
               prefill: bool = False):
        out, new_cache = mamba2_forward(
            p["mixer"], rms_norm(h, p["ln"], self.cfg.norm_eps), self.cfg,
            cache=cache, prefill=prefill)
        return h + out, new_cache

    def _train_block(self, p: Dict, h: torch.Tensor) -> torch.Tensor:
        return self._block(p, h)[0]

    def hidden(self, params: PyTree, tokens: torch.Tensor) -> torch.Tensor:
        h = self._embed(params, tokens)
        for layer_p in unbind_layers(params["blocks"]):
            if self.cfg.remat != "none":
                h = checkpoint(self._train_block, layer_p, h,
                               use_reentrant=False)
            else:
                h = self._train_block(layer_p, h)
        return h

    # --------------------------------------------------------------- serving
    @torch.no_grad()
    def prefill(self, params: PyTree, batch: Dict[str, torch.Tensor],
                cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, PyTree]:
        """Float32 logits of the last position (B, V) and the decode cache
        of the prompt.  ``cache_len`` is accepted for the server's call and
        ignored: the cache does not grow with the sequence."""
        tokens = batch["tokens"]
        h = self._embed(params, tokens)
        cache = self.init_cache(tokens.shape[0], tokens.shape[1], h.device)
        for i, layer_p in enumerate(unbind_layers(params["blocks"])):
            h, c = self._block(layer_p, h, prefill=True)
            for name in ("state", "conv"):
                cache["blocks"][name][i] = c[name]
        return self._logits(params, h[:, -1:])[:, 0], cache

    @torch.no_grad()
    def decode_step(self, params: PyTree, cache: PyTree,
                    batch: Dict[str, Any]) -> Tuple[torch.Tensor, PyTree]:
        """One token per sequence (``tokens`` (B, 1)); ``pos`` is not
        needed.  Updates each layer's state and conv window in ``cache``
        in place and returns the float32 logits (B, V) and the cache."""
        h = self._embed(params, batch["tokens"])
        for layer_p, layer_cache in zip(unbind_layers(params["blocks"]),
                                        unbind_layers(cache["blocks"])):
            h, _ = self._block(layer_p, h, cache=layer_cache)
        return self._logits(params, h)[:, 0], cache

    def _layer_cache_spec(self, batch: int,
                          seq: int) -> Dict[str, TensorSpec]:
        return mamba2_cache_spec(self.cfg, batch, self.compute_dtype)


class HybridLM(MambaLM):
    """Zamba2: a Mamba2 backbone and one shared transformer block after
    every ``shared_period`` layers."""

    def __init__(self, cfg: ModelConfig,
                 compute_dtype: torch.dtype = COMPUTE_DTYPE):
        super().__init__(cfg, compute_dtype)
        period = cfg.hybrid.shared_period
        if period <= 0 or cfg.num_layers % period:
            raise ValueError(f"{cfg.name}: {cfg.num_layers} layers is not a "
                             f"multiple of shared_period {period}")
        self.period = period
        self.n_groups = cfg.num_layers // period

    def _aux_leaves(self) -> Dict[str, Tuple[Tuple[int, ...], Rule]]:
        cfg = self.cfg
        d, h, g, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.resolved_head_dim)
        ff = cfg.hybrid.shared_d_ff or cfg.d_ff
        dense = ("dense", None)
        out = super()._aux_leaves()
        out.update({
            "shared/ln1": ((2 * d,), ("ones", None)),
            "shared/attn/wq": ((2 * d, h, dh), dense),
            "shared/attn/wk": ((2 * d, g, dh), dense),
            "shared/attn/wv": ((2 * d, g, dh), dense),
            "shared/attn/wo": ((h, dh, d), dense),
            "shared/ln2": ((d,), ("ones", None)),
            "shared/mlp/w_gate": ((d, ff), dense),
            "shared/mlp/w_up": ((d, ff), dense),
            "shared/mlp/w_down": ((ff, d), dense),
        })
        return out

    def _shared_block(self, p: Dict, h: torch.Tensor, x0: torch.Tensor,
                      positions: torch.Tensor, cache=None,
                      cache_pos: Optional[int] = None,
                      return_kv: bool = False):
        eps = self.cfg.norm_eps
        xin = torch.cat([h, x0], dim=-1)
        a_out, kv = gqa_forward(p["attn"], rms_norm(xin, p["ln1"], eps),
                                self.cfg, positions=positions, cache=cache,
                                cache_pos=cache_pos, return_kv=return_kv)
        h = h + a_out
        m_in = rms_norm(h, p["ln2"], eps)
        return h + swiglu(m_in, p["mlp"]["w_gate"], p["mlp"]["w_up"],
                          p["mlp"]["w_down"]), kv

    def _train_group(self, layers, shared: Dict, h: torch.Tensor,
                     x0: torch.Tensor, positions: torch.Tensor
                     ) -> torch.Tensor:
        for layer_p in layers:
            h = self._block(layer_p, h)[0]
        return self._shared_block(shared, h, x0, positions)[0]

    def _groups(self, tree) -> list:
        layers = unbind_layers(tree)
        return [layers[i * self.period:(i + 1) * self.period]
                for i in range(self.n_groups)]

    def hidden(self, params: PyTree, tokens: torch.Tensor) -> torch.Tensor:
        h = self._embed(params, tokens)
        x0 = h
        positions = torch.arange(h.shape[1], device=h.device)
        for group in self._groups(params["blocks"]):
            if self.cfg.remat != "none":
                h = checkpoint(self._train_group, group, params["shared"], h,
                               x0, positions, use_reentrant=False)
            else:
                h = self._train_group(group, params["shared"], h, x0,
                                      positions)
        return h

    # --------------------------------------------------------------- serving
    @torch.no_grad()
    def prefill(self, params: PyTree, batch: Dict[str, torch.Tensor],
                cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, PyTree]:
        """Float32 logits of the last position (B, V) and the decode
        cache: the Mamba2 layers' states and conv windows, and each shared
        invocation's k/v allocated at ``cache_len`` positions (default:
        the prompt length) with the tail left zero for decoding."""
        tokens = batch["tokens"]
        b, t = tokens.shape
        h = self._embed(params, tokens)
        x0 = h
        positions = torch.arange(t, device=h.device)
        cache = self.init_cache(b, cache_len or t, h.device)
        i = 0
        for gi, group in enumerate(self._groups(params["blocks"])):
            for layer_p in group:
                h, c = self._block(layer_p, h, prefill=True)
                for name in ("state", "conv"):
                    cache["blocks"][name][i] = c[name]
                i += 1
            h, kv = self._shared_block(params["shared"], h, x0, positions,
                                       return_kv=True)
            for name in ("k", "v"):
                cache["shared"][name][gi, :, :t] = kv[name]
        return self._logits(params, h[:, -1:])[:, 0], cache

    @torch.no_grad()
    def decode_step(self, params: PyTree, cache: PyTree,
                    batch: Dict[str, Any]) -> Tuple[torch.Tensor, PyTree]:
        """One token per sequence (``tokens`` (B, 1)) at position ``pos``
        (an int): updates the Mamba2 states and conv windows and writes
        each shared invocation's k/v into ``cache`` in place; returns the
        float32 logits (B, V) and the cache."""
        pos = int(batch["pos"])
        h = self._embed(params, batch["tokens"])
        x0 = h
        positions = pos + torch.arange(1, device=h.device)
        layer_caches = unbind_layers(cache["blocks"])
        shared_caches = unbind_layers(cache["shared"])
        i = 0
        for gi, group in enumerate(self._groups(params["blocks"])):
            for layer_p in group:
                h, _ = self._block(layer_p, h, cache=layer_caches[i])
                i += 1
            h, _ = self._shared_block(params["shared"], h, x0, positions,
                                      cache=shared_caches[gi],
                                      cache_pos=pos)
        return self._logits(params, h)[:, 0], cache

    def cache_spec(self, batch: int, seq: int) -> PyTree:
        spec = super().cache_spec(batch, seq)
        spec["shared"] = {
            k: TensorSpec((self.n_groups,) + s.shape, s.dtype)
            for k, s in gqa_cache_spec(self.cfg, batch, seq,
                                       self.compute_dtype).items()}
        return spec

    def init_cache(self, batch: int, seq: int,
                   device: torch.device) -> PyTree:
        return {part: {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
                       for k, s in specs.items()}
                for part, specs in self.cache_spec(batch, seq).items()}

    def layer_units(self) -> List[LayerUnit]:
        units = super().layer_units()
        units.insert(-1, LayerUnit("shared_attn", ("shared",), kind="aux"))
        return units
