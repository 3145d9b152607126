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

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import gqa_cache_spec, gqa_forward
from repro_torch.models.model_api import (Rule, StackedLM, TensorSpec,
                                          unbind_layers)
from repro_torch.models.modules import rms_norm, swiglu

PyTree = Any


class DecoderLM(StackedLM):
    # ------------------------------------------------------------ structure
    def _block_leaves(self) -> Dict[str, Tuple[Tuple[int, ...], Rule]]:
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
        h = self._embed(params, tokens)
        positions = torch.arange(h.shape[1], device=h.device)
        for layer_p in unbind_layers(params["blocks"]):
            if self.cfg.remat != "none":
                h = checkpoint(self._train_block, layer_p, h, positions,
                               use_reentrant=False)
            else:
                h = self._train_block(layer_p, h, positions)
        return h

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
        h = self._embed(params, tokens)
        positions = torch.arange(t, device=h.device)
        cache = self.init_cache(b, cache_len or t, h.device)
        for i, layer_p in enumerate(unbind_layers(params["blocks"])):
            h, kv = self._block(layer_p, h, positions, return_kv=True)
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
        h = self._embed(params, tok)
        positions = pos + torch.arange(1, device=h.device)
        for layer_p, layer_cache in zip(unbind_layers(params["blocks"]),
                                        unbind_layers(cache["blocks"])):
            h, _ = self._block(layer_p, h, positions, cache=layer_cache,
                               cache_pos=pos)
        return self._logits(params, h)[:, 0], cache

    def _layer_cache_spec(self, batch: int,
                          seq: int) -> Dict[str, TensorSpec]:
        return gqa_cache_spec(self.cfg, batch, seq, self.compute_dtype)
