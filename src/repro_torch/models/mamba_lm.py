"""Mamba2 LM (ssm family) of the port: the JAX package's ``MambaLM``
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
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.model_api import (Rule, StackedLM, TensorSpec,
                                          unbind_layers)
from repro_torch.models.modules import rms_norm
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
