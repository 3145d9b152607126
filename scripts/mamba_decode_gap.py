#!/usr/bin/env python
"""Decode-vs-prefill gap of a model in bf16, by depth, on one set of
weights and tokens: what bf16 rounding alone gives the comparison that
``chip_smoke.py`` holds a serve run to (phase 3e: Mamba2-370m, the
default ``--arch``; phase 3o: Zamba2-2.7B, whose depths are multiples of
its shared period, 6; phase 3p: DeepSeek-V2-Lite, MoE with MLA).

A MoE model runs on a copy of its config whose capacity factor is
``--capacity-factor``: by default ``num_experts / top_k``, where no token
can be dropped (at the published 1.25 the prompt's last token takes the
last capacity slots of the longer prefill, so it is the first dropped,
while a decode step runs every expert: the gap then measures the drop,
not rounding); ``published`` keeps the config's.

For each depth the model is the architecture at full width with its first
``depth`` layers (the weights are drawn per layer and leaf from the seed,
on the CPU, so every depth's model is a prefix of the full one, and
then moved to the device).  The prompt is ``--prompt`` tokens, and the
last of ``--prompt + 1`` tokens is decoded against the prompt's cache.
It prints one JSON line per depth with

- ``port_gap``: max |logits of the port's decode step - logits of the
  port's prefill of the longer prompt|;
- ``port_scan_gap`` (SSM families): max |the prefill's last logits (the
  ``ssd_scan`` wrapper: the kernel on the card) - the training path's
  last logits (the plain chunked scan)| on the longer prompt;
- with ``--jax`` (CPU only): ``jax_gap``, the same comparison in the JAX
  package's ``MambaLM`` or ``HybridLM`` on the same bf16 weights and
  tokens, and
  ``port_vs_jax_prefill`` / ``port_vs_jax_decode``, the two packages'
  logits side by side (at full width a JAX MoE prefill builds its
  one-hot (G, T, E, C) dispatch tensors: at the no-drop factor, C = 1024,
  ~14 TFLOP and ~10 GB a MoE layer on the CPU).

Run it from the repo root::

    python scripts/mamba_decode_gap.py --device cpu --depths 4,12,24 --jax
    python scripts/mamba_decode_gap.py --device cuda --depths 4,12,24,48
    python scripts/mamba_decode_gap.py --arch zamba2-2.7b --device cpu \
        --depths 6,12,24 --jax
    python scripts/mamba_decode_gap.py --arch deepseek-v2-lite-16b \
        --device cpu --depths 2,4 --jax
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent.parent / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))


def _jax_gap(arch: str, params, toks, depth: int, prompt: int,
             capacity_factor) -> dict:
    """The JAX package's bf16 decode-vs-prefill comparison on the port's
    bf16 weights (bit for bit) and the same tokens, on the CPU."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    import ml_dtypes
    import numpy as np

    from repro.configs import get_config as jax_get_config
    from repro.launch.serve import _pad_cache_to
    from repro.models import build_model as jax_build_model
    from repro_torch.convert import state_to_numpy

    cfg = jax_get_config(arch)
    update = dict(num_layers=depth)
    if capacity_factor is not None:
        update["moe"] = cfg.moe.model_copy(
            update=dict(capacity_factor=capacity_factor))
    jm = jax_build_model(cfg.model_copy(update=update))
    jp = jax.tree.map(jnp.asarray, state_to_numpy(params, ml_dtypes.bfloat16))
    t = jnp.asarray(toks.numpy())
    _, cache = jm.prefill(jp, {"tokens": t[:, :prompt]})
    # the JAX server's growth of the attention cache to the decode length
    # (a hybrid's shared k/v; the Mamba2 caches do not grow)
    cache = _pad_cache_to(cache, jm, t.shape[0], prompt + 1)
    ld, _ = jm.decode_step(jp, cache, {"tokens": t[:, prompt:], "pos": prompt})
    lf, _ = jm.prefill(jp, {"tokens": t})
    return {"ld": np.asarray(ld), "lf": np.asarray(lf),
            "jax_gap": float(jnp.max(jnp.abs(ld - lf)))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-370m",
                    choices=("mamba2-370m", "zamba2-2.7b",
                             "deepseek-v2-lite-16b"))
    ap.add_argument("--capacity-factor", default="nodrop",
                    help="MoE only: nodrop (num_experts / top_k), "
                         "published, or a number")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--depths", default="4,12,24,48")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--jax", action="store_true",
                    help="also run the JAX package on the CPU")
    args = ap.parse_args()
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    dev = torch.device(args.device)
    if args.jax and dev.type != "cpu":
        ap.error("--jax compares on the CPU only")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    cf = None
    if cfg.moe is not None and args.capacity_factor != "published":
        cf = (cfg.moe.num_experts / cfg.moe.top_k
              if args.capacity_factor == "nodrop"
              else float(args.capacity_factor))
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=cf))
    ssm = cfg.ssm is not None
    toks = torch.from_numpy(np.random.RandomState(args.seed).randint(
        0, cfg.vocab_size, (args.batch, args.prompt + 1)).astype(np.int32))
    for depth in (int(d) for d in args.depths.split(",")):
        t0 = time.perf_counter()
        model = build_model(cfg.replace(num_layers=depth))
        params = model.init(args.seed, torch.device("cpu"),
                            dtype=torch.bfloat16)
        dp = _to(params, dev)
        td = toks.to(dev)
        with torch.no_grad():
            _, cache = model.prefill(dp, {"tokens": td[:, :-1]},
                                     cache_len=args.prompt + 1)
            ld, _ = model.decode_step(dp, cache, {"tokens": td[:, -1:],
                                                  "pos": args.prompt})
            del cache
            lf, _ = model.prefill(dp, {"tokens": td})
            if ssm:
                lt = model._logits(dp, model.hidden(dp, td)[:, -1:])[:, 0]
        out = {"arch": args.arch, "depth": depth, "batch": args.batch,
               "prompt": args.prompt,
               "capacity_factor": (cfg.moe.capacity_factor
                                   if cfg.moe is not None else None),
               "device": (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu"),
               "port_gap": (ld - lf).abs().max().item(),
               "logits_max_abs": lf.abs().max().item()}
        if ssm:
            out["port_scan_gap"] = (lf - lt).abs().max().item()
        if args.jax:
            j = _jax_gap(args.arch, params, toks, depth, args.prompt, cf)
            out.update(jax_gap=j["jax_gap"],
                       port_vs_jax_prefill=float(np.abs(
                           lf.float().cpu().numpy() - j["lf"]).max()),
                       port_vs_jax_decode=float(np.abs(
                           ld.float().cpu().numpy() - j["ld"]).max()))
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        del params, dp, ld, lf
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


if __name__ == "__main__":
    sys.exit(main())
