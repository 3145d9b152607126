#!/usr/bin/env python
"""Decode-vs-prefill gap of Mamba2-370m in bf16, by depth, on one set of
weights and tokens: what bf16 rounding alone gives the comparison that
``chip_smoke.py`` holds phase 3e's serve run to.

For each depth the model is Mamba2-370m at full width with its first
``depth`` layers (the weights are drawn per layer and leaf from the seed,
on the CPU, so every depth's model is a prefix of the 48-layer one, and
then moved to the device).  The prompt is ``--prompt`` tokens, and the
last of ``--prompt + 1`` tokens is decoded against the prompt's cache.
It prints one JSON line per depth with

- ``port_gap``: max |logits of the port's decode step - logits of the
  port's prefill of the longer prompt|;
- ``port_scan_gap``: max |the prefill's last logits (the ``ssd_scan``
  wrapper: the kernel on the card) - the training path's last logits
  (the plain chunked scan)| on the longer prompt;
- with ``--jax`` (CPU only): ``jax_gap``, the same comparison in the JAX
  package's ``MambaLM`` on the same bf16 weights and tokens, and
  ``port_vs_jax_prefill`` / ``port_vs_jax_decode``, the two packages'
  logits side by side.

Run it from the repo root::

    python scripts/mamba_decode_gap.py --device cpu --depths 4,12,24 --jax
    python scripts/mamba_decode_gap.py --device cuda --depths 4,12,24,48
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent.parent / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

ARCH = "mamba2-370m"


def _jax_gap(params, toks, depth: int, prompt: int) -> dict:
    """The JAX package's bf16 decode-vs-prefill comparison on the port's
    bf16 weights (bit for bit) and the same tokens, on the CPU."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    import ml_dtypes
    import numpy as np

    from repro.configs import get_config as jax_get_config
    from repro.models import build_model as jax_build_model
    from repro_torch.convert import state_to_numpy

    jm = jax_build_model(jax_get_config(ARCH).model_copy(
        update=dict(num_layers=depth)))
    jp = jax.tree.map(jnp.asarray, state_to_numpy(params, ml_dtypes.bfloat16))
    t = jnp.asarray(toks.numpy())
    _, cache = jm.prefill(jp, {"tokens": t[:, :prompt]})
    ld, _ = jm.decode_step(jp, cache, {"tokens": t[:, prompt:], "pos": prompt})
    lf, _ = jm.prefill(jp, {"tokens": t})
    return {"ld": np.asarray(ld), "lf": np.asarray(lf),
            "jax_gap": float(jnp.max(jnp.abs(ld - lf)))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
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
    cfg = get_config(ARCH)
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
            _, cache = model.prefill(dp, {"tokens": td[:, :-1]})
            ld, _ = model.decode_step(dp, cache, {"tokens": td[:, -1:],
                                                  "pos": args.prompt})
            del cache
            lf, _ = model.prefill(dp, {"tokens": td})
            lt = model._logits(dp, model.hidden(dp, td)[:, -1:])[:, 0]
        out = {"depth": depth, "batch": args.batch, "prompt": args.prompt,
               "device": (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu"),
               "port_gap": (ld - lf).abs().max().item(),
               "port_scan_gap": (lf - lt).abs().max().item(),
               "logits_max_abs": lf.abs().max().item()}
        if args.jax:
            j = _jax_gap(params, toks, depth, args.prompt)
            out.update(jax_gap=j["jax_gap"],
                       port_vs_jax_prefill=float(np.abs(
                           lf.float().cpu().numpy() - j["lf"]).max()),
                       port_vs_jax_decode=float(np.abs(
                           ld.float().cpu().numpy() - j["ld"]).max()))
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        del params, dp, ld, lf, lt
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


if __name__ == "__main__":
    sys.exit(main())
