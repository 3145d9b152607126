"""Batched server of the port: prefill a prompt batch, then greedy
autoregressive decode against the KV cache, on the card by default.

    python -m repro_torch.launch.serve --arch yi-9b [--full] \\
        [--num-layers N] --batch 8 --prompt-len 1024 --new-tokens 128 \\
        [--from-ckpt ROOT [--from-step S] [--hot-swap] \\
         [--store-backend local|memory|tiered|remote|remote3] \\
         [--cache-mb N [--cache-shm]] \\
         [--variant-base-step S --variant-select PATTERNS@STEP ...]] \\
        [--device cpu]

Attention in prefill and decode runs the flash-attention kernel
(``kernels/flash_attention``, CUDA on the card).  Weights come from random
bf16 initialisation (``--seed``), or from a checkpoint root written by
either package, a merged Frankenstein included, through a weights-only
partial restore that never opens an optimizer object:

- ``--from-step S`` pins the initial load to manifest S (default LATEST);
- ``--store-backend`` is the tier the load and the swap read through:
  ``tiered`` and ``remote3`` promote what they read into the RAM tier,
  and ``remote3`` re-warms a lost disk copy from the bucket; the result's
  ``restore`` key carries the load's reads per tier;
- ``--hot-swap`` then waits for a newer manifest and promotes it by digest
  diff (``checkpoint/swap.py``): unchanged units move nothing, block-delta
  units scatter only their dirty blocks; the result's ``swap`` key carries
  the swap's stats;
- ``--cache-mb N`` attaches a digest-keyed host-RAM block cache of N MiB
  (``checkpoint/block_cache.py``) under the store's object reads, so the
  load and the swap read each shared object off the backend once
  (``--cache-shm`` keeps its entries in ``/dev/shm`` segments
  ``repro-io-<pid>-cache-*``); the result's ``cache`` key is its
  snapshot (hits, misses, evictions, coalesced, bypassed, entries, bytes);
- ``--variant-select "PATTERNS@STEP"`` (repeatable, later rules win; comma
  separates recipe patterns in one spec) with ``--variant-base-step``
  serves a zero-copy composite variant assembled by
  ``core.tailor.variant_manifest`` in place of a committed manifest: the
  same weights as an explicit weights-only merge of that selection.

``--smoke`` (the default) serves the reduced config, ``--full`` the
published one; ``--num-layers`` cuts the depth; ``--device cpu`` is the
only way onto the CPU.  ``--io-backend process`` decodes and checks the
loaded objects in ``--io-workers`` subprocess workers (the tables are
still checked on the device).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.devices import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models import build_model


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def parse_variant_select(specs: Sequence[str]) -> List[Tuple[List[str], int]]:
    """``"block_000..block_003@900"`` -> ``([patterns], step)`` pairs;
    comma separates multiple patterns in one spec."""
    out: List[Tuple[List[str], int]] = []
    for spec in specs:
        pats, sep, step = spec.rpartition("@")
        if not sep or not pats:
            raise ValueError(
                f"variant select {spec!r} must look like PATTERNS@STEP")
        out.append(([p.strip() for p in pats.split(",") if p.strip()],
                    int(step)))
    return out


def serve(*, arch: str, reduced: bool = True, batch: int = 4,
          prompt_len: int = 64, new_tokens: int = 32,
          from_ckpt: Optional[str] = None, store_backend: str = "local",
          io_backend: str = "thread", io_workers: Optional[int] = None,
          cache_mb: Optional[int] = None, cache_shm: bool = False,
          seed: int = 0,
          from_step: Optional[int] = None, hot_swap: bool = False,
          swap_wait: float = 30.0, swap_poll: float = 0.2, device=None,
          num_layers: Optional[int] = None,
          variant_base_step: Optional[int] = None,
          variant_select: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    dev = resolve_device(device)
    cfg = get_config(arch, reduced=reduced)
    if num_layers is not None:
        cfg = cfg.replace(num_layers=int(num_layers))
    model = build_model(cfg)
    served_step = swap_stats = restore_stats = cache_stats = None

    if from_ckpt:
        from repro_torch.checkpoint.saver import CheckpointManager
        from repro_torch.checkpoint.swap import WeightService
        from repro_torch.core.layer_registry import LayerRegistry
        from repro_torch.core.policies import make_policy
        from repro_torch.core.tailor import variant_manifest

        registry = LayerRegistry(model)
        mgr = CheckpointManager(Path(from_ckpt), registry,
                                make_policy("full", model.layer_units()),
                                async_save=False,
                                store_backend=store_backend,
                                io_backend=io_backend,
                                io_workers=io_workers,
                                block_cache_bytes=(cache_mb << 20)
                                if cache_mb else None,
                                block_cache_shm=cache_shm)
        try:
            manifest = None
            if variant_select:
                manifest = variant_manifest(
                    mgr.manifests, base_step=variant_base_step,
                    select=parse_variant_select(variant_select), name="cli")
            svc = WeightService(mgr, steps_lib.state_specs(model),
                                device=dev, step=from_step,
                                manifest=manifest)
            restore_stats = dict(svc.restore_stats)
            if hot_swap:
                # Follow the manifest chain until a newer checkpoint lands,
                # then apply it by digest diff onto the served weights.
                deadline = time.time() + swap_wait
                while swap_stats is None:
                    swap_stats = svc.poll()
                    if swap_stats is None:
                        if time.time() >= deadline:
                            raise RuntimeError(
                                f"--hot-swap: no newer manifest than step "
                                f"{svc.step} appeared within "
                                f"{swap_wait:.0f}s")
                        time.sleep(swap_poll)
            params = svc.current()
            served_step = svc.step
            if mgr.block_cache is not None:
                cache_stats = mgr.block_cache.snapshot()
        finally:
            mgr.close()
    else:
        params = model.init(seed, dev, dtype=torch.bfloat16)

    rng = np.random.RandomState(seed)
    prompts = rng.randint(0, cfg.vocab_size,
                          (batch, prompt_len)).astype(np.int32)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(
        params, {"tokens": torch.from_numpy(prompts).to(dev)},
        cache_len=prompt_len + new_tokens)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out_tokens = []
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    t1 = time.perf_counter()
    for i in range(new_tokens):
        out_tokens.append(tok)
        logits, cache = model.decode_step(
            params, cache, {"tokens": tok[:, None], "pos": prompt_len + i})
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
    _sync(dev)
    t_decode = time.perf_counter() - t1

    gen = torch.stack(out_tokens, dim=1).cpu().numpy().astype(np.int32)
    return {
        "arch": arch,
        "batch": batch,
        "prompt_len": prompt_len,
        "new_tokens": new_tokens,
        "prefill_seconds": t_prefill,
        "decode_seconds": t_decode,
        "decode_tokens_per_s": batch * new_tokens / max(t_decode, 1e-9),
        "sample_tokens": gen[0, :8].tolist(),
        # every replica serving identical weights gives an identical digest
        # over all generated tokens (int32 (batch, new_tokens), the JAX
        # server's bytes)
        "tokens_digest": hashlib.blake2b(
            np.ascontiguousarray(gen).tobytes(), digest_size=16).hexdigest(),
        "served_step": served_step,
        "restore": restore_stats,
        "swap": swap_stats,
        "cache": cache_stats,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", choices=ARCH_IDS, default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--num-layers", type=int,
                    help="cut the config's depth (widths unchanged)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--from-ckpt")
    ap.add_argument("--from-step", type=int,
                    help="pin the initial load to this manifest step "
                         "(default: LATEST)")
    ap.add_argument("--hot-swap", action="store_true",
                    help="after loading, wait for a newer manifest and "
                         "promote it by digest diff before generating")
    ap.add_argument("--swap-wait", type=float, default=30.0,
                    help="--hot-swap: seconds to wait for a newer manifest")
    ap.add_argument("--swap-poll", type=float, default=0.2,
                    help="--hot-swap: manifest poll interval (seconds)")
    ap.add_argument("--variant-base-step", type=int,
                    help="variant serving: base manifest step for units "
                         "no --variant-select rule names")
    ap.add_argument("--variant-select", action="append", default=None,
                    metavar="PATTERNS@STEP",
                    help="serve a zero-copy composite variant: take units "
                         "matching PATTERNS (comma-separated recipe "
                         "patterns, e.g. block_000..block_003) from "
                         "manifest STEP; repeatable, later rules win")
    ap.add_argument("--store-backend", default="local",
                    choices=["local", "memory", "tiered", "remote",
                             "remote3"],
                    help="tier --from-ckpt loads read through (tiered and "
                         "remote3 promote what they read into RAM; remote3 "
                         "re-warms a lost disk copy from the bucket)")
    ap.add_argument("--io-backend", default="thread",
                    choices=["thread", "process"],
                    help="where --from-ckpt's object decode and host checks "
                         "run: 'process' in subprocess workers, 'thread' "
                         "in this process")
    ap.add_argument("--io-workers", type=int,
                    help="process backend: subprocess IO workers")
    ap.add_argument("--cache-mb", type=int,
                    help="attach a digest-keyed host-RAM block cache of "
                         "this many MiB under the store's object reads "
                         "(multi-variant serving reads each shared "
                         "digest once)")
    ap.add_argument("--cache-shm", action="store_true",
                    help="back the block cache with /dev/shm segments "
                         "(repro-io-<pid>-cache-*, covered by the "
                         "repo-wide leak guard)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args()
    print(json.dumps(serve(arch=args.arch, reduced=args.smoke,
                           batch=args.batch, prompt_len=args.prompt_len,
                           new_tokens=args.new_tokens,
                           from_ckpt=args.from_ckpt,
                           store_backend=args.store_backend,
                           io_backend=args.io_backend,
                           io_workers=args.io_workers,
                           cache_mb=args.cache_mb, cache_shm=args.cache_shm,
                           seed=args.seed,
                           from_step=args.from_step, hot_swap=args.hot_swap,
                           swap_wait=args.swap_wait,
                           swap_poll=args.swap_poll, device=args.device,
                           num_layers=args.num_layers,
                           variant_base_step=args.variant_base_step,
                           variant_select=args.variant_select), indent=2))


if __name__ == "__main__":
    main()
