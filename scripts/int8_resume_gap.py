#!/usr/bin/env python
"""How far an int8 resume lands from the uninterrupted run, in the JAX
package and in the port, on the CPU: the witness for the band that
``chip_smoke.py`` phase 3f records (0.5 nat, the JAX package's own band
for an int8 resume).

Both packages start from one JAX-initialized state (a step-0 store the
JAX package writes, codec none) and train a reduced config with the
parity policy, a save every ``--interval`` steps, a failure at
``--fail-at`` and a resume from the merge to ``--steps``; once with codec
``none`` and once with ``int8``; and without saves, uninterrupted.  Then
each package resumes from the other's int8 store as well.  For each
learning rate it prints one JSON line per (package, codec, store) with the
resumed losses and their distance to that package's uninterrupted run,
after a line counting the elements of v that the port's int8 store (at
the failure) restores as 0 where m is not 0.

Run it from the repo root (about a minute per learning rate)::

    python scripts/int8_resume_gap.py --lrs 1e-3,3e-3
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

SRC = Path(__file__).resolve().parent.parent / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def _seed_store(root: Path, arch: str) -> None:
    import jax
    import numpy as np

    from repro.checkpoint.saver import CheckpointManager
    from repro.configs import get_config
    from repro.core import LayerRegistry
    from repro.core.policies import make_policy
    from repro.launch import steps
    from repro.models import build_model

    model = build_model(get_config(arch, reduced=True))
    state = jax.tree.map(np.asarray, steps.init_state(model,
                                                      jax.random.key(0)))
    mgr = CheckpointManager(root, LayerRegistry(model),
                            make_policy("full", model.layer_units()),
                            codec="none", async_save=False)
    mgr.save(state, step=0)
    mgr.close()


def _zeroed_v(root: Path, arch: str) -> dict:
    """Of the optimizer's v restored from the int8 store at ``root``, the
    elements quantized to 0 where m is not 0 (the port's restore)."""
    import torch

    from repro_torch.checkpoint.saver import CheckpointManager
    from repro_torch.checkpoint.serial import flatten_with_paths
    from repro_torch.configs import get_config
    from repro_torch.core.layer_registry import LayerRegistry
    from repro_torch.core.policies import make_policy
    from repro_torch.launch import steps
    from repro_torch.models import build_model

    model = build_model(get_config(arch, reduced=True))
    mgr = CheckpointManager(root, LayerRegistry(model),
                            make_policy("parity", model.layer_units()))
    st = mgr.restore(steps.state_specs(model), device=torch.device("cpu"))
    mgr.close()
    zero = total = 0
    for (_, v), (_, m) in zip(flatten_with_paths(st["opt"]["v"]),
                              flatten_with_paths(st["opt"]["m"])):
        total += v.numel()
        zero += int(((v == 0) & (m != 0)).sum())
    return {"step": int(st["step"]), "v_zero_where_m_is_not": zero,
            "v_elements": total}


def _trainers():
    from repro.launch.train import SimulatedFailure as JaxFailure
    from repro.launch.train import train as jax_train
    from repro_torch.launch.train import SimulatedFailure, train

    return {"jax": (jax_train, JaxFailure, {}),
            "port": (train, SimulatedFailure, {"device": "cpu"})}


def run(lr: float, args, tmp: Path) -> list:
    kw = dict(arch=args.arch, total_steps=args.steps, batch=args.batch,
              seq_len=args.seq_len, policy_name="parity",
              ckpt_interval=args.interval, seed=0, lr=lr, ckpt_async=False)
    seed = tmp / "seed"
    _seed_store(seed, args.arch)
    rows, refs, int8_roots = [], {}, {}
    for pkg, (train, failure, extra) in _trainers().items():
        root = tmp / f"{pkg}-ref"
        shutil.copytree(seed, root)
        refs[pkg] = dict(train(ckpt_dir=str(root), resume=True, **{
            **kw, **extra, "ckpt_interval": args.steps + 1,
            "codec": "none"})["losses"])
        for codec in ("none", "int8"):
            root = tmp / f"{pkg}-{codec}"
            shutil.copytree(seed, root)
            try:
                train(ckpt_dir=str(root), resume=True, fail_at=args.fail_at,
                      codec=codec, **kw, **extra)
            except failure:
                pass
            if codec == "int8":
                int8_roots[pkg] = tmp / f"{pkg}-int8-at-fail"
                shutil.copytree(root, int8_roots[pkg])
                zeroed = _zeroed_v(root, args.arch)
            res = train(ckpt_dir=str(root), resume=True, codec=codec, **kw,
                        **extra)
            rows.append((pkg, codec, pkg, res["losses"]))
    for pkg, (train, _, extra) in _trainers().items():
        other = "port" if pkg == "jax" else "jax"
        root = tmp / f"{pkg}-from-{other}"
        shutil.copytree(int8_roots[other], root)
        res = train(ckpt_dir=str(root), resume=True, codec="int8", **kw,
                    **extra)
        rows.append((pkg, "int8", other, res["losses"]))
    out = [{"lr": lr, "int8_store_of_the_port": zeroed}]
    for pkg, codec, store, losses in rows:
        gap = {s + 1: abs(l - refs[pkg][s]) for s, l in losses}
        out.append({"lr": lr, "package": pkg, "codec": codec,
                    "store_written_by": store,
                    "resumed_losses": {s + 1: l for s, l in losses},
                    "gap_to_uninterrupted": gap,
                    "within_0.5": all(g <= 0.5 for g in gap.values())})
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--lrs", default="1e-3,3e-3")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--fail-at", type=int, default=5)
    ap.add_argument("--interval", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=32)
    args = ap.parse_args()
    import repro.checkpoint.workers as jax_workers
    import torch

    # the port writes int8 records with comp none: so must the JAX side
    jax_workers.HAVE_ZSTD = False
    torch.set_num_threads(1)
    for lr in (float(x) for x in args.lrs.split(",")):
        with tempfile.TemporaryDirectory() as d:
            for row in run(lr, args, Path(d)):
                print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
