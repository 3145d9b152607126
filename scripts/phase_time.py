#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 3e from several source trees, in turns, on
one card: the wall time of one phase before and after a change to it.

    python3 scripts/phase_time.py --tree parent=PATH --tree change=. \
        [--order parent,change] [--json PATH]

Each turn is a fresh process in the tree (``PYTHONPATH=<tree>/src``, the
tree's own ``chip_smoke.py``) that builds the tree's kernels, then runs its
``phase_3e`` on the card with its stores under ``<tree>/build/`` (removed
after), as ``chip_smoke.py`` does after its earlier phases.  Prints each
turn's wall seconds, the training part's seconds, configuration and median
step, the serve part's seconds, and the card line.  A phase check that
fails fails the turn and the command.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, shutil, sys, time
from pathlib import Path
import torch
import chip_smoke as cs
from repro_torch.kernels._build import BUILDER

if not torch.cuda.is_available():
    sys.exit("phase_time: no CUDA device available")
torch.empty(1, device="cuda")    # the card's context, as phase 2 makes it
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
BUILDER.build(["block_fp", "fused_adamw", "block_gather", "flash_attention",
               "ssd_scan", "quantize"])
store = Path("build") / "phase_time_store"
shutil.rmtree(store, ignore_errors=True)
store.mkdir(parents=True)
out = {"train": {}, "store": {}, "serve": {}}
t0 = time.perf_counter()
try:
    cs.phase_3e(torch, torch.device("cuda", 0), store / "3e", out)
finally:
    shutil.rmtree(store, ignore_errors=True)
print("RESULT " + json.dumps({
    "seconds": time.perf_counter() - t0,
    "train_seconds": out["train"]["seconds"],
    "train_config": out["train"]["config"],
    "step_seconds_median": out["train"]["step_seconds_median"],
    "serve_seconds": out["serve"]["seconds"]}))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True,
                    metavar="LABEL=PATH")
    ap.add_argument("--order", help="comma-separated labels (default: each "
                                    "tree once, in the order given)")
    ap.add_argument("--json", type=Path, help="also write the turns here")
    args = ap.parse_args()
    trees = dict(t.split("=", 1) for t in args.tree)
    order = args.order.split(",") if args.order else list(trees)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    turns = []
    for label in order:
        root = Path(trees[label]).resolve()
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        p = subprocess.run([sys.executable, "-c", CHILD], env=env, cwd=root,
                           capture_output=True, text=True)
        sys.stderr.write(p.stderr[-4000:])
        if p.returncode != 0:
            print(f"{label}: exit {p.returncode}", flush=True)
            return p.returncode
        res = json.loads(next(line[7:] for line in p.stdout.splitlines()
                              if line.startswith("RESULT ")))
        turns.append({"label": label} | res)
        print(json.dumps(turns[-1]), flush=True)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"card": card, "turns": turns},
                                        indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
