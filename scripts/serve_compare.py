#!/usr/bin/env python3
"""Serve a model at full width and depth from two source trees, in turns,
on one card: the end-to-end comparison of a kernel change.

    python3 scripts/serve_compare.py --tree parent=PATH --tree change=. \
        [--arch yi-9b|mamba2-370m] [--route LABEL=ROUTE] \
        [--order parent,change,change,parent] [--json PATH]

Each turn is a fresh process with ``PYTHONPATH=<tree>/src`` that builds
that tree's kernels, warms up (a 2-layer serve of the same shapes), then
runs ``repro_torch.launch.serve.serve`` as ``chip_smoke.py`` does: random
bf16 weights from seed 0, batch 8, 1024-token prompts, 128 greedy tokens;
``--arch yi-9b`` (the default) is phase 3d's serve, ``--arch mamba2-370m``
phase 3e's.  Prints each turn's prefill seconds, decode tokens/s and
tokens digest (equal digests: the trees generate the same tokens); for
Yi-9B also the host microseconds per call spent in the model's
``flash_attention`` calls (prefill and decode); for Mamba2-370m also the
tree's ``ssd_scan`` at the serve prefill shape (batch 8 x 1024, 32 heads,
Q 256, ``chip_smoke.py``'s ``ssd_inputs`` from seed 10, taken from the
tree's own ``chip_smoke.py``): profiler device ms per call, kernels per
call and event ms of one call.  ``--route LABEL=ROUTE`` runs that tree's
turns with the model's scan through ``ops.launch(..., ROUTE)`` (a route
the wrapper does not take, such as ``bf16``), and times that route; the
same tree may appear under two labels, one with a route and one without.
Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

COMMON = r"""
import json, sys, time, torch
from repro_torch.kernels._build import BUILDER
from repro_torch.launch.serve import serve
kw = dict(arch=ARCH, reduced=False, batch=8, prompt_len=1024, seed=0,
          device="cuda")
KEYS = ("prefill_seconds", "decode_seconds", "decode_tokens_per_s",
        "tokens_digest")
"""

YI = r"""
import repro_torch.models.attention as attn
BUILDER.build(["flash_attention"])
# host seconds inside the model's flash_attention calls, by query count
host = {"decode": [0.0, 0], "prefill": [0.0, 0]}
wrapped = attn.flash_attention
def timed(q, *a, **kw):
    t = time.perf_counter()
    out = wrapped(q, *a, **kw)
    h = host["decode" if q.shape[1] == 1 else "prefill"]
    h[0] += time.perf_counter() - t
    h[1] += 1
    return out
attn.flash_attention = timed
serve(num_layers=2, new_tokens=2, **kw)
torch.cuda.empty_cache()
for h in host.values():
    h[:] = [0.0, 0]
res = serve(new_tokens=128, **kw)
print("RESULT " + json.dumps({**{k: res[k] for k in KEYS},
    "attention_host_us_per_call": {
        k: h[0] / max(h[1], 1) * 1e6 for k, h in host.items()},
    "attention_calls": {k: h[1] for k, h in host.items()}}))
"""

MAMBA = r"""
import repro_torch.models.ssm as ssm
from repro_torch.kernels.ssd_scan import ssd_scan
from chip_smoke import cuda_ms, device_ms, ssd_inputs
BUILDER.build(["ssd_scan"])
scan = ssd_scan
if ROUTE:    # the model's scan through this route
    from repro_torch.kernels.ssd_scan import ops
    scan = ssm.ssd_scan = lambda *a: ops.launch(*a, ROUTE)
serve(num_layers=2, new_tokens=2, **kw)
torch.cuda.empty_cache()
res = serve(new_tokens=128, **kw)
torch.cuda.empty_cache()
dev = torch.device("cuda", 0)
args = ssd_inputs(torch, dev, 8, 1024, 32, 1, torch.bfloat16,
                  torch.Generator(device=dev).manual_seed(10))
call = lambda: scan(*args, 256)
dev_ms, per_call = device_ms(torch, call, 20, "")
print("RESULT " + json.dumps({**{k: res[k] for k in KEYS},
    "ssd_scan_route": ROUTE, "ssd_scan_device_ms": dev_ms,
    "ssd_scan_kernels_per_call": per_call,
    "ssd_scan_event_ms": cuda_ms(call, 20, torch)}))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="LABEL=PATH of a source tree (repeatable)")
    ap.add_argument("--arch", default="yi-9b",
                    choices=("yi-9b", "mamba2-370m"))
    ap.add_argument("--route", action="append", default=[],
                    help="LABEL=ROUTE: that tree's Mamba2 scan through "
                    "ssd_scan.ops.launch(..., ROUTE) (repeatable)")
    ap.add_argument("--order", help="comma-separated labels, in turn order "
                    "(default: each tree once, then in reverse)")
    ap.add_argument("--json", type=Path, help="write the turns here")
    args = ap.parse_args()
    trees = dict(t.split("=", 1) for t in args.tree)
    order = (args.order.split(",") if args.order
             else list(trees) + list(trees)[::-1])
    routes = dict(r.split("=", 1) for r in args.route)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[:1]
    print(json.dumps({"card": card[0] if card else None,
                      "arch": args.arch}), flush=True)
    turns = []
    for label in order:
        root = Path(trees[label]).resolve()
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        child = (f"ARCH = {args.arch!r}\nROUTE = {routes.get(label)!r}\n"
                 + COMMON + (YI if args.arch == "yi-9b" else MAMBA))
        p = subprocess.run([sys.executable, "-c", child], env=env, cwd=root,
                           capture_output=True, text=True)
        lines = [ln for ln in p.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if p.returncode != 0 or not lines:
            print(f"{label}: failed (exit {p.returncode})\n{p.stderr[-3000:]}",
                  file=sys.stderr)
            return 1
        turn = {"tree": label, **json.loads(lines[-1][7:])}
        turns.append(turn)
        print(json.dumps(turn), flush=True)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(turns, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
