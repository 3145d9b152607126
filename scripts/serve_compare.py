#!/usr/bin/env python3
"""Serve Yi-9B at full width and depth from two source trees, in turns,
on one card: the end-to-end comparison of a kernel change.

    python3 scripts/serve_compare.py --tree parent=PATH --tree change=. \
        [--order parent,change,change,parent] [--json PATH]

Each turn is a fresh process with ``PYTHONPATH=<tree>/src`` that builds
that tree's kernels, warms up (a 2-layer serve of the same shapes), then
runs ``repro_torch.launch.serve.serve`` as ``chip_smoke.py``'s phase 3d
does: random bf16 weights from seed 0, batch 8, 1024-token prompts, 128
greedy tokens.  Prints each turn's prefill seconds, decode tokens/s,
tokens digest (equal digests: the trees generate the same tokens) and
the host microseconds per call spent in the model's ``flash_attention``
calls (prefill and decode).
Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, sys, time, torch
import repro_torch.models.attention as attn
from repro_torch.kernels._build import BUILDER
from repro_torch.launch.serve import serve
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
kw = dict(arch="yi-9b", reduced=False, batch=8, prompt_len=1024, seed=0,
          device="cuda")
serve(num_layers=2, new_tokens=2, **kw)
torch.cuda.empty_cache()
for h in host.values():
    h[:] = [0.0, 0]
res = serve(new_tokens=128, **kw)
print("RESULT " + json.dumps({**{k: res[k] for k in (
    "prefill_seconds", "decode_seconds", "decode_tokens_per_s",
    "tokens_digest")}, "attention_host_us_per_call": {
    k: h[0] / max(h[1], 1) * 1e6 for k, h in host.items()},
    "attention_calls": {k: h[1] for k, h in host.items()}}))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="LABEL=PATH of a source tree (repeatable)")
    ap.add_argument("--order", help="comma-separated labels, in turn order "
                    "(default: each tree once, then in reverse)")
    ap.add_argument("--json", type=Path, help="write the turns here")
    args = ap.parse_args()
    trees = dict(t.split("=", 1) for t in args.tree)
    order = (args.order.split(",") if args.order
             else list(trees) + list(trees)[::-1])
    turns = []
    for label in order:
        root = Path(trees[label]).resolve()
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        p = subprocess.run([sys.executable, "-c", CHILD], env=env, cwd=root,
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
