#!/usr/bin/env python3
"""The ssd_scan kernel's two routes on the card: build, check, time.

    python3 scripts/ssd_routes.py [--quick] [--json PATH]

Builds ``csrc/ssd_scan.cu`` and prints ``ptxas``'s report for each of its
kernels; holds the wrapper (the f32 route) and the bf16 route against
``ssd_scan_plain`` over ``chip_smoke.py``'s ``SSD_CASES`` under its checks
(two launches bitwise equal; ``check_ssd_scan_cases``); then, unless
``--quick``, times both routes on the same bf16 inputs at the Mamba2-370m
serve prefill shape (batch 8 x 1024, 32 heads, Q 256, one group, views of
a conv output) and at batch 1 x 4096, as ``chip_smoke.py``'s phase 2 does
(``ssd_routes_timed``: event time of one call, profiler device time,
kernels per call, device time by kernel).  The quick way to check and time
a change to the kernel without the whole smoke run.  Needs one CUDA card;
exits non-zero without one or when a check fails.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
from chip_smoke import (SSD_LONG, card_line, check_ssd_scan_cases,  # noqa
                        ptxas_report, ssd_inputs, ssd_routes_timed)

# (label, B, S): timed shapes, 32 heads, one group
SHAPES = (("serve_prefill", 8, 1024), ("long", *SSD_LONG))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check only")
    ap.add_argument("--json", type=Path, help="write the record here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels._build import BUILDER
    from repro_torch.kernels.ssd_scan import ops

    dev = torch.device("cuda", 0)
    rec = {"card": card_line()}
    print(rec["card"], flush=True)
    BUILDER.build(["ssd_scan"])
    rec["ptxas"] = ptxas_report(BUILDER.logs.get("ssd_scan", ""))
    print(json.dumps({"ptxas": rec["ptxas"]}), flush=True)
    rec["max_abs_err"] = check_ssd_scan_cases(torch, dev)
    if not args.quick:
        cfg = get_config("mamba2-370m")
        h = cfg.ssm.num_heads(cfg.d_model)
        gen = torch.Generator(device=dev).manual_seed(10)
        for label, b, s in SHAPES:
            q = min(cfg.ssm.chunk_size, s)
            inputs = ssd_inputs(torch, dev, b, s, h, cfg.ssm.ngroups,
                                torch.bfloat16, gen)
            row = {"shape": f"x ({b},{s},{h},{ops.HEAD_DIM}) bf16 views, "
                            f"Q {q}",
                   "bf16_scratch_bytes": ops.scratch_bytes(b, s, h, q),
                   **ssd_routes_timed(torch, inputs, q)}
            print(json.dumps({label: row}), flush=True)
            rec[label] = row
            del inputs
            torch.cuda.empty_cache()
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(rec, indent=1))
    print("OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
