#!/usr/bin/env python3
"""The MoE family with MLA (DeepSeek-V2-Lite) of the port on the card,
without the rest of ``chip_smoke.py``: phase 2's checks and timings of
``flash_attention`` (its cases at every route's edges, MLA's split head
dims among them, and its main shapes: Yi-9B's, Zamba2-2.7B's and MLA's
prefill and absorbed decode) and phase 3p, as ``chip_smoke.py`` runs
them, timed.

    python3 scripts/moe_probe.py [--json PATH] [--kernels-only]

Builds the kernels, then runs ``check_flash_attention_cases``,
``flash_attention_at_main_shapes`` and (unless ``--kernels-only``)
``phase_3p``, each with its checks.  Prints each part's wall time, the
kernel's MLA rows, the 3p line, the card line and a JSON line of the
seconds; ``--json`` writes the record.  Needs one CUDA card; exits
non-zero without one or when a check fails.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", type=Path, help="write the record here")
    ap.add_argument("--kernels-only", action="store_true",
                    help="phase 2's flash_attention parts only, no 3p")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        cs.log("moe_probe: no CUDA device available")
        return 2
    from repro_torch.kernels._build import BUILDER

    t0 = time.perf_counter()
    card = cs.card_line()
    cs.log(f"card: {card}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    BUILDER.build(["block_fp", "fused_adamw", "block_gather",
                   "flash_attention", "ssd_scan", "quantize"])
    cs.log(f"--- nvcc flash_attention.cu ---\n"
           f"{BUILDER.logs['flash_attention'].strip()}")
    seconds = {"build": time.perf_counter() - t0}
    record = {"card": card, "kernels": [], "seconds": seconds}
    store = ROOT / "build" / "moe_probe_store"
    try:
        t = time.perf_counter()
        err = cs.check_flash_attention_cases(torch, dev)
        record["kernels"].append(
            cs.flash_attention_at_main_shapes(torch, dev, err))
        seconds["flash_attention"] = time.perf_counter() - t
        if not args.kernels_only:
            shutil.rmtree(store, ignore_errors=True)
            store.mkdir(parents=True)
            record["3p"] = {"train": {}, "serve": {}}
            t = time.perf_counter()
            cs.phase_3p(torch, dev, store / "3p", record["3p"])
            seconds["3p"] = time.perf_counter() - t
    finally:
        cs.REMOVER.drain()
        shutil.rmtree(store, ignore_errors=True)
        shutil.rmtree(cs.TRASH, ignore_errors=True)
        cs.write_record(record, args.json)
    for k in record["kernels"]:
        print(json.dumps({key: k[key] for key in (
            "name", "ms", "bound_ms", "plain_ms", "library_ms", "max_abs_err",
            "mla", "ptxas")} | {"card": card}))
    if "3p" in record:
        print(json.dumps({"moe": cs.moe_summary(record["3p"],
                                                {"card": card})}))
    print(card)
    print(json.dumps({**{f"{k}_seconds": v for k, v in seconds.items()},
                      "total": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
