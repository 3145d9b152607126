#!/usr/bin/env python3
"""The hybrid family (Zamba2-2.7B) of the port on the card, without the
rest of ``chip_smoke.py``: phase 2's checks and timings of the two
kernels it runs (``flash_attention`` at head dim 80 on each route and
``ssd_scan`` at state dim 64, beside the earlier shapes) and phase 3o, as
``chip_smoke.py`` runs them, timed.

    python3 scripts/hybrid_probe.py [--json PATH] [--kernels-only]

Builds the kernels, then runs ``check_flash_attention_cases``,
``flash_attention_at_main_shapes``, ``check_ssd_scan_cases``,
``ssd_scan_at_main_shape`` and (unless ``--kernels-only``)
``phase_3o``, each with its checks.  Prints each part's wall time, the
two kernels' rows, the card line and a JSON line of the seconds;
``--json`` writes the record.  Needs one CUDA card; exits non-zero
without one or when a check fails.
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
                    help="phase 2's parts only, no phase 3o")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        cs.log("hybrid_probe: no CUDA device available")
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
    for name in ("flash_attention", "ssd_scan"):
        cs.log(f"--- nvcc {name}.cu ---\n{BUILDER.logs[name].strip()}")
    seconds = {"build": time.perf_counter() - t0}
    record = {"card": card, "kernels": [], "seconds": seconds}
    store = ROOT / "build" / "hybrid_probe_store"
    try:
        t = time.perf_counter()
        err = cs.check_flash_attention_cases(torch, dev)
        record["kernels"].append(
            cs.flash_attention_at_main_shapes(torch, dev, err))
        seconds["flash_attention"] = time.perf_counter() - t
        t = time.perf_counter()
        err = cs.check_ssd_scan_cases(torch, dev)
        record["kernels"].append(cs.ssd_scan_at_main_shape(torch, dev, err))
        seconds["ssd_scan"] = time.perf_counter() - t
        if not args.kernels_only:
            shutil.rmtree(store, ignore_errors=True)
            store.mkdir(parents=True)
            record["3o"] = {"train": {}, "serve": {}}
            t = time.perf_counter()
            cs.phase_3o(torch, dev, store / "3o", record["3o"])
            seconds["3o"] = time.perf_counter() - t
    finally:
        cs.REMOVER.drain()
        shutil.rmtree(store, ignore_errors=True)
        shutil.rmtree(cs.TRASH, ignore_errors=True)
        cs.write_record(record, args.json)
    for k in record["kernels"]:
        print(json.dumps({key: k[key] for key in (
            "name", "ms", "bound_ms", "plain_ms", "library_ms", "max_abs_err",
            "zamba2")} | {"card": card}))
    print(card)
    print(json.dumps({**{f"{k}_seconds": v for k, v in seconds.items()},
                      "total": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
