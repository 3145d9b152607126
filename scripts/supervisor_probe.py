#!/usr/bin/env python3
"""The supervised drill of the port on the card, without the rest of
``chip_smoke.py``: its phase 3a (the reference run whose losses 3m holds
the drill to), optionally its phase 3h (the canonical path on 3a's
store, which then removes it, as in ``chip_smoke.py``), and its phase
3m, timed.

    python3 scripts/supervisor_probe.py [--json PATH] [--with-3h]

Builds the kernels, lets child processes cache their bytecode as
``chip_smoke.py`` does, then runs ``chip_smoke.phase_3a``, (``--with-3h``)
``chip_smoke.phase_3h`` and ``chip_smoke.phase_3m``, each with its
checks.  Prints each phase's wall time, 3h's parts and events, the
``{"supervisor": ...}`` line, the card line and a JSON line of the
seconds; ``--json`` writes the record of the phases.  Needs one CUDA
card; exits non-zero without one or when a check fails.
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
    ap.add_argument("--with-3h", action="store_true",
                    help="run phase 3h between 3a and 3m")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        cs.log("supervisor_probe: no CUDA device available")
        return 2
    from repro_torch.kernels._build import BUILDER

    t0 = time.perf_counter()
    card = cs.card_line()
    cs.log(f"card: {card}")
    cs.log(f"bytecode: {cs.cache_bytecode()}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    BUILDER.build(["block_fp", "fused_adamw", "block_gather",
                   "flash_attention", "ssd_scan", "quantize"])
    store = ROOT / "build" / "supervisor_probe_store"
    shutil.rmtree(store, ignore_errors=True)
    store.mkdir(parents=True)
    mp = {"3a": {}, "3h": {}, "3m": {}}
    seconds = {}
    try:
        t = time.perf_counter()
        ref = cs.phase_3a(torch, dev, store / "3a", mp["3a"])
        seconds["3a"] = time.perf_counter() - t
        if args.with_3h:
            t = time.perf_counter()
            cs.phase_3h(torch, dev, store, ref, mp["3a"], mp["3h"])
            seconds["3h"] = time.perf_counter() - t
            h = mp["3h"]
            cs.log(f"3h: {seconds['3h']:.1f} s, parts " + str(
                {k: round(h[k]["seconds"], 1) for k in "cabde"}))
            for e in h["c"]["event"] + h["a"]["events"]:
                cs.log(f"3h event {e}")
        shutil.rmtree(store / "3a", ignore_errors=True)
        torch.cuda.empty_cache()
        t = time.perf_counter()
        cs.phase_3m(torch, dev, store, ref, mp["3m"])
        seconds["3m"] = time.perf_counter() - t
    finally:
        shutil.rmtree(store, ignore_errors=True)
        cs.write_record({"card": card, "main_path": mp,
                         "seconds": seconds}, args.json)
    print(json.dumps({"supervisor": cs.supervisor_summary(mp["3m"])
                      | {"card": card}}))
    print(card)
    print(json.dumps({**{f"{k}_seconds": v for k, v in seconds.items()},
                      "total": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
