#!/usr/bin/env python3
"""The shard-native saves of the port on the card, without the rest of
``chip_smoke.py``: its phase 3a (the resumed losses and step-4 entry
digests 3n is held to) and, with 3a's store removed, its phase 3n as
``chip_smoke.py`` runs it, timed.

    python3 scripts/sharded_probe.py [--json PATH]

Builds the kernels, then runs ``chip_smoke.phase_3a`` and
``chip_smoke.phase_3n``, each with its checks.  Prints each phase's wall
time, the ``{"sharded": ...}`` line, the card line and a JSON line of the
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
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        cs.log("sharded_probe: no CUDA device available")
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
    store = ROOT / "build" / "sharded_probe_store"
    shutil.rmtree(store, ignore_errors=True)
    store.mkdir(parents=True)
    cs.log(f"{shutil.disk_usage(store).free / 1e9:.1f} GB free under "
           f"{store}")
    mp = {"3a": {}, "3n": {}}
    seconds = {}
    try:
        t = time.perf_counter()
        cs.phase_3a(torch, dev, store / "3a", mp["3a"])
        seconds["3a"] = time.perf_counter() - t
        mp["3a"]["entry_digests"] = {"4": {
            f"{u}/{k}": d for (u, k), d in
            cs._entry_digests(store / "3a" / "run", 4).items()}}
        shutil.rmtree(store / "3a")
        t = time.perf_counter()
        cs.phase_3n(torch, dev, store, mp["3a"], mp["3n"])
        seconds["3n"] = time.perf_counter() - t
        cs.log(f"{shutil.disk_usage(store).free / 1e9:.1f} GB free under "
               f"{store} after 3n")
    finally:
        cs.REMOVER.drain()
        shutil.rmtree(store, ignore_errors=True)
        shutil.rmtree(cs.TRASH, ignore_errors=True)
        cs.write_record({"card": card, "main_path": mp,
                         "seconds": seconds}, args.json)
    print(json.dumps({"sharded": cs.sharded_summary(mp["3n"])
                      | {"card": card}}))
    print(card)
    print(json.dumps({**{f"{k}_seconds": v for k, v in seconds.items()},
                      "total": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
