#!/usr/bin/env python3
"""The streaming restore and the process IO workers of the port on the
card, without the rest of ``chip_smoke.py``: its phase 3a (the store and
the reference 3j reads) and then its phase 3j, timed.

    python3 scripts/io_probe.py [--json PATH] [--card-tests [-k EXPR]]

Builds the kernels, runs ``chip_smoke.phase_3a``, records its step-2 and
step-4 entry digests (as ``chip_smoke.main`` does), runs
``chip_smoke.phase_3j`` on 3a's store (its checks included) and removes
the store, then, with ``--card-tests``, the card-only tests
(``pytest -m cuda tests/test_torch_cuda.py``, ``-k`` passed on).  Prints
each phase's wall time, the card line and a JSON line ``{"3j_seconds":
..., "total": ...}``; ``--json`` writes the record of both phases.  Needs
one CUDA card; exits non-zero without one, when a check fails, or when a
card test fails.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
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
    ap.add_argument("--card-tests", action="store_true",
                    help="also run the card-only tests")
    ap.add_argument("-k", dest="select",
                    help="with --card-tests: pytest's -k expression")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        cs.log("io_probe: no CUDA device available")
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
    store = ROOT / "build" / "io_probe_store"
    shutil.rmtree(store, ignore_errors=True)
    store.mkdir(parents=True)
    mp = {"3a": {}, "3j": {}}
    try:
        cs.phase_3a(torch, dev, store / "3a", mp["3a"])
        mp["3a"]["entry_digests"] = {
            str(s): {f"{u}/{k}": d for (u, k), d in
                     cs._entry_digests(store / "3a" / "run", s).items()}
            for s in (2, 4)}
        cs.log(f"3a done at {time.perf_counter() - t0:.1f} s")
        cs.phase_3j(torch, dev, store, mp["3a"], mp["3j"])
        cs.log(f"3j done at {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(store, ignore_errors=True)
        cs.write_record({"card": card, "main_path": mp}, args.json)
    rc = 0
    if args.card_tests:
        rc = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-m", "cuda",
             "tests/test_torch_cuda.py", "-p", "no:cacheprovider"]
            + (["-k", args.select] if args.select else []),
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        ).returncode
    print(card)
    print(json.dumps({"3j_seconds": mp["3j"]["seconds"],
                      "total": time.perf_counter() - t0}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
