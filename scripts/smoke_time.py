#!/usr/bin/env python3
"""Run the whole ``chip_smoke.py`` of several source trees, one after the
other, on one card, and time each command with this process's clock.

    python3 scripts/smoke_time.py --tree parent=PATH --tree change=PATH \
        [--order parent,change] [--out DIR]

Each turn is ``python3 chip_smoke.py --record DIR/<label>.json`` started
in its tree, its standard output to ``DIR/<label>.out`` and its log to
``DIR/<label>.log`` (``DIR`` defaults to ``chiprun_out``).  Prints, for
each turn, its label, exit code and wall seconds from its start to its
end, then one JSON line of them.  A failed turn ends the series (the
turns after it do not run) and the exit code is then non-zero.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True,
                    metavar="LABEL=PATH")
    ap.add_argument("--order", help="comma-separated labels, in turn "
                                    "(default: the trees' order)")
    ap.add_argument("--out", type=Path, default=Path("chiprun_out"))
    args = ap.parse_args()
    trees = dict(t.split("=", 1) for t in args.tree)
    order = args.order.split(",") if args.order else list(trees)
    out = args.out.resolve()
    out.mkdir(parents=True, exist_ok=True)
    turns = []
    for label in order:
        tree = Path(trees[label]).resolve()
        with open(out / f"{label}.out", "w") as so, \
                open(out / f"{label}.log", "w") as se:
            t0 = time.perf_counter()
            rc = subprocess.call(
                [sys.executable, "chip_smoke.py", "--record",
                 str(out / f"{label}.json")], cwd=tree, stdout=so,
                stderr=se)
            seconds = time.perf_counter() - t0
        turn = {"label": label, "rc": rc, "seconds": seconds}
        print(f"{label}: rc {rc}, {seconds:.1f} s", flush=True)
        turns.append(turn)
        if rc != 0:
            break
    print(json.dumps({"turns": turns}))
    return 0 if all(t["rc"] == 0 for t in turns) else 1


if __name__ == "__main__":
    sys.exit(main())
