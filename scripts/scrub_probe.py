#!/usr/bin/env python3
"""The store scrub of the port on the card, without the rest of
``chip_smoke.py``: its phase 3a (the store the scrub walks) and then its
phase 3l, timed.

    python3 scripts/scrub_probe.py [--json PATH] [--alloc-ab] [--split]
        [--card-tests]

Builds the kernels, runs ``chip_smoke.phase_3a`` and then
``chip_smoke.phase_3l`` on 3a's store (its checks included).  With
``--alloc-ab``, before 3l, audits of 3a's store in turns, each a fresh
``StoreScrubber(repair=False)`` on the card: the tier copies read into
pinned or pageable host memory, on 4 or 8 threads (each audit's seconds
and ``block_fp`` launches printed, every audit all healthy).  With
``--split``, audits on 2, 4 and 8 threads with pinned reads, their
seconds split by stage (pinned allocation, file read, decode and crc32s,
placement on the card, table check) summed over the threads.  Then, with
``--card-tests``, the card-only tests (``pytest -m cuda
tests/test_torch_cuda.py``).  Prints each phase's wall time, the card line
and a JSON line ``{"3l_seconds": ..., "total": ...}``; ``--json`` writes
the record of both phases.  Needs one CUDA card; exits non-zero without
one, when a check fails, or when a card test fails.
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


def alloc_ab(torch, dev, run: Path) -> list:
    """Audits of ``run`` in turns: (read into, threads) pinned 8, pageable
    8, pageable 4, pageable 4, pageable 8, pinned 8."""
    from repro_torch.checkpoint.chunk_store import ChunkStore
    from repro_torch.checkpoint.restore import host_buffer_alloc
    from repro_torch.checkpoint.scrub import StoreScrubber
    from repro_torch.kernels import block_fp

    turns = []
    for alloc, threads in (("pinned", 8), ("pageable", 8), ("pageable", 4),
                           ("pageable", 4), ("pageable", 8), ("pinned", 8)):
        cs._release(torch)
        store = ChunkStore(run)
        scrubber = StoreScrubber(store, device=dev)
        scrubber.threads = threads
        if alloc == "pinned":
            scrubber._alloc = host_buffer_alloc(dev)
        block_fp.KERNEL.launches = 0
        t = time.perf_counter()
        rep = scrubber.scrub(repair=False)
        torch.cuda.synchronize()
        turn = {"alloc": alloc, "threads": threads,
                "seconds": time.perf_counter() - t,
                "block_fp": block_fp.KERNEL.launches,
                "healthy": rep["healthy"],
                "checked": rep["checked_objects"]}
        store.close()
        cs.log(f"audit {turn}")
        if rep["healthy"] != rep["checked_objects"]:
            raise AssertionError(f"alloc_ab: {rep}")
        turns.append(turn)
    return turns


def audit_split(torch, dev, run: Path) -> list:
    """Audits of ``run`` with pinned reads on 2, 4 and 8 threads, each
    with its seconds split by stage, summed over the threads: the pinned
    allocation, the file read, the record decode and crc32s, the
    placement on the card (device allocation and H2D) and the table check
    (``block_fp``, the copy back, the compare)."""
    import threading

    from repro_torch.checkpoint import restore, workers
    from repro_torch.checkpoint.backends.localfs import LocalFSBackend
    from repro_torch.checkpoint.chunk_store import ChunkStore
    from repro_torch.checkpoint.scrub import StoreScrubber

    lock = threading.Lock()
    split = {}

    def timed(name, fn):
        def wrapper(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                with lock:
                    split[name] = split.get(name, 0.0) \
                        + time.perf_counter() - t
        return wrapper

    plain = {"read_into": LocalFSBackend.read_into,
             "decode": workers.decode_chunk_items,
             "place": restore.place_items,
             "check": restore.verify_placed}
    LocalFSBackend.read_into = timed("read", plain["read_into"])
    workers.decode_chunk_items = timed("decode", plain["decode"])
    restore.place_items = timed("place", plain["place"])
    restore.verify_placed = timed("check", plain["check"])
    turns = []
    try:
        for threads in (2, 4, 8, 4):
            cs._release(torch)
            split.clear()
            store = ChunkStore(run)
            scrubber = StoreScrubber(store, device=dev)
            scrubber.threads = threads
            scrubber._alloc = timed("alloc", restore.host_buffer_alloc(dev))
            t = time.perf_counter()
            rep = scrubber.scrub(repair=False)
            torch.cuda.synchronize()
            turn = {"threads": threads, "seconds": time.perf_counter() - t,
                    "healthy": rep["healthy"],
                    "split": dict(split)}
            store.close()
            cs.log(f"split {turn}")
            turns.append(turn)
    finally:
        LocalFSBackend.read_into = plain["read_into"]
        workers.decode_chunk_items = plain["decode"]
        restore.place_items = plain["place"]
        restore.verify_placed = plain["check"]
    return turns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", type=Path, help="write the record here")
    ap.add_argument("--card-tests", action="store_true",
                    help="also run the card-only tests")
    ap.add_argument("--split", action="store_true",
                    help="time audits on 2, 4 and 8 threads by stage, "
                         "before 3l")
    ap.add_argument("--alloc-ab", action="store_true",
                    help="time audits with pinned or pageable reads, 4 or "
                         "8 threads, in turns, before 3l")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        cs.log("scrub_probe: no CUDA device available")
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
    store = ROOT / "build" / "scrub_probe_store"
    shutil.rmtree(store, ignore_errors=True)
    store.mkdir(parents=True)
    mp = {"3a": {}, "3l": {}}
    try:
        cs.phase_3a(torch, dev, store / "3a", mp["3a"])
        cs.log(f"3a done at {time.perf_counter() - t0:.1f} s")
        if args.alloc_ab:
            mp["alloc_ab"] = alloc_ab(torch, dev, store / "3a" / "run")
        if args.split:
            mp["split"] = audit_split(torch, dev, store / "3a" / "run")
        cs.phase_3l(torch, dev, store, mp["3l"])
        cs.log(f"3l done at {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(store, ignore_errors=True)
        cs.write_record({"card": card, "main_path": mp}, args.json)
    rc = 0
    if args.card_tests:
        rc = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-m", "cuda",
             "tests/test_torch_cuda.py", "-p", "no:cacheprovider"],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        ).returncode
    print(card)
    print(json.dumps({"3l_seconds": mp["3l"]["seconds"],
                      "3l_a_seconds": mp["3l"]["a"]["seconds"],
                      "3l_b_seconds": mp["3l"]["b"]["seconds"],
                      "total": time.perf_counter() - t0}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
