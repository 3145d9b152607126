#!/usr/bin/env python3
"""The int8 quantize kernel of the port on the card against an earlier
``quantize.cu``, in turns, at the main path's shapes.

    python3 scripts/quantize_probe.py --old OLD.cu [--repeat N]
        [--order old,new,new,old] [--reps R] [--json PATH]
        [--card-tests [-k EXPR]]

``OLD.cu`` is a ``quantize.cu`` with the warp-per-block kernel's
interface (a 48-byte leaf row without a first stage; ``git show
<commit>:src/repro_torch/kernels/csrc/quantize.cu`` of a commit before
the bulk-copy kernel): it is built with the repo's ``nvcc`` flags and
driven through that interface's host half (a slice and two views per
leaf, a ctypes row each), copied below.

Builds the kernels and prints each one's ``ptxas`` report; holds the
current kernel against its plain version over ``chip_smoke``'s edge
cases; then, at a full-width Yi-9B block's optimizer unit (27 f32 leaves)
and weights unit (9 bf16 leaves), holds every label's records against the
plain version's bit for bit in each of ``--repeat`` launches (a race
shows in some launches only: it counts those that differ), and times each
label in the turns of ``--order``: event ms of one wrapper call (host
work and device time, as ``chip_smoke.py`` times it), profiler device
ms, and host us of the wrapper up to its launch; then ``dequantize`` of
the optimizer unit's records (old through the old host half).  With ``--card-tests`` it then runs the
card-only tests (``pytest -m cuda tests/test_torch_cuda.py``, ``-k``
passed on).  Prints the card line, a JSON line of the differing launches
and one of the turns; ``--json`` writes the full record.  Needs one CUDA
card; exits non-zero without one, when a check fails, or when a card test
fails.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import quantize as qz  # noqa: E402
from repro_torch.kernels.quantize import ops  # noqa: E402

PROBE_BUILD = ROOT / "build" / "quantize_probe"


class _OldLeaf(ctypes.Structure):
    """The warp-per-block kernel's ``QuantLeaf``: no first stage."""
    _fields_ = [("x", ctypes.c_void_p), ("q", ctypes.c_void_p),
                ("s", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("first_block", ctypes.c_longlong), ("dtype", ctypes.c_int),
                ("pad", ctypes.c_int)]


class ExternalKernel:
    """A C entry point of a library built from a source outside
    ``csrc/``; ``launch`` raises on a launch error and counts launches,
    as ``CudaKernel`` does."""

    def __init__(self, lib: ctypes.CDLL, fn: str, argtypes: list):
        self._fn = getattr(lib, fn)
        self._fn.argtypes = argtypes
        self._fn.restype = ctypes.c_int
        self.fn_name = fn
        self.launches = 0

    def launch(self, *args) -> None:
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.fn_name} launch failed: cudaError "
                               f"{err}")
        self.launches += 1


def build(src: Path) -> tuple:
    """(library, nvcc's output) of ``src`` with the repo's flags."""
    from repro_torch.kernels._build import CSRC, NVCC_FLAGS, nvcc_path

    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    so = PROBE_BUILD / f"{src.stem}-{digest}.so"
    PROBE_BUILD.mkdir(parents=True, exist_ok=True)
    p = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o",
                        str(so), str(src)], capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{p.stdout}{p.stderr}")
    return ctypes.CDLL(str(so)), p.stdout + p.stderr


# ---- the old host half (quantize/ops.py before its leaf tables came from
# integer offsets),
# float32/bfloat16 leaves on the card
def _old_launch(kernel, rows) -> None:
    """One launch per MAX_LEAVES of (leaf, q, scales) rows."""
    dev = rows[0][0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for lo in range(0, len(rows), ops.MAX_LEAVES):
            chunk = rows[lo:lo + ops.MAX_LEAVES]
            table = (_OldLeaf * len(chunk))()
            first = 0
            for j, (x, q, s) in enumerate(chunk):
                table[j] = _OldLeaf(x.data_ptr(), q.data_ptr(),
                                    s.data_ptr(), x.numel(), first,
                                    ops._KERNEL_DTYPES[x.dtype], 0)
                first += ops.n_quant_blocks(x.numel())
            kernel.launch(table, len(chunk), first, stream)


def old_quantize_unit(kernel, leaves):
    if not leaves:
        raise ValueError("quantize_unit needs at least one tensor")
    dev = ops._device_of(leaves, "quantize")
    offsets, sizes, total = [], [], 0
    for x in leaves:
        offsets.append(total)
        sizes.append(x.numel())
        total += -(-ops.record_nbytes(x.numel()) // 16) * 16
    unit = ops.QuantizedUnit(torch.empty(max(total, 1), dtype=torch.uint8,
                                         device=dev), offsets, sizes)
    rows = []
    for i, x in enumerate(leaves):
        if x.numel() == 0:
            continue
        x = x.detach()
        if x.dtype not in ops._KERNEL_DTYPES:
            x = x.to(torch.float32)
        if not x.is_contiguous():
            raise ValueError("the quantize kernel needs contiguous leaves")
        rows.append((x, unit.q(i), unit.scales(i)))
    if rows:
        _old_launch(kernel, rows)
    return unit


def old_dequantize_unit(kernel, records, dsts) -> None:
    if len(records) != len(dsts) or not dsts:
        raise ValueError("dequantize_unit needs one record per leaf")
    ops._device_of([*dsts, *[t for r in records for t in r]], "dequantize")
    for (q, s), dst in zip(records, dsts):
        nb = ops.n_quant_blocks(dst.numel())
        if (q.dtype != torch.int8 or s.dtype != torch.float32
                or q.numel() != nb * ops.QUANT_BLOCK or s.numel() != nb):
            raise ValueError("an int8 record does not fit its leaf")
        if not dst.is_contiguous():
            raise ValueError("dequantize writes contiguous leaves")
    rows = []
    for (q, s), dst in zip(records, dsts):
        if dst.numel() == 0:
            continue
        if not (q.is_contiguous() and s.is_contiguous()):
            raise ValueError("the dequantize kernel needs contiguous q and "
                             "scales")
        rows.append((dst, q, s))
    if rows:
        _old_launch(kernel, rows)


def _records_equal(got, want) -> bool:
    return all(torch.equal(got.q(i), q)
               and cs._scales_equal(torch, got.scales(i), s)
               for i, (q, s) in enumerate(want))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="a quantize.cu with the warp-per-block interface")
    ap.add_argument("--order", default="old,new,new,old",
                    help="labels in turn: old, new")
    ap.add_argument("--repeat", type=int, default=1,
                    help="launches of each label held bitwise against the "
                         "plain version at each unit (a race shows in some "
                         "launches only)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--json", type=Path, help="write the record here")
    ap.add_argument("--card-tests", action="store_true",
                    help="also run the card-only tests")
    ap.add_argument("-k", dest="select",
                    help="with --card-tests: pytest's -k expression")
    args = ap.parse_args()
    order = args.order.split(",")
    if not set(order) <= {"old", "new"}:
        ap.error("--order takes the labels old and new")
    if not torch.cuda.is_available():
        cs.log("quantize_probe: no CUDA device available")
        return 2
    from repro_torch.kernels._build import BUILDER

    t0 = time.perf_counter()
    card = cs.card_line()
    cs.log(f"card: {card}")
    dev = torch.device("cuda", 0)
    BUILDER.build(["quantize"])
    record = {"card": card, "ptxas": {
        "new": cs.ptxas_report(BUILDER.logs["quantize"])}}
    old_lib, log = build(args.old)
    record["ptxas"]["old"] = cs.ptxas_report(log)
    old_q = ExternalKernel(old_lib, "quantize_launch",
                           [ctypes.POINTER(_OldLeaf), ctypes.c_int,
                            ctypes.c_longlong, ctypes.c_void_p])
    old_d = ExternalKernel(old_lib, "dequantize_launch", old_q._fn.argtypes)
    kernels = {"old": (old_q, old_d), "new": (qz.QUANTIZE, qz.DEQUANTIZE)}
    for label, rep in record["ptxas"].items():
        cs.log(f"ptxas {label}: {json.dumps(rep)}")

    cs.check_quantize_cases(torch, dev)

    def quant_fn(label, unit):
        if label == "old":
            return lambda: old_quantize_unit(old_q, unit)
        return lambda: qz.quantize_unit(unit)

    def deq_fn(label, recs, outs):
        if label == "old":
            return lambda: old_dequantize_unit(old_d, recs, outs)
        return lambda: qz.dequantize_unit(recs, outs)

    params, master, m, v, grads = cs.yi_block_unit(torch, dev, seed=4)
    del grads
    units = {"opt": master + m + v, "weights": params}
    del master, m, v
    turns, record["bad_launches"] = [], {}
    try:
        for name, unit in units.items():
            want = [qz.quantize_plain(x) for x in unit]
            for label in kernels:
                bad = 0
                for _ in range(args.repeat):
                    got = quant_fn(label, unit)()
                    torch.cuda.synchronize()
                    bad += not _records_equal(got, want)
                    del got
                record["bad_launches"][f"{label}/{name}"] = [bad, args.repeat]
                cs.log(f"quantize {label} at the {name} unit: {bad} of "
                       f"{args.repeat} launches differ from the plain version")
                if bad:
                    raise AssertionError(f"quantize {label} differs from the "
                                         f"plain version at the {name} unit")
            del want
            for label in order:
                fn = quant_fn(label, unit)
                kern = kernels[label][0]
                ev = cs.cuda_ms(fn, args.reps, torch)
                dms, per_call = cs.device_ms(torch, fn, args.reps, "quant")
                turns.append({"kernel": "quantize", "unit": name,
                              "label": label, "ms": ev, "device_ms": dms,
                              "kernels_per_call": per_call,
                              "host_us": cs.host_us(fn, kern, 50)})
                cs.log(f"quantize {name} {label}: {json.dumps(turns[-1])}")
        unit = units["opt"]
        got = qz.quantize_unit(unit)
        recs = [(got.q(i), got.scales(i)) for i in range(len(unit))]
        outs = [torch.empty_like(x) for x in unit]
        for label in order:
            fn = deq_fn(label, recs, outs)
            fn()
            torch.cuda.synchronize()
            for (q, s), o in zip(recs, outs):
                if not torch.equal(o.view(-1), qz.dequantize_plain(
                        q, s, o.numel(), o.dtype)):
                    raise AssertionError(f"dequantize {label} differs from "
                                         "the plain version")
            kern = kernels[label][1]
            ev = cs.cuda_ms(fn, args.reps, torch)
            dms, per_call = cs.device_ms(torch, fn, args.reps, "quant")
            turns.append({"kernel": "dequantize", "unit": "opt",
                          "label": label, "ms": ev, "device_ms": dms,
                          "kernels_per_call": per_call,
                          "host_us": cs.host_us(fn, kern, 50)})
            cs.log(f"dequantize opt {label}: {json.dumps(turns[-1])}")
    finally:
        record["turns"] = turns
        cs.write_record(record, args.json)
    summary = {}
    for t in turns:
        key = f"{t['kernel']}/{t['unit']}/{t['label']}"
        summary.setdefault(key, []).append(
            [t["ms"], t["device_ms"], t["host_us"]])
    rc = 0
    if args.card_tests:
        rc = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-m", "cuda",
             "tests/test_torch_cuda.py", "-p", "no:cacheprovider"]
            + (["-k", args.select] if args.select else []),
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        ).returncode
    print(card)
    print(json.dumps({"bad_launches": record["bad_launches"]}))
    print(json.dumps({"quantize_probe": {
        k: {"ms": statistics.median(r[0] for r in rows),
            "device_ms": statistics.median(r[1] for r in rows
                                           if r[1] is not None)
            if any(r[1] is not None for r in rows) else None,
            "host_us": statistics.median(r[2] for r in rows),
            "turns": rows} for k, rows in summary.items()},
        "total_s": time.perf_counter() - t0}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
