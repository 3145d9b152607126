#!/usr/bin/env python3
"""Time variants of ``csrc/flash_attention.cu`` against each other on one
card, at the serve prefill.

    python3 scripts/flash_variants.py A.cu B.cu [...] [--rounds 2]
        [--timeout 100]

Each variant is a full copy of the source with one design change.  Each
is built with the repo's ``nvcc`` flags (its ``ptxas`` report and any
warning, such as C7518/C7520 wgmma serialization, is printed), then, in
its own process under ``--timeout`` seconds (a variant that deadlocks is
killed, not waited for), loaded in place of the built library, held
against ``attention_plain`` on small cases and at the serve prefill
(Yi-9B heads, batch 8 x 1024, causal: the two-ulp check's worst share of
its limit and mismatch share), and timed there (profiler device time and
event time of one call).  Variants run in turns, ``--rounds`` times.
Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SMALL = [(2, 200, 200, 8, 2, 64, True), (1, 77, 300, 4, 1, 128, False),
         (1, 130, 1, 4, 2, 128, True), (2, 64, 200, 4, 4, 64, True),
         (1, 300, 700, 8, 2, 128, True)]


def build(src: Path) -> Path:
    from repro_torch.kernels._build import NVCC_FLAGS, nvcc_path

    so = src.with_suffix(".so")
    p = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(so), str(src)],
                       capture_output=True, text=True)
    out = p.stdout + p.stderr
    keep = [ln for ln in out.splitlines() if any(
        w in ln.lower() for w in ("warn", "serializ", "error", "registers",
                                  "spill"))]
    print(f"{src.name}: nvcc exit {p.returncode}\n  " + "\n  ".join(keep),
          flush=True)
    if p.returncode:
        raise SystemExit(f"{src.name} did not build:\n{out[-3000:]}")
    return so


def measure(so: Path) -> None:
    import torch

    from chip_smoke import cuda_ms, device_ms
    from repro_torch.kernels.flash_attention import ops

    fn = getattr(ctypes.CDLL(str(so)), "flash_attention_launch")
    fn.argtypes, fn.restype = ops.KERNEL.argtypes, ctypes.c_int
    ops.KERNEL._fn = fn
    dev, bf = torch.device("cuda", 0), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(8)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(bf)

    err = 0.0
    for b, sq, sk, h, gg, d, causal in SMALL:
        q, k, v = rand(b, sq, h, d), rand(b, sk, gg, d), rand(b, sk, gg, d)
        err = max(err, (ops.flash_attention(q, k, v, causal=causal).float()
                        - ops.attention_plain(q, k, v, causal=causal)
                        .float()).abs().max().item())
    q, k, v = rand(8, 1024, 32, 128), rand(8, 1024, 4, 128), \
        rand(8, 1024, 4, 128)
    want = ops.attention_plain(q, k, v, causal=True).float()
    got = ops.flash_attention(q, k, v, causal=True).float()
    worst = ((got - want).abs() / (2 ** -6 * want.abs() + 1e-5)).max().item()
    mismatch = (got != want).float().mean().item()
    call = lambda: ops.flash_attention(q, k, v, causal=True)  # noqa: E731
    dms, _ = device_ms(torch, call, 20, "")
    ms = cuda_ms(call, 20, torch)
    print(f"{so.stem}: device {dms:.4f} ms, event {ms:.4f} ms, worst/limit "
          f"{worst:.3f}, mismatch {mismatch:.4f}, small cases max abs "
          f"{err:.3g}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=100)
    ap.add_argument("--measure", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        measure(args.measure)
        return 0
    libs = [build(v) for v in args.variants]
    failed = 0
    for _ in range(args.rounds):
        for so in libs:
            try:
                p = subprocess.run([sys.executable, __file__, "--measure",
                                    str(so)], timeout=args.timeout)
                failed += p.returncode != 0
            except subprocess.TimeoutExpired:
                print(f"{so.stem}: killed after {args.timeout} s (hang)",
                      flush=True)
                failed += 1
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
