#!/usr/bin/env python3
"""The flash_attention kernel's three routes on the card: build, check,
time.

    python3 scripts/flash_routes.py [--quick] [--json PATH]

Builds ``csrc/flash_attention.cu``, prints ``ptxas``'s report for each of
its kernels, holds every route (``prefill``, ``decode``, ``f32``, forced
through ``ops.launch``) against ``attention_plain`` over edge cases
(bf16 within 2e-2, float32 within 2e-5), then, unless ``--quick``, times
the prefill and the decode route on the same inputs across Sq (Yi-9B
heads: 32 query / 4 kv heads, D 128, batch 8, over Sq + 1024 keys,
non-causal) with CUDA events: the measurement behind
``ops.PREFILL_MIN_QUERIES``.  Needs one CUDA card; exits non-zero without
one or when a check fails.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
from chip_smoke import card_line, cuda_ms, device_ms  # noqa: E402

# (B, Sq, Sk, H, G, D, causal, route)
CASES = (
    (2, 128, 128, 8, 2, 128, True, "prefill"),
    (2, 200, 200, 8, 2, 64, True, "prefill"),
    (1, 77, 300, 4, 1, 128, False, "prefill"),
    (2, 64, 200, 4, 4, 64, True, "prefill"),
    (1, 130, 1, 4, 2, 128, True, "prefill"),
    (1, 1, 213, 8, 2, 128, False, "decode"),
    (2, 3, 4097, 32, 4, 128, False, "decode"),
    (2, 40, 100, 4, 1, 64, True, "decode"),
    (1, 7, 1, 4, 4, 64, False, "decode"),
    (2, 1, 1088, 32, 4, 128, False, "decode"),
    (2, 70, 70, 32, 1, 128, True, "f32"),
    (1, 1, 213, 8, 2, 64, False, "f32"),
)
SWEEP_SQ = (1, 2, 3, 4, 5, 6, 8, 16, 32, 64)


def host_us(torch, fn, reps=200):
    """Host microseconds per call of ``fn`` (launch overhead: no sync)."""
    import time

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    el = time.perf_counter() - t
    torch.cuda.synchronize()
    return el / reps * 1e6


def serve_shapes(torch, ops, dev, g, out):
    """The serve path's two calls: event time, device time and host time
    of the kernel beside SDPA's."""
    import torch.nn.functional as F

    bf = torch.bfloat16
    for name, sq, sk, causal in (("prefill", 1024, 1024, True),
                                 ("decode", 1, 1088, False)):
        q = torch.randn(8, sq, 32, 128, generator=g, device=dev).to(bf)
        cache = torch.randn(8, 1152, 2, 4, 128, generator=g,
                            device=dev).to(bf)
        k, v = cache[:, :sk, 0], cache[:, :sk, 1]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        fa = lambda: ops.flash_attention(q, k, v, causal=causal)  # noqa
        lib = lambda: F.scaled_dot_product_attention(  # noqa
            qt, kt, vt, is_causal=causal, enable_gqa=True)
        row = {"route": ops.pick_route(bf, sq),
               "ms": cuda_ms(fa, 20, torch),
               "device_ms": device_ms(torch, fa, 20, "")[0],
               "host_us": host_us(torch, fa),
               "sdpa_ms": cuda_ms(lib, 20, torch),
               "sdpa_device_ms": device_ms(torch, lib, 20, "")[0],
               "sdpa_host_us": host_us(torch, lib)}
        if name == "decode":   # the split length: CTAs aimed at per SM
            base = ops.DECODE_CTAS_PER_SM
            for cps in (1, 2, 4, 8):
                ops.DECODE_CTAS_PER_SM = cps
                row[f"device_ms_{cps}_ctas_per_sm"] = device_ms(
                    torch, fa, 20, "")[0]
            ops.DECODE_CTAS_PER_SM = base
        out[name] = row
        print(f"{name}: {row}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check only, no timing")
    ap.add_argument("--json", type=Path, help="write the readings here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_routes: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels._build import BUILDER
    from repro_torch.kernels.flash_attention import ops

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, cuda "
          f"{torch.version.cuda}", flush=True)
    BUILDER.build(["flash_attention"])
    print(BUILDER.logs.get("flash_attention", "(built before)"), flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    failed = 0
    for b, sq, sk, h, gg, d, causal, route in CASES:
        dt = torch.float32 if route == "f32" else torch.bfloat16
        q = torch.randn(b, sq, h, d, generator=g, device=dev).to(dt)
        cache = torch.randn(b, sk + 5, 2, gg, d, generator=g,
                            device=dev).to(dt)
        k, v = cache[:, :sk, 0], cache[:, :sk, 1]
        before = ops.KERNEL.launches
        got = ops.launch(q, k, v, causal, route)
        torch.cuda.synchronize()
        want = ops.attention_plain(q, k, v, causal=causal)
        err = (got.float() - want.float()).abs().max().item()
        tol = 2e-5 if route == "f32" else 2e-2
        ok = err <= tol and ops.KERNEL.launches == before + 1
        failed += not ok
        print(f"{route:8s} B{b} Sq{sq} Sk{sk} H{h} G{gg} D{d} "
              f"causal={causal}: max abs {err:.3g} "
              f"{'ok' if ok else 'FAILED'}", flush=True)
    out = {"card": card, "failed": failed, "sweep": []}
    if not args.quick and not failed:
        b, h, gg, d = 8, 32, 4, 128
        for sq in SWEEP_SQ:
            sk = sq + 1024
            q = torch.randn(b, sq, h, d, generator=g, device=dev).to(
                torch.bfloat16)
            k = torch.randn(b, sk, gg, d, generator=g, device=dev).to(
                torch.bfloat16)
            v = torch.randn(b, sk, gg, d, generator=g, device=dev).to(
                torch.bfloat16)
            row = {"sq": sq, "sk": sk}
            for route in ("decode", "prefill", "prefill", "decode"):
                ms = device_ms(torch, lambda: ops.launch(q, k, v, False,
                                                         route), 20, "")[0]
                row.setdefault(route, []).append(ms)
            row = {**row, **{r: min(row[r]) for r in ("decode", "prefill")}}
            out["sweep"].append(row)
            print(f"Sq {sq:4d} over {sk} keys, device ms: decode "
                  f"{row['decode']:.4f}, prefill {row['prefill']:.4f}",
                  flush=True)
    if not failed:
        serve_shapes(torch, ops, dev, g, out)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(out, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
