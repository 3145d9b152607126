#!/usr/bin/env python3
"""What tracing decode steps with ``torch.profiler`` costs, with and
without the host's events, on the card: the measurement behind
``chip_smoke.py``'s device-only traces (``_decode_profile``,
``device_ms``).

    python3 scripts/trace_cost.py [--archs yi-9b,zamba2-2.7b] [--steps 2,4]

For each architecture at full width and depth, on random bf16 weights,
it prefills batch 8 x 1024 tokens and then traces ``--steps`` decode
steps twice: with host and device activity (``CPU``, ``CUDA``) and with
the device's alone (``CUDA``).  Prints one JSON line per architecture:
for each trace, the seconds of the traced steps (``trace_s``), the
seconds ``prof.events()`` takes to list them (``events_s``), the
device's busy milliseconds and kernels per step, and the host's kernel
launch calls per step as the trace lists them (``launch_calls_per_step``,
what ``chip_smoke.py``'s train step profile counts).  Needs one CUDA
card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--archs", default="yi-9b,zamba2-2.7b")
    ap.add_argument("--steps", default="2,4")
    args = ap.parse_args()
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("trace_cost: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels._build import BUILDER
    from repro_torch.models import build_model

    BUILDER.build(["flash_attention", "ssd_scan"])
    dev = torch.device("cuda", 0)
    traces = {"cpu_cuda": [ProfilerActivity.CPU, ProfilerActivity.CUDA],
              "cuda": [ProfilerActivity.CUDA]}
    for arch in args.archs.split(","):
        cfg = get_config(arch)
        model = build_model(cfg)
        params = model.init(0, dev, dtype=torch.bfloat16)
        toks = torch.from_numpy(np.random.RandomState(0).randint(
            0, cfg.vocab_size, (8, 1025)).astype(np.int32)).to(dev)
        _, cache = model.prefill(params, {"tokens": toks[:, :-1]},
                                 cache_len=1024 + 8)
        out = {"arch": arch, "device": torch.cuda.get_device_name(0)}
        for name, acts in traces.items():
            for n in (int(x) for x in args.steps.split(",")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with profile(activities=acts) as prof:
                    for i in range(n):
                        model.decode_step(params, cache, {
                            "tokens": toks[:, -1:], "pos": 1024 + i % 4})
                    torch.cuda.synchronize()
                t1 = time.perf_counter()
                busy_us, kernels, launches = 0.0, 0, 0
                for e in prof.events():
                    if e.device_type == DeviceType.CUDA:
                        busy_us += e.time_range.elapsed_us()
                        kernels += 1
                    elif e.name in LAUNCH_CALLS:
                        launches += 1
                out[f"{name}_{n}"] = {
                    "trace_s": t1 - t0,
                    "events_s": time.perf_counter() - t1,
                    "busy_ms_per_step": busy_us / 1e3 / n,
                    "kernels_per_step": kernels / n,
                    "launch_calls_per_step": launches / n}
        print(json.dumps(out), flush=True)
        del params, cache
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
