#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--record PATH]

Needs one CUDA card (an H100: the kernels build for sm_90a) and the CUDA
toolkit's ``nvcc``; exits non-zero without them.  Phases, any failure of
which exits non-zero:

1. print the card's name and power limit; build the six CUDA kernel
   libraries from the sources in this checkout (one ``nvcc`` each,
   concurrently);
2. hold each kernel against its plain PyTorch version on the card:
   ``block_fp`` over every dtype it takes with ragged tails and a
   misaligned leaf (fingerprint pairs bit-exact, also against the host
   oracle; two launches give bitwise-equal sums of squares within rtol of
   the plain version); ``block_gather`` over the same dtypes, an empty
   leaf, a clean leaf, a leaf with no reference and an overflowing
   capacity (pairs, indices, block bytes and counts bit-exact against the
   plain version and the host oracle); then ``block_fp`` and
   ``fused_adamw`` at the main path's shapes (a full-width Yi-9B block's
   optimizer unit and its leaves), timed with CUDA events;
   ``flash_attention`` over causal (Sq == Sk and the top-left Sq < Sk),
   non-causal, ragged-Sk, G = H, G = 1, bf16/float32, D 64/128 cases, a
   decode step on a strided cache view, and cases at the edges of its
   three routes (bf16 prefill on tensor cores, bf16 split-K decode,
   float32): Sq on either side of ``ops.PREFILL_MIN_QUERIES``, causal and
   not, D 64, G = 1, G = H, Sk = 1 and 4097 (every route must be reached);
   then timed beside its plain version and SDPA (event time of one call,
   profiler device time, kernels per call) at the serve path's prefill and
   decode shapes, each on the route the wrapper picks, and the float32
   route at the prefill shape; both bf16 shapes under the two-ulp check
   below, SDPA recorded under it as a control; ``ptxas``'s registers and
   spills of every flash kernel recorded;
   ``ssd_scan`` over full, ragged-S, odd-Q, S < Q, G = 1, G = 2 and G = H
   cases in bf16 and float32 through the wrapper (the f32 route, CUDA
   cores), the bf16 cases also on the bf16 route (tensor cores), on
   model-style strided views and contiguous inputs (two launches bitwise
   equal), then both routes at the Mamba2-370m serve prefill shape under
   the two-ulp check, with the plain version rounding its decayed scores
   to bf16 as a control the check must reject, and the wrapper timed
   beside its plain version; both routes timed on the same bf16 inputs
   (event and device time, kernels per call, device time by kernel) there
   and at batch 1 x 4096, with the bf16 route's scratch bytes and
   ``ptxas``'s registers and spills; ``quantize`` and
   ``dequantize`` (one source) bitwise against their plain versions over
   n in {1, 255, 256, 257, 64*256+3}, f32 and bf16, and blocks of zeros,
   half-way ties, the clip edge, denormals, an underflowing scale, NaN and
   Inf (scales only there), then at the main path's shapes (a Yi-9B
   block's optimizer unit, 27 f32 leaves, and its weights unit, 9 bf16
   leaves), timed;
3. the main paths, Yi-9B at full width cut to 2 layers, batch 2, seq 1024,
   through ``repro_torch.launch.train.train``, each with the launch
   counts set to 0 just before it and read just after:
   a. synchronous saves (policy parity, checkpoint every 2 steps, inline
      writes): an 8-step reference run without saves, a checkpointed run
      that fails at step 5, and its resume to step 6;
   b. overlapped saves (policy topk_delta, checkpoint every 2 steps, each
      event spread over the next 2 steps, async writer): a run of 8 steps
      that fails at step 7 with the step-6 event in flight, and its resume
      to step 8; before it, as its control, the same run with synchronous
      saves failing at step 5, resumed to step 8;
   checks for both: finite losses; resumed losses within LOSS_TOL of the
   reference (LATE_LOSS_TOL at steps 7-8); the step-4 manifest merges units
   of two events (and is LATEST after b's failure); after a restore, every
   unit's device fingerprints equal the tables stored in its objects; an
   unchanged re-save moves 0 bytes; every kernel of the path was launched;
   for b also: its step-2 and step-4 manifests equal the control's, and
   its resumed losses the control's within MODE_TOL.  Then
   ``block_gather`` is timed at the main path's shape, the Yi-9B embed
   optimizer unit, with b's step-2 tables as the reference and its step-4
   state as the input (the dirty pattern training makes), and at 0% and
   100% dirty;
   c. the reduced config, 4 KiB blocks: the five-event chain (full base,
      clean re-save, dense, sparse and scattered drift) saved once
      synchronously and twice overlapped, with the dirty-block predictor
      pinned at 1 and at 2^20 blocks and every state tensor overwritten in
      place on the compute stream right after ``begin``: all three commit
      the same manifests and objects; and the chain saved sync and
      overlapped with ``codec="int8"`` (quantized at ``begin``), which
      must commit the same manifests and objects, all full;
   d. serving, through ``repro_torch.launch.serve.serve``: (store) on b's
      store before it is removed, a weights-only cold load of step 4 that
      opens no optimizer object, a hot-swap to LATEST bit-identical to a
      cold load of it, a hot-swapped and a cold-loaded server generating
      the same tokens, and a constructed drift of a few 64 KiB blocks that
      takes the scatter path; (serve) Yi-9B at full width and full depth
      on random bf16 weights, batch 8, 1024-token prompts, 128 new tokens:
      every prefill and decode attention launches ``flash_attention`` and
      one decode step matches the prefill of the longer prompt;
   e. Mamba2-370m at full width and full depth (48 layers), batch 4, seq
      1024: an 8-step reference run, an overlapped topk_delta run (every 2
      steps, spread 2, 2 writer threads) that fails at step 7 with event 6
      in flight and its resume to step 8, under the checks of 3a/3b; from
      that store a weights-only cold load of step 4, a hot-swap to LATEST
      bit-identical to a cold load and hot vs cold ``tokens_digest``; then
      serving on random weights, batch 8, 1024-token prompts, 128 new
      tokens, with exactly 48 ``ssd_scan`` launches in the prefill and one
      decode step matching the prefill of the longer prompt;
   f. the int8 codec, as 3a (Yi-9B, parity, sync inline saves) with
      ``codec="int8"``: a run that fails at step 5 and its resume to step
      8, its losses held against 3a's uninterrupted run (the first resumed
      step, the restored merge, within INT8_LOSS_BAND; the later ones
      recorded against it); (a) event 2's block_000 objects equal byte for
      byte those the CPU path writes from the same unit (replayed to step
      2) copied to the host; (b) event 2's device->host and written bytes
      beside 3a's (below 0.35 of them); (c) after a restore every leaf
      equals ``dequantize_plain`` of its stored record; (d) every entry is
      a full object (no deltas) and a second re-save of the restored state
      moves 0 bytes; (f) a weights-only cold load of step 4 and a swap to
      6, bit-identical to a cold load of 6; quantize and dequantize
      launched;
4. print the main paths' step/save/restore times, the serve line, the
   Mamba line, the int8 line, the kernels line, the card line, and last
   the ``{"ok": true, "device": ...}`` line; each phase logs its wall
   time; with ``--record PATH``, the full record of every phase also goes
   to PATH (written even when a check fails).

The stores live under ``build/`` in this checkout and are removed at the
end.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Main path
ARCH = "yi-9b"
REDUCED = False
NUM_LAYERS = 2
BATCH = 2
SEQ = 1024
REF_STEPS = 8           # warmup is 20 steps: steps 1-8 share their lr
STEPS = 6               # phase 3a
FAIL_AT = 5
OV_STEPS = 8            # phase 3b
OV_FAIL_AT = 7
SPREAD = 2
CKPT_INTERVAL = 2
SEED = 0
# Resumed losses vs the uninterrupted run: the resume restores a
# Frankenstein merge (some units two steps stale), so the losses differ by
# the drift of two warmup steps (lr <= 1.5e-4); 0.02 nat is ~0.2% of the
# ~11.5 nat loss of a random Yi-9B.
LOSS_TOL = 0.02
# Phase 3b trains on to step 8: at steps 7-8 the lr reaches 4e-4 and the
# stale block's weights, m and v lag two updates, so the merge drifts
# further (0.026 nat at step 8 on an H100, see PERF.md).  The sharper
# check of 3b is MODE_TOL: a run with synchronous saves makes the same
# decisions, commits the same step-4 manifest and, resumed from it, must
# give the same losses up to the run-to-run noise of the step.
LATE_LOSS_TOL = 0.05
MODE_TOL = 1e-3
# Phase 3d: one decode step against the prefilled cache vs the prefill of
# the longer prompt, the bound of tests/test_models_consistency.py.
DECODE_TOL = 0.06
# Phase 3e, Mamba2-370m at full width: the bf16 gap grows with depth in
# the JAX package itself.  On one set of weights and tokens (batch 8 x
# 1024, scripts/mamba_decode_gap.py, CPU) the JAX MambaLM reads 0.031,
# 0.058 and 0.064 at 4, 12 and 24 layers, past DECODE_TOL (set on 4-layer
# reduced configs), and the port 0.037, 0.053 and 0.064.  Held to 0.1, the
# JAX package's bound for five chained decode steps: a decode step that
# loses or shifts the conv window gives ~3.7, one that halves the state
# 0.15 (4 layers, the same script's weights).
DECODE_SSM_TOL = 0.1
# ... and the same comparison computing in float32 (float32 weights and
# activations, the ssd_scan kernel's float32 path), which takes bf16
# rounding out of it: far above float32 rounding (~1e-5).
DECODE_F32_TOL = 1e-3
# ... and the bf16 prefill (ssd_scan in every layer) against the training
# path (the plain chunked scan) on the longer prompt.  The wrapper's f32
# route sums in the plain version's order, so its y equals the plain
# version's bit for bit and the logits agree to ~1.5e-6 at 4 to 48 layers.
# The bf16 route (tensor cores) sums in another order: its y rounds
# differently from the plain version's on ~0.01% of the elements, as
# accurate as the plain version (each rounds 0.13% of y off float64's),
# and the model carries that to 0.012, 0.039, 0.064 and 0.097 at 4, 12, 24
# and 48 layers, past this bound, which the plain formulas in float64 miss
# too (0.016 to 0.126) (H100, scripts/ssd_prefill_gap.py; PERF.md, section
# 6).  So the wrapper does not take the bf16 route (ROADMAP.md, C4).
SSD_PREFILL_TOL = 1e-3
# A swap of a few 64 KiB blocks moves under 1% of the weights to the card.
SWAP_H2D_FRAC = 0.01
PROFILE_STEPS = 4    # decode steps traced for the device's busy time
STORE_BYTES_NEEDED = 26e9
CHAIN_ARCH = "llama3.2-3b"   # phase 3c, reduced config
SSM_ARCH = "mamba2-370m"     # phase 3e, full width and depth
SSM_BATCH = 4
SSM_SEQ = 1024
SSM_STEPS = 8

# Serving (phase 3d): Yi-9B at full width and depth on random weights
SERVE_BATCH = 8
SERVE_PROMPT = 1024
SERVE_NEW = 128
# Published H100 SXM peaks (NVIDIA data sheet) for the bound_ms column.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12     # tensor cores, dense: the least time for attention

SUMSQ_RTOL = 1e-4   # float sums of 16K terms in another order
ADAM_RTOL = 1e-5    # float32 update, FMA contraction vs separate ops
ADAM_ATOL = 1e-7
# flash_attention vs its plain version (the same float32 function, summed in
# another order).  The small phase-2 cases: bf16 within 2e-2, as the JAX
# package's kernel tests hold its Pallas kernel; float32 within 2e-5.
FLASH_BF16_TOL = 2e-2
FLASH_F32_TOL = 2e-5
# At the serve path's two shapes, bf16: each element within two bf16 ulps
# of the plain version's (|d| <= 2**-6 |want| + 1e-5), and at most 1% of
# the elements off by any rounding.  Two float32 results rounded to bf16
# differ by one ulp where they straddle a rounding edge, and rarely; a
# function that rounds p to bf16 before p.v (as SDPA does) is off by tens
# of ulps on small outputs and on ~40% of the elements, so it fails both.
FLASH_MAIN_RTOL = 2.0 ** -6
FLASH_MAIN_ATOL = 1e-5
FLASH_MAIN_MISMATCH = 0.01
# SDPA against the plain version is recorded under the same check (a
# control that should fail it) and held only to this sanity bound.
SDPA_SANITY_TOL = 5e-2
# ssd_scan vs its plain version (one float32 function summed in another
# order): bf16 y under the two-ulp check above; float32 y within
# |d| <= 1e-4 (|want| + 1), the bound of the JAX package's kernel tests;
# the final state (float32) within 1e-4 of the plain version's largest
# magnitude.
SSD_F32_TOL = 1e-4
SSD_STATE_RTOL = 1e-4
# Phase 3f: resumed losses of an int8 resume against the uninterrupted run,
# held to the JAX package's own band for an int8 resume
# (tests/test_data_and_policies_prop.py,
# test_int8_checkpoint_resume_trains_on).
INT8_LOSS_BAND = 0.5


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, torch) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ------------------------------------------------------------------ phase 2
def check_block_fp_dtypes(torch, dev) -> None:
    from repro_torch.dtypes import byte_view
    from repro_torch.kernels import block_fp as bfp

    g = torch.Generator(device=dev).manual_seed(1)
    bb = 65536
    leaves = [
        torch.randn(100_003, generator=g, device=dev).to(torch.bfloat16),
        torch.randn(3 * 16384 + 7, generator=g, device=dev),
        torch.randint(-2**31, 2**31 - 1, (12_345,), generator=g,
                      device=dev, dtype=torch.int32),
        torch.randint(0, 256, (99_999,), generator=g, device=dev,
                      dtype=torch.uint8),
        torch.rand(70_001, generator=g, device=dev) < 0.5,
        torch.randn(40_000, generator=g, device=dev).to(torch.float16),
        torch.randint(-128, 127, (5,), generator=g, device=dev,
                      dtype=torch.int8),
        torch.randint(-2**40, 2**40, (9_000,), generator=g, device=dev,
                      dtype=torch.int64),
        torch.randn(8_193, generator=g, device=dev, dtype=torch.float64),
        torch.zeros(0, device=dev),
    ]
    # a 2-byte-aligned leaf: its blocks take the kernel's byte path
    base = torch.randn(200_001, generator=g, device=dev).to(torch.bfloat16)
    leaves.append(base[1:])
    fp1, ss1, nbs = bfp.fingerprint_unit(leaves, bb)
    fp2, ss2, _ = bfp.fingerprint_unit(leaves, bb)
    torch.cuda.synchronize()
    if not torch.equal(fp1, fp2) or not torch.equal(ss1, ss2):
        raise AssertionError("block_fp: two launches differ")
    lo = 0
    for x, nb in zip(leaves, nbs):
        pfp, pss = bfp.fingerprint_plain(x, bb)
        kfp, kss = fp1[lo:lo + nb], ss1[lo:lo + nb]
        if not torch.equal(kfp, pfp):
            raise AssertionError(f"block_fp pairs differ for {x.dtype} "
                                 f"n={x.numel()}")
        host = bfp.fingerprint_bytes(
            bytes(byte_view(x.contiguous()).cpu().numpy()), bb)
        if not (kfp.cpu().numpy().view("uint32") == host).all():
            raise AssertionError(f"block_fp pairs differ from the host "
                                 f"oracle for {x.dtype}")
        if not torch.allclose(kss, pss, rtol=SUMSQ_RTOL, atol=0.0):
            raise AssertionError(f"block_fp sumsq off for {x.dtype}: "
                                 f"{(kss - pss).abs().max().item()}")
        lo += nb
    log(f"block_fp: {len(leaves)} dtype/tail cases bit-exact")


def yi_block_unit(torch, dev, seed: int):
    """A full-width Yi-9B block's leaves: (params bf16, master, m, v, grads
    bf16) as lists in the unit's flatten order."""
    from repro_torch.checkpoint.serial import flatten_with_paths
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(ARCH).replace(num_layers=1)
    specs = build_model(cfg).param_specs()["blocks"]
    g = torch.Generator(device=dev).manual_seed(seed)
    shapes = [s.shape[1:] for _, s in flatten_with_paths(specs)]
    master = [torch.randn(s, generator=g, device=dev) * 0.02 for s in shapes]
    m = [torch.randn(s, generator=g, device=dev) * 1e-3 for s in shapes]
    v = [torch.rand(s, generator=g, device=dev) * 1e-6 for s in shapes]
    grads = [(torch.randn(s, generator=g, device=dev) * 1e-3).to(
        torch.bfloat16) for s in shapes]
    params = [x.to(torch.bfloat16) for x in master]
    return params, master, m, v, grads


def block_fp_at_main_shapes(torch, dev) -> dict:
    from repro_torch.kernels import block_fp as bfp

    params, master, m, v, grads = yi_block_unit(torch, dev, seed=2)
    del params, grads
    unit = master + m + v           # the block's optimizer unit: 2.08 GB
    bb = 65536
    fp, ss, nbs = bfp.fingerprint_unit(unit, bb)
    plain = [bfp.fingerprint_plain(x, bb) for x in unit]
    pfp = torch.cat([p[0] for p in plain])
    pss = torch.cat([p[1] for p in plain])
    if not torch.equal(fp, pfp):
        raise AssertionError("block_fp pairs differ at the main-path shape")
    if not torch.allclose(ss, pss, rtol=SUMSQ_RTOL, atol=0.0):
        raise AssertionError("block_fp sumsq off at the main-path shape")
    err = (ss - pss).abs().max().item()
    del plain, pfp, pss
    nbytes = sum(x.numel() * x.element_size() for x in unit)
    n_blocks = sum(nbs)
    ms = cuda_ms(lambda: bfp.fingerprint_unit(unit, bb), 10, torch)
    plain_ms = cuda_ms(lambda: [bfp.fingerprint_plain(x, bb) for x in unit],
                       3, torch)
    out_bytes = n_blocks * 12
    words = nbytes // 4
    elems = sum(x.numel() for x in unit)
    ops = 3 * words + 2 * elems     # 2 adds + 1 mul per word, sq + add
    bound_s = max((nbytes + out_bytes) / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
    bound_by = ("bytes" if (nbytes + out_bytes) / HBM_BYTES_PER_S
                >= ops / F32_OPS_PER_S else "operations")
    log(f"block_fp at Yi-9B block opt unit ({nbytes / 1e9:.3f} GB, "
        f"{len(unit)} leaves, {n_blocks} blocks): {ms:.4f} ms")
    return {"name": "block_fp", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/block_fp.cu",
            "replaces": "src/repro/kernels/block_fp/kernel.py:62",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "library_ms": None,
            "shape": f"Yi-9B block opt unit, {len(unit)} leaves, "
                     f"{nbytes} bytes"}


def fused_adamw_at_main_shapes(torch, dev) -> dict:
    from repro_torch.kernels.fused_adamw import fused_adamw, fused_adamw_plain

    params, master, m, v, grads = yi_block_unit(torch, dev, seed=3)
    wds = [0.0 if x.dim() == 1 else 0.1 for x in master]
    kw = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, step=3)
    gscale = torch.tensor([0.5], device=dev)
    ref = [[x.clone() for x in t] for t in (params, master, m, v)]
    fused_adamw(grads, master, m, v, params, wds, gscale=gscale, **kw)
    fused_adamw_plain(grads, ref[1], ref[2], ref[3], ref[0], wds,
                      gscale=gscale, **kw)
    torch.cuda.synchronize()
    err = 0.0
    for got, want in zip(master + m + v, ref[1] + ref[2] + ref[3]):
        if not torch.allclose(got, want, rtol=ADAM_RTOL, atol=ADAM_ATOL):
            raise AssertionError("fused_adamw differs from the plain version")
        err = max(err, (got - want).abs().max().item())
    for p, ma in zip(params, master):
        if not torch.equal(p, ma.to(torch.bfloat16)):
            raise AssertionError("fused_adamw bf16 params != bf16(master)")
    del ref
    n = sum(x.numel() for x in master)
    ms = cuda_ms(lambda: fused_adamw(grads, master, m, v, params, wds,
                                     gscale=gscale, **kw), 10, torch)
    plain_ms = cuda_ms(lambda: fused_adamw_plain(
        grads, master, m, v, params, wds, gscale=gscale, **kw), 3, torch)
    nbytes = 28 * n                  # g, p bf16 + master, m, v f32, in + out
    ops = 16 * n
    bound_s = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
    bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S
                else "operations")
    log(f"fused_adamw at Yi-9B block ({n} params, {len(master)} leaves): "
        f"{ms:.4f} ms")
    return {"name": "fused_adamw", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_adamw.cu",
            "replaces": "src/repro/kernels/fused_adamw/kernel.py:40",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "library_ms": None,
            "shape": f"Yi-9B block, {len(master)} leaves, {n} params"}


def _quant_special_block(torch, dev, dtype):
    """Seven 256-element blocks: all zero; half-way ties (amax 127, so
    scale 1 and x / scale = k + 0.5 exactly); +-amax (the clip edge);
    f32 denormals; a denormal amax whose quotient underflows (scale 1, as
    numpy's ``where(scales == 0, 1, scales)``); a NaN; an Inf."""
    k = torch.arange(256, device=dev, dtype=torch.float32)
    ties = (k % 64) - 31.5                     # +-0.5 ... +-31.5
    ties[0], ties[1] = 127.0, -126.5
    clip = torch.where(k % 2 == 0, 1.0, -1.0) * 3.0
    clip[5] = -3.0000002
    denorm = (k - 128) * 1e-41
    under = torch.zeros(256, device=dev)
    under[7] = 1e-44
    nan = torch.ones(256, device=dev)
    nan[100] = float("nan")
    inf = torch.ones(256, device=dev)
    inf[3] = float("-inf")
    x = torch.cat([torch.zeros(256, device=dev), ties, clip, denorm, under,
                   nan, inf]).to(dtype)
    return x, 5          # the first 5 blocks are finite


def _scales_equal(torch, a, b) -> bool:
    """Bitwise equal, NaN where the other is NaN (any NaN payload)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and torch.equal(
        a[~na].view(torch.int32), b[~nb].view(torch.int32))


def check_quantize_cases(torch, dev) -> None:
    """quantize and dequantize against their plain versions on the card,
    bitwise, in one launch each: n in {1, 255, 256, 257, 64*256+3}, f32
    and bf16, a leaf and a destination that do not start on 16 bytes (the
    kernels' scalar path), and the special blocks of
    ``_quant_special_block`` (q of the NaN and Inf blocks is not compared:
    numpy's int8 cast of NaN is platform-defined); two launches give the
    same bytes."""
    from repro_torch.kernels import quantize as qz

    g = torch.Generator(device=dev).manual_seed(7)
    leaves, finite = [], []
    for dtype in (torch.float32, torch.bfloat16):
        for n in (1, 255, 256, 257, 64 * 256 + 3):
            leaves.append((torch.randn(n, generator=g, device=dev)
                           * 3).to(dtype))
            finite.append(qz.n_quant_blocks(n))
        x, nf = _quant_special_block(torch, dev, dtype)
        leaves.append(x)
        finite.append(nf)
        odd = (torch.randn(3 * 256 + 9, generator=g, device=dev)
               * 3).to(dtype)
        leaves.append(odd[1:])              # 4 or 2 bytes past 16
        finite.append(qz.n_quant_blocks(odd.numel() - 1))
    unit = qz.quantize_unit(leaves)
    again = qz.quantize_unit(leaves)
    torch.cuda.synchronize()
    if not all(torch.equal(unit.record(i), again.record(i))
               for i in range(len(leaves))):
        raise AssertionError("quantize: two launches differ")
    dsts, recs = [], []
    for i, (x, nf) in enumerate(zip(leaves, finite)):
        what = f"quantize {x.dtype} n={x.numel()}"
        for pq, ps in (qz.quantize_plain(x), qz.quantize_plain(x.cpu())):
            if not torch.equal(unit.q(i)[:nf].cpu(), pq[:nf].cpu()):
                raise AssertionError(f"{what}: q differs from the plain "
                                     "version")
            if not _scales_equal(torch, unit.scales(i).cpu(), ps.cpu()):
                raise AssertionError(f"{what}: scales differ from the "
                                     "plain version")
        n = min(x.numel(), nf * qz.QUANT_BLOCK)
        nb = qz.n_quant_blocks(n)
        for dt in (torch.float32, torch.bfloat16):
            off = len(dsts) % 2     # every other destination off 16 bytes
            dsts.append(torch.empty(n + 1, dtype=dt, device=dev)[
                off:off + n])
            recs.append((unit.q(i)[:nb], unit.scales(i)[:nb]))
    qz.dequantize_unit(recs, dsts)
    torch.cuda.synchronize()
    for out, (q, s) in zip(dsts, recs):
        want = qz.dequantize_plain(q, s, out.numel(), out.dtype)
        if not torch.equal(out.view(torch.uint8), want.view(torch.uint8)):
            raise AssertionError(f"dequantize {out.dtype} n={out.numel()}: "
                                 "differs from the plain version")
    log(f"quantize/dequantize: {len(leaves)} leaves (sizes, f32/bf16, zero,"
        " ties, clip, denormal, underflow, NaN, Inf, off 16 bytes) bitwise "
        "equal to the plain versions")


def quantize_at_main_shapes(torch, dev) -> list:
    """quantize of a full-width Yi-9B block's optimizer unit (27 f32
    leaves) and weights unit (9 bf16 leaves), dequantize of the optimizer
    unit, each bitwise against its plain version and timed."""
    from repro_torch.kernels import quantize as qz

    params, master, m, v, grads = yi_block_unit(torch, dev, seed=4)
    del grads
    opt = master + m + v
    rows = []
    for name, unit in (("opt", opt), ("weights", params)):
        got = qz.quantize_unit(unit)
        torch.cuda.synchronize()
        for i, x in enumerate(unit):
            pq, ps = qz.quantize_plain(x)
            if not (torch.equal(got.q(i), pq)
                    and _scales_equal(torch, got.scales(i), ps)):
                raise AssertionError(f"quantize differs from the plain "
                                     f"version at the Yi-9B block {name} "
                                     "unit")
        del pq, ps
        nin = sum(x.numel() * x.element_size() for x in unit)
        nout = sum(qz.record_nbytes(x.numel()) for x in unit)
        elems = sum(x.numel() for x in unit)
        ms = cuda_ms(lambda: qz.quantize_unit(unit), 10, torch)
        plain_ms = cuda_ms(lambda: [qz.quantize_plain(x) for x in unit], 3,
                           torch)
        t_bytes = (nin + nout) / HBM_BYTES_PER_S
        t_ops = 5 * elems / F32_OPS_PER_S    # abs, max, 2 div, rint+clamp
        rows.append({"name": "quantize", "unit": name, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops)
                     * 1e3, "bound_by": ("bytes" if t_bytes >= t_ops
                                         else "operations"),
                     "bytes": nin + nout,
                     "shape": f"Yi-9B block {name} unit, {len(unit)} leaves,"
                              f" {nin} bytes"})
        if name == "opt":
            recs = [(got.q(i), got.scales(i)) for i in range(len(unit))]
            outs = [torch.empty_like(x) for x in unit]
            qz.dequantize_unit(recs, outs)
            torch.cuda.synchronize()
            for (q, s), o in zip(recs, outs):
                if not torch.equal(o.view(-1), qz.dequantize_plain(
                        q, s, o.numel(), o.dtype)):
                    raise AssertionError("dequantize differs from the plain "
                                         "version at the Yi-9B opt unit")
            ms = cuda_ms(lambda: qz.dequantize_unit(recs, outs), 10, torch)
            plain_ms = cuda_ms(lambda: [qz.dequantize_plain(
                q, s, o.numel(), o.dtype) for (q, s), o in zip(recs, outs)],
                3, torch)
            t_ops = elems / F32_OPS_PER_S
            rows.append({"name": "dequantize", "unit": name, "ms": ms,
                         "plain_ms": plain_ms,
                         "bound_ms": max(t_bytes, t_ops) * 1e3,
                         "bound_by": ("bytes" if t_bytes >= t_ops
                                      else "operations"),
                         "bytes": nin + nout,
                         "shape": f"Yi-9B block opt unit, {len(unit)} "
                                  f"leaves, {nin} bytes"})
            del recs, outs
        del got
        torch.cuda.empty_cache()
    del params, master, m, v, opt
    torch.cuda.empty_cache()
    out = []
    for r in rows:
        log(f"{r['name']} at the {r['shape']}: {r['ms']:.4f} ms (bound "
            f"{r['bound_ms']:.4f}, plain {r['plain_ms']:.3f})")
        if r["unit"] == "weights":
            continue
        src = "src/repro_torch/kernels/csrc/quantize.cu"
        out.append({
            "name": r["name"], "route": "cuda", "source": src,
            "replaces": ("src/repro/kernels/quantize/kernel.py:32"
                         if r["name"] == "quantize" else
                         "src/repro/kernels/quantize/kernel.py:53"),
            "max_abs_err": 0.0, "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None,
            "library_note": "no single PyTorch call derives per-block "
                            "scales from amax and rounds to int8 "
                            "(quantize_per_channel takes given scales and "
                            "returns a quantized tensor type)",
            "shape": r["shape"]})
    out[0]["weights_unit"] = next(r for r in rows if r["unit"] == "weights")
    return out


def check_block_gather_cases(torch, dev) -> None:
    from repro_torch.dtypes import byte_view
    from repro_torch.kernels import block_fp as bfp
    from repro_torch.kernels import block_gather as bg

    g = torch.Generator(device=dev).manual_seed(5)
    bb = 65536
    leaves, refs, caps = [], [], []
    for dtype, n in ((torch.float32, 3 * 16384 + 7), (torch.bfloat16, 100_003),
                     (torch.float16, 40_001), (torch.int32, 50_000),
                     (torch.uint8, 99_999), (torch.int8, 70_001),
                     (torch.int16, 65_537), (torch.int64, 9_000),
                     (torch.float64, 8_193), (torch.bool, 70_001)):
        base = torch.randn(n, generator=g, device=dev) * 100
        base = base > 0 if dtype == torch.bool else base.to(dtype)
        cur = base.clone()
        step = max(1, n // 3)
        cur[::step] = (cur[::step] == 0 if dtype == torch.bool
                       else cur[::step] + 1)
        leaves.append(cur)
        refs.append(bfp.fingerprint_plain(base, bb)[0])
        caps.append(4)
    odd = torch.randn(200_001, generator=g, device=dev).to(torch.bfloat16)
    leaves += [odd[1:], torch.zeros(0, device=dev)]     # 2-byte aligned, empty
    refs += [None, None]
    caps += [8, 1]
    clean = torch.randn(300_000, generator=g, device=dev)
    leaves.append(clean)
    refs.append(bfp.fingerprint_plain(clean, bb)[0])    # count 0, idx -1
    caps.append(2)
    over = torch.randn(8 * 16384, generator=g, device=dev)
    over_ref = bfp.fingerprint_plain(over, bb)[0]
    over = over.clone()
    over[::16384] += 1                                  # 8 dirty blocks
    leaves.append(over)
    refs.append(over_ref)
    caps.append(1)                                      # count > capacity
    got = bg.gather_tree_dirty(leaves, refs, caps, block_bytes=bb)
    again = bg.gather_tree_dirty(leaves, refs, caps, block_bytes=bb)
    fp, ss, _ = bfp.fingerprint_unit(leaves, bb)
    torch.cuda.synchronize()
    lo = 0
    for x, r, k, k2 in zip(leaves, refs, got, again):
        p = bg.gather_dirty_plain(x, r, capacity=k.capacity, block_bytes=bb)
        host = bg.gather_dirty_oracle(
            byte_view(x.contiguous()).cpu().numpy(),
            None if r is None else r.cpu().numpy().view("uint32"),
            capacity=k.capacity, block_bytes=bb)
        what = f"block_gather {x.dtype} n={x.numel()}"
        if not (torch.equal(k.fp, p.fp) and torch.equal(k.idx, p.idx)
                and int(k.count) == int(p.count)
                and torch.equal(k.block_bytes(), p.block_bytes())):
            raise AssertionError(f"{what}: differs from the plain version")
        if not ((k.fp.cpu().numpy().view("uint32") == host[0]).all()
                and (k.idx.cpu().numpy() == host[1]).all()
                and int(k.count) == host[3]
                and (k.block_bytes().cpu().numpy().reshape(-1)
                     == host[2].view("uint8").reshape(-1)).all()):
            raise AssertionError(f"{what}: differs from the host oracle")
        nb = k.fp.shape[0]
        if not (torch.equal(k.sumsq, ss[lo:lo + nb])
                and torch.equal(k.sumsq, k2.sumsq)):
            raise AssertionError(f"{what}: sums of squares not those of "
                                 "block_fp, or not the same in two runs")
        if not torch.allclose(k.sumsq, p.sumsq, rtol=SUMSQ_RTOL, atol=0.0):
            raise AssertionError(f"{what}: sumsq off the plain version")
        lo += nb
    if int(got[-2].count) != 0 or got[-2].idx.tolist() != [-1, -1]:
        raise AssertionError("block_gather: a clean leaf gathered blocks")
    if int(got[-1].count) != 8 or got[-1].idx.tolist() != [0]:
        raise AssertionError("block_gather: overflow count or prefix wrong")
    log(f"block_gather: {len(leaves)} dtype/tail/clean/no-ref/overflow "
        "cases bit-exact")


def gather_bound(arrs, results, n_dirty: int, bb: int):
    """(bound seconds, bound_by) of one fused gather: each input read
    once (the unit, the reference tables), each output written once (the
    pairs, the sums of squares, the indices, the dirty blocks, the counts);
    the operations are those of block_fp plus one compare per block."""
    nbytes = sum(a.numel() * a.element_size() for a in arrs)
    nb = sum(r.fp.shape[0] for r in results)
    slots = sum(r.capacity for r in results)
    moved = nbytes + 8 * nb + 12 * nb + 4 * slots + n_dirty * bb \
        + 4 * len(arrs)
    ops = 3 * nbytes // 4 + 2 * sum(a.numel() for a in arrs) + 2 * nb
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def block_gather_at_main_shape(torch, dev, store: Path) -> dict:
    """Time block_gather on the Yi-9B embed optimizer unit: the step-4
    state of phase 3b against the tables its step-2 object stored."""
    from repro_torch.checkpoint.saver import CheckpointManager
    from repro_torch.checkpoint.serial import flatten_with_paths
    from repro_torch.core.layer_registry import LayerRegistry
    from repro_torch.core.policies import make_policy
    from repro_torch.kernels import block_fp as bfp
    from repro_torch.kernels import block_gather as bg
    from repro_torch.launch import steps

    model = _model()
    registry = LayerRegistry(model)
    mgr = CheckpointManager(store, registry,
                            make_policy("topk_delta", model.layer_units()),
                            async_save=False)
    base_ref = mgr.manifests.load(2).entries["embed"]["opt"]
    cur_ref = mgr.manifests.load(4).entries["embed"]["opt"]
    if cur_ref.step != 4:
        raise AssertionError(f"embed/opt of manifest 4 is from step "
                             f"{cur_ref.step}")
    base_tbl = mgr.store.load_fp_table(base_ref.digest)
    state = mgr.restore(steps.state_specs(model), device=dev, step=4)
    mgr.close()
    tree = registry.extract_opt_unit(state["opt"], "embed")
    arrs = [a.contiguous() for _, a in flatten_with_paths(tree)]
    del state, tree
    torch.cuda.empty_cache()
    bb = 65536
    refs = [b.fp for b in base_tbl]
    nbs = [bfp.ops.n_blocks_of(a, bb) for a in arrs]
    probe = bg.gather_tree_dirty(arrs, refs, nbs, block_bytes=bb)
    counts = [int(r.count) for r in probe]
    del probe
    n_dirty, n_blocks = sum(counts), sum(nbs)
    nbytes = sum(a.numel() * a.element_size() for a in arrs)
    torch.cuda.empty_cache()

    def timed(refs, caps, reps=10):
        res = bg.gather_tree_dirty(arrs, refs, caps, block_bytes=bb)
        nd = sum(min(int(r.count), r.capacity) for r in res)
        bound_s, bound_by = gather_bound(arrs, res, nd, bb)
        del res
        ms = cuda_ms(lambda: bg.gather_tree_dirty(arrs, refs, caps,
                                                  block_bytes=bb), reps, torch)
        return ms, bound_s * 1e3, bound_by

    ms, bound_ms, bound_by = timed(refs, counts)
    own = [bfp.fingerprint_plain(a, bb)[0] for a in arrs]
    ms0, bound0, by0 = timed(own, [1] * len(arrs))            # 0% dirty
    del own
    ms1, bound1, by1 = timed([None] * len(arrs), nbs)         # 100% dirty
    torch.cuda.empty_cache()
    # the plain version at the training pattern, and its agreement
    kres = bg.gather_tree_dirty(arrs, refs, counts, block_bytes=bb)
    err = 0.0
    for a, r, k in zip(arrs, refs, kres):
        p = bg.gather_dirty_plain(a, r, capacity=k.capacity, block_bytes=bb)
        if not (torch.equal(k.fp, p.fp) and torch.equal(k.idx, p.idx)
                and int(k.count) == int(p.count)
                and torch.equal(k.block_bytes(), p.block_bytes())):
            raise AssertionError("block_gather differs from the plain "
                                 "version at the main-path shape")
        if not torch.allclose(k.sumsq, p.sumsq, rtol=SUMSQ_RTOL, atol=0.0):
            raise AssertionError("block_gather sumsq off at the main shape")
        err = max(err, (k.sumsq - p.sumsq).abs().max().item())
        del p
        torch.cuda.empty_cache()
    del kres
    caps = [bg.round_capacity(c, n) for c, n in zip(counts, nbs)]
    plain_ms = cuda_ms(lambda: [bg.gather_dirty_plain(a, r, capacity=c,
                                                      block_bytes=bb)
                                for a, r, c in zip(arrs, refs, caps)],
                       2, torch)
    log(f"block_gather at Yi-9B embed opt unit ({nbytes / 1e9:.3f} GB, "
        f"{n_blocks} blocks, {n_dirty} dirty): {ms:.4f} ms "
        f"(bound {bound_ms:.4f}); 0%: {ms0:.4f} ms; 100%: {ms1:.4f} ms")
    del arrs
    torch.cuda.empty_cache()
    return {"name": "block_gather", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/block_gather.cu",
            "replaces": "src/repro/kernels/block_gather/kernel.py:73",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "shape": f"Yi-9B embed opt unit, 3 leaves, {nbytes} bytes, "
                     f"{n_blocks} blocks, {n_dirty} dirty (step 4 vs the "
                     "step-2 tables of phase 3b)",
            "dirty_counts": counts,
            "clean": {"ms": ms0, "bound_ms": bound0, "bound_by": by0},
            "all_dirty": {"ms": ms1, "bound_ms": bound1, "bound_by": by1}}


FLASH_CASES = (
    # (B, Sq, Sk, H, G, D, causal, dtype name, what)
    (2, 128, 128, 8, 2, 128, True, "bfloat16", "causal Sq == Sk"),
    (2, 64, 200, 8, 4, 64, True, "float32", "causal Sq < Sk, top-left"),
    (2, 96, 160, 4, 2, 128, False, "bfloat16", "non-causal Sq != Sk"),
    (1, 77, 77, 4, 1, 64, True, "bfloat16", "ragged Sk, G = 1"),
    (2, 130, 130, 4, 4, 64, True, "float32", "G = H"),
    (1, 70, 70, 32, 1, 128, True, "float32", "G = 1, 32 heads"),
    (3, 200, 200, 32, 4, 128, True, "bfloat16", "Yi-9B heads"),
)


def flash_route_cases(t: int) -> tuple:
    """Cases at the edges of the bf16 routes, ``t`` being the first query
    count the prefill route takes (``ops.PREFILL_MIN_QUERIES``)."""
    return (
        (2, t - 1, 300, 32, 4, 128, False, "bfloat16", "decode, Sq = t - 1"),
        (2, t, 300, 32, 4, 128, False, "bfloat16", "prefill, Sq = t"),
        (2, t - 1, 300, 32, 4, 128, True, "bfloat16",
         "decode, causal Sq = t - 1 < Sk"),
        (2, t, 300, 32, 4, 128, True, "bfloat16",
         "prefill, causal Sq = t < Sk"),
        (1, t - 1, 500, 8, 2, 64, False, "bfloat16", "decode, D 64"),
        (2, t - 1, 333, 8, 1, 128, False, "bfloat16", "decode, G = 1"),
        (1, t - 1, 130, 4, 4, 128, False, "bfloat16", "decode, G = H"),
        (2, 1, 1, 32, 4, 128, False, "bfloat16", "decode, Sk = 1"),
        (1, 100, 1, 8, 2, 128, True, "bfloat16", "prefill, Sk = 1"),
        (1, 1, 4097, 32, 4, 128, False, "bfloat16", "decode, Sk = 4097"),
        (1, 70, 4097, 8, 2, 64, False, "bfloat16", "prefill, Sk = 4097"),
    )


def _flash_tol(dtype, torch) -> float:
    return FLASH_BF16_TOL if dtype == torch.bfloat16 else FLASH_F32_TOL


def check_flash_attention_cases(torch, dev) -> float:
    """flash_attention against its plain version on the card over the
    cases above plus a decode step (Sq = 1) on a strided cache view;
    returns the largest absolute difference."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(7)
    worst = 0.0
    cases = [(b, sq, sk, h, gg, d, causal, getattr(torch, dt), what, None)
             for b, sq, sk, h, gg, d, causal, dt, what in
             FLASH_CASES + flash_route_cases(fa.ops.PREFILL_MIN_QUERIES)]
    for dt in (torch.bfloat16, torch.float32):
        cache = torch.randn(2, 300, 2, 2, 128, generator=g, device=dev).to(dt)
        cases.append((2, 1, 213, 8, 2, 128, False, dt,
                      f"decode Sq = 1 on a cache view ({dt})", cache))
    routes = {}
    for b, sq, sk, h, gg, d, causal, dt, what, cache in cases:
        q = torch.randn(b, sq, h, d, generator=g, device=dev).to(dt)
        if cache is None:
            k = torch.randn(b, sk, gg, d, generator=g, device=dev).to(dt)
            v = torch.randn(b, sk, gg, d, generator=g, device=dev).to(dt)
        else:
            k, v = cache[:, :sk, 0], cache[:, :sk, 1]
            if k.is_contiguous():
                raise AssertionError("the decode case must be strided")
        route = fa.ops.pick_route(dt, sq)
        got = fa.flash_attention(q, k, v, causal=causal)
        want = fa.attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        tol = _flash_tol(dt, torch)
        if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
            err = (got.float() - want.float()).abs().max().item()
            raise AssertionError(f"flash_attention differs from the plain "
                                 f"version ({what}, {route} route): max abs "
                                 f"{err}")
        routes[route] = routes.get(route, 0) + 1
        worst = max(worst, (got.float() - want.float()).abs().max().item())
    if set(routes) != set(fa.ops.ROUTES):
        raise AssertionError(f"phase 2's cases miss a route: {routes}")
    log(f"flash_attention: {len(cases)} cases within tolerance "
        f"(max abs {worst:.3g}; cases per route {routes})")
    return worst


def _main_shape_check(got, want) -> dict:
    """The serve-shape check of a bf16 attention output against the plain
    version: max abs difference, the worst element's share of its limit
    (<= 1 passes) and the share of elements that differ at all."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    limit = FLASH_MAIN_RTOL * w.abs() + FLASH_MAIN_ATOL
    worst = (diff / limit).max().item()
    mismatch = (g != w).float().mean().item()
    return {"max_abs_err": diff.max().item(), "worst_of_limit": worst,
            "mismatch_share": mismatch,
            "within": worst <= 1.0 and mismatch <= FLASH_MAIN_MISMATCH}


def device_ms(torch, fn, reps: int, name: str, by_kernel=None):
    """Device milliseconds per call of ``fn`` from a ``torch.profiler``
    trace of ``reps`` calls (kernel time alone, no host gaps), and the
    device kernels per call whose name holds ``name``; (None, None) where
    the profiler shows no device time.  A dict ``by_kernel`` receives the
    device milliseconds per call of each kernel, by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, n = 0.0, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us += e.time_range.elapsed_us()
            n += name in e.name
            if by_kernel is not None:
                k = e.name.split("(")[0]
                by_kernel[k] = (by_kernel.get(k, 0.0)
                                + e.time_range.elapsed_us() / 1e3 / reps)
    if us == 0:
        return None, None
    return us / 1e3 / reps, n / reps


def ptxas_report(text: str) -> dict:
    """Registers and spill bytes per kernel from ``nvcc -Xptxas=-v``."""
    out, fn = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            out[fn] = {}
        elif fn and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            out[fn]["spill_store_bytes"] = int(st)
            out[fn]["spill_load_bytes"] = int(ld)
        elif fn and re.search(r"Used \d+ registers", line):
            out[fn]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    return out


def flash_attention_at_main_shapes(torch, dev, err: float) -> dict:
    """Time the kernel, its plain version and SDPA at the serve path's two
    shapes, each on the route the wrapper picks: the Yi-9B prefill (batch 8
    x 1024 tokens, causal: the bf16 prefill route) and a decode step over a
    1088-key cache prefix (non-causal, strided view: the split-K decode
    route); and the float32 route at the prefill shape.  Event times (one
    call: host work and device) and profiler device times."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels._build import BUILDER

    cfg = get_config(ARCH)
    h, gg, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    g = torch.Generator(device=dev).manual_seed(8)
    bf = torch.bfloat16
    out = {}
    for name in ("prefill", "decode", "f32"):
        dt = torch.float32 if name == "f32" else bf
        if name != "decode":
            sq = sk = SERVE_PROMPT
            q = torch.randn(SERVE_BATCH, sq, h, d, generator=g, device=dev)
            k = torch.randn(SERVE_BATCH, sk, gg, d, generator=g, device=dev)
            v = torch.randn(SERVE_BATCH, sk, gg, d, generator=g, device=dev)
            q, k, v = q.to(dt), k.to(dt), v.to(dt)
            causal = True
        else:
            sq, sk = 1, SERVE_PROMPT + SERVE_NEW // 2
            cache = torch.randn(SERVE_BATCH, SERVE_PROMPT + SERVE_NEW, 2, gg,
                                d, generator=g, device=dev).to(bf)
            q = torch.randn(SERVE_BATCH, 1, h, d, generator=g,
                            device=dev).to(bf)
            k, v = cache[:, :sk, 0], cache[:, :sk, 1]
            causal = False
        route = fa.ops.pick_route(dt, sq)
        got = fa.flash_attention(q, k, v, causal=causal)
        want = fa.attention_plain(q, k, v, causal=causal)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                             enable_gqa=True).transpose(1, 2)
        torch.cuda.synchronize()
        if name == "f32":
            kchk = {"max_abs_err": (got - want).abs().max().item(),
                    "within": torch.allclose(got, want, atol=FLASH_F32_TOL,
                                             rtol=FLASH_F32_TOL)}
            lchk = {"max_abs_err": (lib - want).abs().max().item(),
                    "within": None}
        else:
            kchk = _main_shape_check(got, want)
            lchk = _main_shape_check(lib, want)
        log(f"flash_attention {name} ({route} route) vs plain: {kchk}; SDPA "
            f"vs plain: {lchk}")
        if not kchk["within"]:
            raise AssertionError(f"flash_attention off the plain version at "
                                 f"the {name} shape: {kchk}")
        if not lchk["max_abs_err"] <= SDPA_SANITY_TOL:
            raise AssertionError(f"SDPA off the plain version at the {name} "
                                 f"shape: {lchk} (sanity check)")
        del got, want, lib
        torch.cuda.empty_cache()
        call = lambda: fa.flash_attention(q, k, v, causal=causal)  # noqa
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa
            qt, kt, vt, is_causal=causal, enable_gqa=True)
        ms = cuda_ms(call, 20, torch)
        plain_ms = cuda_ms(lambda: fa.attention_plain(q, k, v, causal=causal),
                           3, torch)
        library_ms = cuda_ms(sdpa, 20, torch)
        dev_ms, per_call = device_ms(torch, call, 20, "flash_attention_kernel")
        lib_dev_ms, _ = device_ms(torch, sdpa, 20, "")
        size = q.element_size()
        nbytes = size * (q.numel() + k.numel() + v.numel() + q.numel())
        flops = 4 * SERVE_BATCH * h * sq * sk * d
        if causal and sq == sk:
            flops //= 2
        peak = F32_OPS_PER_S if name == "f32" else BF16_OPS_PER_S
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
        out[name] = {"route": route, "kernels_per_call": per_call,
                     "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                     "library_ms": library_ms,
                     "library_device_ms": lib_dev_ms,
                     "bound_ms": max(t_bytes, t_ops) * 1e3,
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "max_abs_err": kchk["max_abs_err"],
                     "worst_of_limit": kchk.get("worst_of_limit"),
                     "mismatch_share": kchk.get("mismatch_share"),
                     "sdpa_max_abs_err": lchk["max_abs_err"],
                     "sdpa_worst_of_limit": lchk.get("worst_of_limit"),
                     "sdpa_mismatch_share": lchk.get("mismatch_share"),
                     "sdpa_within_limit": lchk["within"],
                     "bytes": nbytes, "flops": flops,
                     "shape": f"q ({SERVE_BATCH},{sq},{h},{d}) k/v "
                              f"({SERVE_BATCH},{sk},{gg},{d}) "
                              f"{str(dt).split('.')[-1]}, causal={causal}"}
        log(f"flash_attention {name} ({route}): {ms:.4f} ms, device "
            f"{dev_ms} ms, {per_call} kernels a call (bound "
            f"{out[name]['bound_ms']:.4f}, plain {plain_ms:.3f}, SDPA "
            f"{library_ms:.4f}, device {lib_dev_ms})")
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    pre = out["prefill"]
    ptxas = ptxas_report(BUILDER.logs.get("flash_attention", ""))
    log(f"flash_attention ptxas: {ptxas}")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:71",
            "max_abs_err": max(err, pre["max_abs_err"],
                               out["decode"]["max_abs_err"]),
            "ms": pre["ms"], "plain_ms": pre["plain_ms"],
            "bound_ms": pre["bound_ms"], "bound_by": pre["bound_by"],
            "library_ms": pre["library_ms"], "shape": pre["shape"],
            "prefill": pre, "decode": out["decode"], "f32": out["f32"],
            "ptxas": ptxas}


# (B, S, H, G, Q, dtype name, what): the kernel's edges.  The model calls
# it with Q = min(256, S), so S >= Q there; the kernel also takes S < Q.
# Every case goes through the wrapper (the f32 route, CUDA cores); bf16
# cases also through the bf16 route (tensor cores).
SSD_CASES = (
    (2, 512, 8, 1, 256, "bfloat16", "full chunks, G = 1"),
    (1, 1025, 4, 1, 256, "bfloat16", "ragged S = 4 x 256 + 1"),
    (2, 300, 4, 4, 37, "float32", "odd Q = 37, ragged S, G = H"),
    (1, 200, 8, 2, 64, "float32", "G = 2, ragged S"),
    (3, 100, 32, 1, 100, "bfloat16", "Q = S = 100, 32 heads, G = 1"),
    (2, 77, 4, 4, 256, "float32", "S < Q, G = H"),
    (2, 333, 4, 1, 256, "float32", "ragged S, G = 1"),
    (2, 256, 8, 8, 128, "bfloat16", "G = H"),
    (2, 77, 4, 4, 256, "bfloat16", "S < Q, G = H, bf16"),
    (2, 300, 4, 2, 37, "bfloat16", "odd Q = 37, ragged S, G = 2, bf16"),
)
# Timed besides the serve prefill shape: one long prompt.
SSD_LONG = (1, 4096)


def ssd_inputs(torch, dev, b, s, h, g, dtype, gen, views: bool = True):
    """SSD inputs as the model makes them: x, B and C views of one conv
    output row (B, S, H*P + 2*G*N) in ``dtype`` (or contiguous tensors),
    dt = softplus(randn) float32, a_log = log(linspace(1, 16, H))."""
    from repro_torch.kernels.ssd_scan import ops

    p, n = ops.HEAD_DIM, ops.STATE_DIM
    if views:
        conv = (torch.randn(b, s, h * p + 2 * g * n, generator=gen,
                            device=dev) * 0.5).to(dtype)
        xs = conv[..., :h * p].unflatten(-1, (h, p))
        bs = conv[..., h * p:h * p + g * n].unflatten(-1, (g, n))
        cs = conv[..., h * p + g * n:].unflatten(-1, (g, n))
    else:
        xs, bs, cs = ((torch.randn(b, s, k, d, generator=gen, device=dev)
                       * 0.5).to(dtype) for k, d in ((h, p), (g, n), (g, n)))
    dt = torch.logaddexp(torch.randn(b, s, h, generator=gen, device=dev),
                         torch.zeros((), device=dev))
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device=dev))
    return xs, dt, a_log, bs, cs


def _ssd_check(torch, y, want_y, fin, want_fin) -> dict:
    """y against the plain version (bf16: the two-ulp check of the serve
    shapes; float32: within SSD_F32_TOL) and the final state within
    SSD_STATE_RTOL of the plain version's largest magnitude."""
    if y.dtype == torch.bfloat16:
        chk = _main_shape_check(y, want_y)
    else:
        d = (y - want_y).abs()
        worst = (d / (SSD_F32_TOL * want_y.abs() + SSD_F32_TOL)).max().item()
        chk = {"max_abs_err": d.max().item(), "worst_of_limit": worst,
               "mismatch_share": None, "within": worst <= 1.0}
    fd = (fin - want_fin).abs().max().item()
    chk["state_rel_err"] = fd / max(want_fin.abs().max().item(), 1e-30)
    chk["within"] = chk["within"] and chk["state_rel_err"] <= SSD_STATE_RTOL
    return chk


def check_ssd_scan_cases(torch, dev) -> float:
    """ssd_scan against its plain version on the card over SSD_CASES, with
    model-style strided views and contiguous inputs, through the wrapper
    and (bf16 cases) the bf16 route; two launches must give bitwise-equal
    outputs.  Returns the largest absolute difference of y."""
    from repro_torch.kernels import ssd_scan as ssd

    gen = torch.Generator(device=dev).manual_seed(9)
    worst, n = 0.0, 0
    for i, (b, s, h, g, q, dt_name, what) in enumerate(SSD_CASES):
        dtype = getattr(torch, dt_name)
        args = ssd_inputs(torch, dev, b, s, h, g, dtype, gen,
                          views=i % 2 == 0)
        want_y, want_fin = ssd.ssd_scan_plain(*args, q)
        calls = {"wrapper, f32 route": lambda: ssd.ssd_scan(*args, q)}
        if dtype == torch.bfloat16:
            calls["bf16 route"] = lambda: ssd.ops.launch(*args, q, "bf16")
        for route, call in calls.items():
            case = f"{what} ({route})"
            before = ssd.KERNEL.launches
            y, fin = call()
            y2, fin2 = call()
            torch.cuda.synchronize()
            _check_launched({"ssd_scan": ssd.KERNEL.launches - before - 1},
                            ["ssd_scan"], f"the ssd_scan case {case}")
            if not (torch.equal(y, y2) and torch.equal(fin, fin2)):
                raise AssertionError(f"ssd_scan: two launches differ "
                                     f"({case})")
            chk = _ssd_check(torch, y, want_y, fin, want_fin)
            if not (chk["within"] and torch.isfinite(y.float()).all()):
                raise AssertionError(f"ssd_scan differs from the plain "
                                     f"version ({case}): {chk}")
            log(f"ssd_scan {case}: {chk}")
            worst = max(worst, chk["max_abs_err"])
            n += 1
    log(f"ssd_scan: {n} cases and routes within tolerance, two launches "
        f"bitwise equal (max abs {worst:.3g})")
    return worst


def ssd_scan_rounded_m(torch, xs, dt, a_log, bs, cs, chunk: int):
    """The control of the serve-shape check: the plain version's function
    with the decayed score matrix rounded to bf16 before its product with
    x (what a bf16 tensor-core product of m and x would do without care).
    Written out here, independently of the port, for S % chunk == 0."""
    b, s, h, p = xs.shape
    g, n = bs.shape[2], bs.shape[3]
    r = h // g
    f = torch.float32
    a = -torch.exp(a_log.float())
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=xs.device).tril()
    state = torch.zeros(b, h, p, n, dtype=f, device=xs.device)
    ys = []
    for c0 in range(0, s, chunk):
        x_ = xs[:, c0:c0 + chunk].float()                      # (B,Q,H,P)
        d_ = dt[:, c0:c0 + chunk].float()                      # (B,Q,H)
        b_ = bs[:, c0:c0 + chunk].float().repeat_interleave(r, dim=2)
        c_ = cs[:, c0:c0 + chunk].float().repeat_interleave(r, dim=2)
        lt = torch.cumsum(d_ * a, dim=1).transpose(1, 2)       # (B,H,Q)
        y_inter = torch.einsum("bqhn,bhpn->bqhp", c_, state) \
            * torch.exp(lt).transpose(1, 2)[..., None]
        sc = torch.einsum("bihn,bjhn->bhij", c_, b_)
        rel = torch.clamp(lt[..., :, None] - lt[..., None, :], max=0.0)
        m = torch.where(causal, sc * torch.exp(rel), 0.0) \
            * d_.transpose(1, 2)[:, :, None, :]
        m = m.to(torch.bfloat16).float()
        ys.append((y_inter + torch.einsum("bhij,bjhp->bihp", m, x_))
                  .to(xs.dtype))
        w = torch.exp(lt[..., -1:] - lt) * d_.transpose(1, 2)  # (B,H,Q)
        state = state * torch.exp(lt[..., -1])[..., None, None] \
            + torch.einsum("bhq,bqhn,bqhp->bhpn", w, b_, x_)
    return torch.cat(ys, dim=1), state


def ssd_routes_timed(torch, args, q: int) -> dict:
    """Both routes of ssd_scan on the same bf16 inputs: event time of one
    call, profiler device time, kernels per call and device time by
    kernel."""
    from repro_torch.kernels.ssd_scan import ops

    out = {}
    for route in ("bf16", "f32"):
        call = lambda: ops.launch(*args, q, route)  # noqa: E731
        by_kernel = {}
        dev_ms, per_call = device_ms(torch, call, 20, "ssd_", by_kernel)
        out[route] = {"ms": cuda_ms(call, 20, torch), "device_ms": dev_ms,
                      "kernels_per_call": per_call, "by_kernel": by_kernel}
        torch.cuda.empty_cache()
    b, d = out["bf16"]["device_ms"], out["f32"]["device_ms"]
    out["f32_over_bf16_device"] = d / b if b and d else None
    return out


def ssd_scan_at_main_shape(torch, dev, err: float) -> dict:
    """Time the wrapper and its plain version at the serve prefill shape of
    Mamba2-370m (batch 8 x 1024 tokens, 32 heads, P 64, N 128, Q 256, one
    group, bf16 views of the conv output), after the two-ulp check of both
    routes against the plain version and the rounded-m control under the
    same check; both routes on the same inputs, there and at batch 1 x
    4096 (SSD_LONG)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels._build import BUILDER

    cfg = get_config(SSM_ARCH)
    sc = cfg.ssm
    h = sc.num_heads(cfg.d_model)
    g_, q = sc.ngroups, min(sc.chunk_size, SERVE_PROMPT)
    gen = torch.Generator(device=dev).manual_seed(10)
    args = ssd_inputs(torch, dev, SERVE_BATCH, SERVE_PROMPT, h, g_,
                      torch.bfloat16, gen)
    want_y, want_fin = ssd.ssd_scan_plain(*args, q)
    chks = {}
    for route in ("f32", "bf16"):
        y, fin = ssd.ops.launch(*args, q, route)
        chks[route] = _ssd_check(torch, y, want_y, fin, want_fin)
        del y, fin
    ctl_y, ctl_fin = ssd_scan_rounded_m(torch, *args, q)
    cchk = _ssd_check(torch, ctl_y, want_y, ctl_fin, want_fin)
    log(f"ssd_scan serve shape vs plain: {chks}; rounded-m control: {cchk}")
    for route, chk in chks.items():
        if not chk["within"]:
            raise AssertionError(f"ssd_scan's {route} route off the plain "
                                 f"version at the serve shape: {chk}")
    if cchk["within"]:
        raise AssertionError(f"the check passed the rounded-m control: "
                             f"{cchk}")
    kchk = chks["f32"]
    del want_y, want_fin, ctl_y, ctl_fin
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: ssd.ssd_scan(*args, q), 20, torch)
    plain_ms = cuda_ms(lambda: ssd.ssd_scan_plain(*args, q), 3, torch)
    routes = ssd_routes_timed(torch, args, q)
    routes["bf16"]["check"] = chks["bf16"]
    routes["bf16"]["scratch_bytes"] = ssd.ops.scratch_bytes(
        SERVE_BATCH, SERVE_PROMPT, h, q)
    xs, dt, a_log, bs, cs = args
    b, s, _, p = xs.shape
    n = bs.shape[-1]
    nbytes = (2 * xs.numel() * xs.element_size() + bs.numel()
              * bs.element_size() + cs.numel() * cs.element_size()
              + dt.numel() * 4 + a_log.numel() * 4 + b * h * p * n * 4)
    # The products the function needs, chunk by chunk: the causal scores
    # C.B^T (Q(Q+1)/2 entries of N terms) once per (b, group), and per
    # (b, head) the causal intra product with x (Q(Q+1)/2 entries of P
    # terms), the carried state's part C.state^T (none in the first chunk,
    # whose incoming state is zero) and the state update (Q N P each).
    flops = 0
    for c0 in range(0, s, q):
        qc = min(q, s - c0)
        tri = qc * (qc + 1) // 2
        flops += b * g_ * 2 * tri * n
        flops += b * h * (2 * tri * p + 2 * qc * n * p * (2 if c0 else 1))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_OPS_PER_S
    del args, xs, dt, a_log, bs, cs
    torch.cuda.empty_cache()
    lb, ls = SSD_LONG
    long_args = ssd_inputs(torch, dev, lb, ls, h, g_, torch.bfloat16, gen)
    long_q = min(sc.chunk_size, ls)
    long_routes = ssd_routes_timed(torch, long_args, long_q)
    long_routes["bf16"]["scratch_bytes"] = ssd.ops.scratch_bytes(
        lb, ls, h, long_q)
    del long_args
    torch.cuda.empty_cache()
    ptxas = ptxas_report(BUILDER.logs.get("ssd_scan", ""))
    out = {"name": "ssd_scan", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
           "replaces": "src/repro/kernels/ssd_scan/kernel.py:83",
           "max_abs_err": max(err, *(c["max_abs_err"]
                                     for c in chks.values())), "ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": None,
           "library_note": "no single PyTorch call computes the SSD chunk "
                           "scan",
           "kernel_route": "f32",
           "device_ms": routes["f32"]["device_ms"],
           "kernels_per_call": routes["f32"]["kernels_per_call"],
           "routes": routes,
           "long": {"shape": f"x ({lb},{ls},{h},{p}) bf16 views, Q {long_q}",
                    **long_routes},
           "bytes": nbytes, "flops": flops,
           "worst_of_limit": kchk["worst_of_limit"],
           "mismatch_share": kchk["mismatch_share"],
           "state_rel_err": kchk["state_rel_err"],
           "control_rounded_m": cchk, "ptxas": ptxas,
           "shape": f"x ({b},{s},{h},{p}) bf16 views, B/C ({b},{s},{g_},"
                    f"{n}), Q {q}"}
    log(f"ssd_scan at the serve prefill shape: {ms:.4f} ms (bound "
        f"{out['bound_ms']:.4f}, {out['bound_by']}; plain {plain_ms:.3f}); "
        f"routes {routes}; batch {lb} x {ls}: {long_routes}; ptxas {ptxas}")
    return out


# ------------------------------------------------------------------ phase 3
def _model(chain: bool = False):
    """The main paths' model, or (``chain``) phase 3c's reduced config."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    if chain:
        return build_model(get_config(CHAIN_ARCH, reduced=True))
    return build_model(get_config(ARCH, reduced=REDUCED).replace(
        num_layers=NUM_LAYERS))


def _launch_counts():
    from repro_torch.kernels import block_fp as bfp
    from repro_torch.kernels import block_gather as bg
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_adamw as fadam
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import ssd_scan as ssd

    return {"block_fp": bfp.KERNEL, "fused_adamw": fadam.KERNEL,
            "block_gather": bg.KERNEL, "flash_attention": fa.KERNEL,
            "ssd_scan": ssd.KERNEL, "quantize": qz.QUANTIZE,
            "dequantize": qz.DEQUANTIZE}


def _zero_counts() -> None:
    for k in _launch_counts().values():
        k.launches = 0


def _read_counts() -> dict:
    return {n: k.launches for n, k in _launch_counts().items()}


def check_store(torch, dev, root: Path, policy: str, merged_step: int,
                model=None) -> dict:
    """A store's step-``merged_step`` manifest merges units of two events;
    after a restore of LATEST every unit's device fingerprints equal its
    stored table; an unchanged re-save moves nothing.  ``model`` defaults
    to the main paths' model."""
    from repro_torch.checkpoint import fingerprint as fputil
    from repro_torch.checkpoint.saver import CheckpointManager
    from repro_torch.core.layer_registry import LayerRegistry
    from repro_torch.core.policies import make_policy
    from repro_torch.kernels import block_fp as bfp
    from repro_torch.launch import steps

    model = model or _model()
    registry = LayerRegistry(model)
    mgr = CheckpointManager(root, registry,
                            make_policy(policy, model.layer_units()),
                            async_save=False)
    merged = mgr.manifests.load(merged_step)
    steps_of = {r.step for kinds in merged.entries.values()
                for r in kinds.values()}
    if steps_of != {merged_step - CKPT_INTERVAL, merged_step}:
        raise AssertionError(f"step-{merged_step} manifest is not a merge: "
                             f"{steps_of}")
    state = mgr.restore(steps.state_specs(model), device=dev)
    restore = dict(mgr.last_restore_stats)
    latest = mgr.manifests.load()
    for name in registry.unit_names():
        for kind in ("weights", "opt"):
            tree = (registry.extract_unit(state["params"], name)
                    if kind == "weights" else
                    registry.extract_opt_unit(state["opt"], name))
            cur = bfp.tree_to_host(bfp.fingerprint_tree(tree))
            ref_tbl = mgr.store.load_fp_table(
                latest.entries[name][kind].digest)
            if fputil.pack_table(cur) != fputil.pack_table(ref_tbl):
                raise AssertionError(f"{root.name}: {name}/{kind}: device "
                                     "fingerprints differ from the stored "
                                     "table")
    mgr.save(state, step=int(state["step"]), units=registry.unit_names())
    resave = dict(mgr.last_save_stats)
    if resave["d2h_bytes"] != 0 or resave["written_bytes"] != 0:
        raise AssertionError(f"unchanged re-save moved bytes: {resave}")
    mgr.close()
    del state
    torch.cuda.empty_cache()
    return {"restore_check": restore,
            "resave": {k: resave[k] for k in ("seconds", "d2h_bytes",
                                              "written_bytes", "dedup_hits")}}


def _check_losses(ref, res, tol_of, what: str) -> dict:
    """Per-step |resumed loss - reference loss|; ``tol_of(step)`` is the
    bound of each resumed step (1-based), and every step must have one."""
    for _, loss in ref["losses"] + res["losses"]:
        if not math.isfinite(loss):
            raise AssertionError(f"{what}: non-finite loss {loss}")
    ref_loss = dict(ref["losses"])
    diffs = {s + 1: abs(l - ref_loss[s]) for s, l in res["losses"]}
    bad = {s: d for s, d in diffs.items() if not d <= tol_of(s)}
    if bad:
        raise AssertionError(f"{what}: resumed losses off the reference: "
                             f"{diffs}")
    return diffs


def _check_launched(launches: dict, names, what: str) -> None:
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched by {what}")


def phase_3a(torch, dev, store: Path, out: dict) -> dict:
    """Synchronous saves, inline writes (the first slice's path).  Fills
    ``out`` before its checks, so a failed check still leaves a record;
    returns the reference run."""
    from repro_torch.launch.train import SimulatedFailure, train

    kw = dict(arch=ARCH, reduced=REDUCED, num_layers=NUM_LAYERS,
              batch=BATCH, seq_len=SEQ, policy_name="parity", seed=SEED,
              device=str(dev), ckpt_async=False)
    _zero_counts()
    t0 = time.perf_counter()
    ref = train(ckpt_dir=str(store / "ref"), total_steps=REF_STEPS,
                ckpt_interval=REF_STEPS + 1, **kw)
    try:
        train(ckpt_dir=str(store / "run"), total_steps=STEPS,
              ckpt_interval=CKPT_INTERVAL, fail_at=FAIL_AT, **kw)
        raise AssertionError("the checkpointed run did not fail")
    except SimulatedFailure as e:
        failed = e
    res = train(ckpt_dir=str(store / "run"), total_steps=STEPS,
                ckpt_interval=CKPT_INTERVAL, resume=True, **kw)
    torch.cuda.synchronize()
    launches = _read_counts()
    wall = time.perf_counter() - t0
    log(f"phase 3a done in {wall:.1f} s; launches {launches}")
    out.update({
        "config": f"{ARCH} full width, {NUM_LAYERS} layers, batch {BATCH}, "
                  f"seq {SEQ}, parity, ckpt every {CKPT_INTERVAL}, sync "
                  "saves, inline writes",
        "launches": launches,
        "step_seconds_median": statistics.median(ref["step_seconds"][1:]),
        "step_seconds_ref": ref["step_seconds"],
        "losses_ref": ref["losses"], "losses_failed_run": failed.losses,
        "losses_resumed": res["losses"],
        "save_events": failed.save_events + res["save_events"],
        "restore_on_resume": res["restore_stats"],
        "peak_device_bytes": res["peak_device_bytes"],
        "seconds": wall,
    })
    out["loss_diffs"] = _check_losses(ref, res, lambda s: LOSS_TOL,
                                      "phase 3a")
    _check_launched(launches, ("block_fp", "fused_adamw"), "phase 3a")
    out.update(check_store(torch, dev, store / "run", "parity", STEPS - 2))
    return ref


_EVENT_KEYS = ("step", "selected_units", "snapshot_seconds", "stage_seconds",
               "writeback_seconds", "commit_seconds", "gc_seconds",
               "stall_seconds", "seconds", "d2h_bytes",
               "written_bytes", "overflow_redispatches", "dirty_block_frac",
               "spread_slices", "tick_step_seconds", "full_chunks",
               "delta_chunks", "dedup_hits")


def _signature(root: Path, step: int) -> dict:
    from repro_torch.core.manifest import ManifestStore

    m = ManifestStore(root).load(step)
    return {f"{u}/{k}": (r.digest, r.stored, r.delta_base)
            for u, kinds in m.entries.items() for k, r in kinds.items()}


def phase_3b(torch, dev, store: Path, ref: dict, out: dict) -> None:
    """Overlapped saves: topk_delta, every 2 steps, spread over 2 steps,
    async writer; fail at step 7 with the step-6 event in flight, resume
    from the step-4 manifest to step 8.  Its control is the same run with
    synchronous saves that fails at step 5: the same decisions must give
    the same step-2 and step-4 manifests, and the two resumes from them
    the same losses."""
    from repro_torch.launch.train import SimulatedFailure, train

    kw = dict(arch=ARCH, reduced=REDUCED, num_layers=NUM_LAYERS,
              batch=BATCH, seq_len=SEQ, policy_name="topk_delta", seed=SEED,
              device=str(dev), total_steps=OV_STEPS,
              ckpt_interval=CKPT_INTERVAL, ckpt_async=True)
    ctl = store / "sync_control"
    try:
        train(ckpt_dir=str(ctl), fail_at=FAIL_AT, **kw)
        raise AssertionError("the sync control run did not fail")
    except SimulatedFailure as e:
        ctl_events = e.save_events
    ctl_sigs = {s: _signature(ctl, s) for s in (2, 4)}
    # saving does not change training: the control resumes without saves
    ctl_res = train(ckpt_dir=str(ctl), resume=True,
                    **{**kw, "ckpt_interval": OV_STEPS + 1})
    shutil.rmtree(ctl, ignore_errors=True)
    torch.cuda.empty_cache()

    run = store / "run"
    kw.update(ckpt_spread_steps=SPREAD, ckpt_dir=str(run))
    _zero_counts()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        train(fail_at=OV_FAIL_AT, **kw)
        raise AssertionError("the overlapped run did not fail")
    except SimulatedFailure as e:
        failed = e
    peak_failed = torch.cuda.max_memory_allocated(dev)
    latest = int((run / "LATEST").read_text())
    torch.cuda.reset_peak_memory_stats(dev)
    res = train(resume=True, **kw)
    torch.cuda.synchronize()
    launches = _read_counts()
    wall = time.perf_counter() - t0
    log(f"phase 3b done in {wall:.1f} s; launches {launches}")
    events = failed.save_events + res["save_events"]
    ctl_loss = dict(ctl_res["losses"])
    out.update({
        "config": f"{ARCH} full width, {NUM_LAYERS} layers, batch {BATCH}, "
                  f"seq {SEQ}, topk_delta, ckpt every {CKPT_INTERVAL}, "
                  f"spread {SPREAD}, async writer",
        "launches": launches,
        "latest_after_failure": latest,
        "losses_failed_run": failed.losses,
        "losses_resumed": res["losses"],
        "losses_sync_control": ctl_res["losses"],
        "diff_vs_sync_control": {s + 1: abs(l - ctl_loss[s])
                                 for s, l in res["losses"]},
        "step_seconds_resumed": res["step_seconds"],
        "save_events": [{k: e.get(k) for k in _EVENT_KEYS} for e in events],
        # the same events (identical manifests) saved synchronously
        "sync_control_events": [{k: e.get(k) for k in _EVENT_KEYS}
                                for e in ctl_events],
        "restore_on_resume": res["restore_stats"],
        "store_bytes_at_end": res["ckpt_bytes"],
        "peak_device_bytes": {"failed_run": peak_failed,
                              "resumed_run": res["peak_device_bytes"]},
        "seconds": wall,
    })
    if latest != 4:
        raise AssertionError(f"LATEST is {latest} after the failure at step "
                             f"{OV_FAIL_AT}, want 4 (event 6 in flight)")
    if [e["step"] for e in failed.save_events] != [2, 4]:
        raise AssertionError(f"failed run committed events "
                             f"{[e['step'] for e in failed.save_events]}")
    for e in events:
        if e["save_mode"] != "overlapped":
            raise AssertionError(f"event {e['step']} was not overlapped")
    for s in (2, 4):
        if _signature(run, s) != ctl_sigs[s]:
            raise AssertionError(f"step-{s} manifest differs from the sync "
                                 "control's")
    out["loss_diffs"] = _check_losses(
        ref, res, lambda s: LOSS_TOL if s <= STEPS else LATE_LOSS_TOL,
        "phase 3b")
    _check_losses(ctl_res, res, lambda s: MODE_TOL, "phase 3b vs control")
    _check_launched(launches, ("block_fp", "fused_adamw", "block_gather"),
                    "phase 3b")
    out.update(check_store(torch, dev, run, "topk_delta", 4))


def _step2_state(torch, dev):
    """(model, registry, state) of ``train`` after its first two steps in
    3f's configuration: the same model, schedule, registry, data and seed,
    so its units fingerprint to event 2's digests."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.layer_registry import LayerRegistry
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.launch import steps

    model = _model()
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=20,
                       total_steps=REF_STEPS, ckpt_interval=CKPT_INTERVAL,
                       seed=SEED)
    registry = LayerRegistry(model, weight_decay=tcfg.weight_decay)
    step = steps.make_train_step(model, tcfg, registry)
    data = SyntheticTokens(vocab_size=model.cfg.vocab_size, batch=BATCH,
                           seq_len=SEQ, seed=SEED)
    state = steps.init_state(model, SEED, dev)
    for i in range(2):
        tokens = torch.from_numpy(data.peek(i)["tokens"]).to(dev)
        state, m = step(state, {"tokens": tokens})
        float(m["loss"])
    return model, registry, state


def _check_cpu_path_objects(torch, dev, run: Path, scratch: Path) -> dict:
    """3f (a): event 2's block_000 objects (weights, opt) equal, byte for
    byte, those the port's CPU path (plain quantize, plain fingerprints)
    writes from the same unit copied to the host."""
    from repro_torch.checkpoint.saver import CheckpointManager
    from repro_torch.core.manifest import ManifestStore
    from repro_torch.core.policies import make_policy

    model, registry, state = _step2_state(torch, dev)
    event2 = ManifestStore(run).load(2).entries["block_000"]
    cpu = CheckpointManager(scratch, registry,
                            make_policy("parity", model.layer_units()),
                            async_save=False, codec="int8")
    out = {}
    for kind in ("weights", "opt"):
        tree = (registry.extract_unit(state["params"], "block_000")
                if kind == "weights" else
                registry.extract_opt_unit(state["opt"], "block_000"))
        host = _to_cpu(tree)
        acc = {"d2h_bytes": 0, "blocks_moved": 0, "blocks_total": 0,
               "fingerprint_seconds": 0.0, "d2h_seconds": 0.0,
               "write_seconds": 0.0}
        ref, _ = cpu._save_unit_fp(2, "block_000", kind, host, None, acc)
        want = event2[kind]
        if ref.digest != want.digest:
            raise AssertionError(f"3f (a): the replayed step-2 block_000 "
                                 f"{kind} is not event 2's content")
        got = cpu.store.object_path(ref.digest).read_bytes()
        if got != (run / want.relpath).read_bytes():
            raise AssertionError(f"3f (a): event 2's block_000 {kind} "
                                 "object differs from the CPU path's")
        out[kind] = {"object_bytes": len(got),
                     "cpu_path_d2h_bytes": acc["d2h_bytes"]}
        del host
    cpu.close()
    shutil.rmtree(scratch, ignore_errors=True)
    del state
    _release(torch)
    log(f"3f (a): event 2's block_000 objects equal the CPU path's: {out}")
    return out


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def _check_int8_restore(torch, dev, mgr, state, step: int) -> dict:
    """3f (c): every restored leaf equals ``dequantize_plain`` of its
    stored record on the card (raw records: their bytes), bitwise."""
    from repro_torch.checkpoint.serial import flatten_with_paths
    from repro_torch.checkpoint.workers import Int8Record
    from repro_torch.dtypes import byte_view
    from repro_torch.kernels import quantize as qz

    reg = mgr.registry
    m = mgr.manifests.load(step)
    n_int8 = n_raw = 0
    for name in reg.unit_names():
        for kind in ("weights", "opt"):
            tree = (reg.extract_unit(state["params"], name)
                    if kind == "weights" else
                    reg.extract_opt_unit(state["opt"], name))
            leaves = dict(flatten_with_paths(tree))
            items, _ = mgr.store.read_items(m.entries[name][kind].digest)
            for path, _, _, data in items:
                x = leaves[path]
                if isinstance(data, Int8Record):
                    raw = torch.frombuffer(bytearray(data.data),
                                           dtype=torch.uint8).to(dev)
                    want = byte_view(qz.dequantize_plain(
                        raw[:data.n_q].view(torch.int8),
                        raw[data.n_q:].view(torch.float32), x.numel(),
                        x.dtype))
                    n_int8 += 1
                else:
                    want = torch.frombuffer(bytearray(data),
                                            dtype=torch.uint8).to(dev)
                    n_raw += 1
                if not torch.equal(byte_view(x), want):
                    raise AssertionError(f"3f (c): restored {name}/{kind}/"
                                         f"{path} is not its stored record "
                                         "dequantized")
                del want
            del items
    return {"int8_leaves": n_int8, "raw_leaves": n_raw}


def _int8_payload_bytes(registry, state) -> int:
    """What an int8 save of every unit of ``state`` moves device->host (and
    a restore of it host->device): per unit leaf, its int8 record if the
    codec quantizes it, else its bytes."""
    from repro_torch.checkpoint import workers
    from repro_torch.checkpoint.serial import flatten_with_paths
    from repro_torch.dtypes import dtype_name
    from repro_torch.kernels import quantize as qz

    total = 0
    for name in registry.unit_names():
        for tree in (registry.extract_unit(state["params"], name),
                     registry.extract_opt_unit(state["opt"], name)):
            for _, x in flatten_with_paths(tree):
                total += (qz.record_nbytes(x.numel())
                          if workers.int8_eligible(dtype_name(x.dtype),
                                                   x.shape)
                          else x.numel() * x.element_size())
    return total


def phase_3f(torch, dev, store: Path, ref: dict, out: dict,
             lossless: dict) -> None:
    """The int8 codec on the main path: Yi-9B as 3a (parity, sync saves,
    inline writes) with ``codec="int8"``, failing at step 5 and resumed
    from the step-4 merge to step REF_STEPS; the losses are held against
    3a's uninterrupted run (``ref``).  Checks (a)-(f): see the module
    doc.  ``lossless`` holds 3a's record (event bytes) and 3d's store
    reads for comparison.  Fills ``out`` before its checks."""
    from repro_torch.checkpoint.saver import CheckpointManager
    from repro_torch.checkpoint.swap import WeightService
    from repro_torch.core.layer_registry import LayerRegistry
    from repro_torch.core.policies import make_policy
    from repro_torch.launch import steps
    from repro_torch.launch.train import SimulatedFailure, train

    run = store / "run"
    kw = dict(arch=ARCH, reduced=REDUCED, num_layers=NUM_LAYERS,
              batch=BATCH, seq_len=SEQ, policy_name="parity", seed=SEED,
              device=str(dev), ckpt_async=False, codec="int8",
              total_steps=REF_STEPS, ckpt_interval=CKPT_INTERVAL,
              ckpt_dir=str(run))
    _release(torch)
    _zero_counts()
    t0 = time.perf_counter()
    try:
        train(fail_at=FAIL_AT, **kw)
        raise AssertionError("3f: the int8 run did not fail")
    except SimulatedFailure as e:
        failed = e
    _release(torch)
    res = train(resume=True, **kw)
    torch.cuda.synchronize()
    launches = _read_counts()
    wall = time.perf_counter() - t0
    events = failed.save_events + res["save_events"]
    log(f"phase 3f train done in {wall:.1f} s; launches {launches}")
    a2 = next(e for e in lossless["3a_events"] if e["step"] == 2)
    ref_loss = dict(ref["losses"])
    diffs = {s + 1: abs(l - ref_loss[s]) for s, l in res["losses"]}
    out.update({
        "config": f"{ARCH} full width, {NUM_LAYERS} layers, batch {BATCH}, "
                  f"seq {SEQ}, parity, ckpt every {CKPT_INTERVAL}, sync "
                  "saves, inline writes, codec int8",
        "launches": launches,
        "losses_failed_run": failed.losses, "losses_resumed": res["losses"],
        "loss_diffs_vs_3a_reference": diffs,
        "loss_band": INT8_LOSS_BAND,
        "within_band": {s: d <= INT8_LOSS_BAND for s, d in diffs.items()},
        "save_events": [{k: e.get(k) for k in _EVENT_KEYS} for e in events],
        "event2_vs_3a": {"int8": {k: events[0][k] for k in (
            "d2h_bytes", "written_bytes", "seconds")},
            "lossless_3a": {k: a2[k] for k in (
                "d2h_bytes", "written_bytes", "seconds")}},
        "restore_on_resume": res["restore_stats"],
        "store_bytes_at_end": res["ckpt_bytes"],
        "peak_device_bytes": res["peak_device_bytes"],
        "seconds": wall,
    })
    log(f"3f losses vs 3a's uninterrupted run: {diffs} (band "
        f"{INT8_LOSS_BAND}); event 2: {out['event2_vs_3a']}")
    for _, loss in failed.losses + res["losses"]:
        if not math.isfinite(loss):
            raise AssertionError(f"3f: non-finite loss {loss}")
    if diffs[FAIL_AT] > INT8_LOSS_BAND:
        raise AssertionError(f"3f: the restored int8 merge's loss is "
                             f"{diffs[FAIL_AT]} off the reference")
    _check_launched(launches, ("block_fp", "fused_adamw", "quantize",
                               "dequantize"), "phase 3f")
    # (b) only records and raw small leaves crossed device->host
    if not events[0]["d2h_bytes"] < 0.35 * a2["d2h_bytes"]:
        raise AssertionError(f"3f (b): event 2 moved {events[0]['d2h_bytes']}"
                             f" bytes, 3a's {a2['d2h_bytes']}")
    # (d) no deltas: every entry of every manifest is a full object
    model = _model()
    registry = LayerRegistry(model)
    mgr = CheckpointManager(run, registry,
                            make_policy("parity", model.layer_units()),
                            async_save=False, codec="int8")
    for s in mgr.manifests.all_steps():
        for u, kinds in mgr.manifests.load(s).entries.items():
            for k, r in kinds.items():
                if r.stored != "full" or r.delta_base is not None:
                    raise AssertionError(f"3f (d): step {s} {u}/{k} is "
                                         f"{r.stored}")
    if any(e["delta_chunks"] for e in events):
        raise AssertionError("3f (d): an int8 event wrote a delta")
    out["cpu_path_objects"] = _check_cpu_path_objects(
        torch, dev, run, store / "cpu_path")
    _release(torch)
    like = steps.state_specs(model)
    state = mgr.restore(like, device=dev)
    out["restore_check"] = dict(mgr.last_restore_stats)
    # (b) event 2 saved every unit: exactly the records and the raw small
    # leaves crossed to the host, and the resume moved them back
    payload = _int8_payload_bytes(registry, state)
    out["int8_payload_bytes"] = payload
    if (events[0]["d2h_bytes"] != payload
            or res["restore_stats"]["h2d_bytes"] != payload):
        raise AssertionError(f"3f (b): event 2 moved {events[0]['d2h_bytes']}"
                             f" bytes and the resume "
                             f"{res['restore_stats']['h2d_bytes']}, the "
                             f"records hold {payload}")
    out["restored_vs_records"] = _check_int8_restore(
        torch, dev, mgr, state, int(state["step"]))
    names = registry.unit_names()
    mgr.save(state, step=REF_STEPS + 1, units=names)
    first = dict(mgr.last_save_stats)
    mgr.save(state, step=REF_STEPS + 2, units=names)
    again = dict(mgr.last_save_stats)
    out["resave"] = {"first": {k: first[k] for k in (
        "d2h_bytes", "written_bytes", "dedup_hits")},
        "unchanged": {k: again[k] for k in (
            "d2h_bytes", "written_bytes", "dedup_hits")}}
    if again["d2h_bytes"] != 0 or again["written_bytes"] != 0:
        raise AssertionError(f"3f (d): unchanged re-save moved bytes: "
                             f"{out['resave']}")
    del state
    _release(torch)
    # (f) serving from the int8 store
    svc = WeightService(mgr, like, device=dev, step=4)
    cold4 = dict(svc.restore_stats)
    swap6 = svc.swap(mgr.manifests.load(6))
    cold6 = mgr.restore({"params": like["params"]}, device=dev,
                        parts=("params",), step=6)
    exact = _params_equal(torch, svc.current(), cold6["params"])
    lossless_store = lossless.get("3d_store") or {}
    out["serve"] = {
        "cold_load_step4": {k: cold4[k] for k in ("seconds", "bytes_read",
                                                  "h2d_bytes")},
        "swap_4_to_6": {k: swap6[k] for k in (
            "seconds", "bytes_read", "h2d_bytes", "units_swapped",
            "units_skipped", "units_full", "units_scattered")},
        "cold_load_step6": {k: mgr.last_restore_stats[k]
                            for k in ("seconds", "bytes_read", "h2d_bytes")},
        "lossless_3d_cold_load_step4": {
            k: lossless_store.get("cold_load_step4", {}).get(k)
            for k in ("seconds", "bytes_read", "h2d_bytes")}}
    del svc, cold6
    mgr.close()
    log(f"3f serve: {out['serve']}")
    if not exact:
        raise AssertionError("3f (f): the swap 4 -> 6 is not a cold load "
                             "of 6")
    if swap6["units_full"] != swap6["units_swapped"]:
        raise AssertionError(f"3f (f): int8 units must be read whole: "
                             f"{swap6}")
    out["seconds_with_checks"] = time.perf_counter() - t0


def phase_3e_train(torch, dev, store: Path, out: dict) -> None:
    """Mamba2-370m at full width and depth (48 layers), batch SSM_BATCH x
    SSM_SEQ: an uninterrupted reference run of SSM_STEPS steps without
    saves; a run with overlapped topk_delta saves (every 2 steps, spread 2,
    2 writer threads) that fails at step 7 with the step-6 event in
    flight, and its resume from the step-4 manifest to step SSM_STEPS.
    Two controls, each failing at step 5 and resumed without further
    saves: the same topk_delta decisions saved synchronously (its step-2
    and step-4 manifests must equal the overlapped run's, its resumed
    losses the overlapped run's within MODE_TOL), and ``full`` saves,
    whose resume holds no stale unit and must give the reference run's
    losses within MODE_TOL.  The resumed topk_delta losses' distance to the
    reference run is the merge's (recorded, see PERF.md).  Also: finite
    losses, LATEST 4 after the failure, the step-4 manifest a merge of two
    events, restored device fingerprints equal to the stored tables, an
    unchanged re-save moving 0 bytes, and block_fp, block_gather and
    fused_adamw launched.  Fills ``out`` before its checks."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import SimulatedFailure, train
    from repro_torch.models import build_model

    kw = dict(arch=SSM_ARCH, reduced=REDUCED, batch=SSM_BATCH,
              seq_len=SSM_SEQ, policy_name="topk_delta", seed=SEED,
              device=str(dev), total_steps=SSM_STEPS,
              ckpt_interval=CKPT_INTERVAL, ckpt_async=True)
    no_saves = {"ckpt_interval": SSM_STEPS + 1}

    def control(name: str, policy: str):
        """A sync-saving run that fails at FAIL_AT and its resume without
        saves: (save events, step-2/4 signatures, resumed run)."""
        root = store / name
        ckw = dict(kw, policy_name=policy, ckpt_dir=str(root))
        try:
            train(fail_at=FAIL_AT, **ckw)
            raise AssertionError(f"3e: the {name} control did not fail")
        except SimulatedFailure as e:
            events = e.save_events
        sigs = {s: _signature(root, s) for s in (2, 4)}
        _release(torch)
        res = train(resume=True, **{**ckw, **no_saves})
        shutil.rmtree(root, ignore_errors=True)
        _release(torch)
        return events, sigs, res

    _release(torch)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    ref = train(ckpt_dir=str(store / "ref"), **{**kw, **no_saves})
    peak_ref = torch.cuda.max_memory_allocated(dev)
    shutil.rmtree(store / "ref", ignore_errors=True)
    full_events, _, full_res = control("full_control", "full")
    ctl_events, ctl_sigs, ctl_res = control("sync_control", "topk_delta")

    run = store / "run"
    kw.update(ckpt_spread_steps=SPREAD, writer_threads=2, ckpt_dir=str(run))
    _release(torch)
    _zero_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        train(fail_at=OV_FAIL_AT, **kw)
        raise AssertionError("the Mamba run did not fail")
    except SimulatedFailure as e:
        failed = e
    peak_failed = torch.cuda.max_memory_allocated(dev)
    latest = int((run / "LATEST").read_text())
    _release(torch)
    torch.cuda.reset_peak_memory_stats(dev)
    res = train(resume=True, **kw)
    torch.cuda.synchronize()
    launches = _read_counts()
    wall = time.perf_counter() - t0
    events = failed.save_events + res["save_events"]
    log(f"phase 3e train done in {wall:.1f} s; launches {launches}")
    cfg = get_config(SSM_ARCH, reduced=REDUCED)
    ref_loss = dict(ref["losses"])
    out.update({
        "config": f"{SSM_ARCH} full width and depth ({cfg.num_layers} "
                  f"layers), batch {SSM_BATCH}, seq {SSM_SEQ}, topk_delta, "
                  f"ckpt every {CKPT_INTERVAL}, spread {SPREAD}, 2 writer "
                  "threads",
        "launches": launches,
        "latest_after_failure": latest,
        "step_seconds_median": statistics.median(ref["step_seconds"][1:]),
        "step_seconds_ref": ref["step_seconds"],
        "losses_ref": ref["losses"], "losses_failed_run": failed.losses,
        "losses_resumed": res["losses"],
        "losses_sync_control": ctl_res["losses"],
        "losses_full_control": full_res["losses"],
        # the Frankenstein merge's distance to the uninterrupted run
        "merge_loss_gap": {s + 1: abs(l - ref_loss[s])
                           for s, l in res["losses"]},
        "step_seconds_resumed": res["step_seconds"],
        "save_events": [{k: e.get(k) for k in _EVENT_KEYS} for e in events],
        "sync_control_events": [{k: e.get(k) for k in _EVENT_KEYS}
                                for e in ctl_events],
        "full_control_events": [{k: e.get(k) for k in _EVENT_KEYS}
                                for e in full_events],
        "restore_on_resume": res["restore_stats"],
        "restore_full_control": full_res["restore_stats"],
        "store_bytes_at_end": res["ckpt_bytes"],
        "peak_device_bytes": {"reference_run": peak_ref,
                              "failed_run": peak_failed,
                              "resumed_run": res["peak_device_bytes"]},
        "seconds": wall,
    })
    log(f"3e merge loss gap {out['merge_loss_gap']}")
    if latest != 4:
        raise AssertionError(f"3e: LATEST is {latest} after the failure at "
                             f"step {OV_FAIL_AT}, want 4 (event 6 in flight)")
    if [e["step"] for e in failed.save_events] != [2, 4]:
        raise AssertionError(f"3e: failed run committed events "
                             f"{[e['step'] for e in failed.save_events]}")
    for e in events:
        if e["save_mode"] != "overlapped":
            raise AssertionError(f"3e: event {e['step']} was not overlapped")
    for s in (2, 4):
        if _signature(run, s) != ctl_sigs[s]:
            raise AssertionError(f"3e: step-{s} manifest differs from the "
                                 "sync control's")
    out["loss_diffs_full_control"] = _check_losses(
        ref, full_res, lambda s: MODE_TOL, "phase 3e full control vs the "
        "reference")
    out["loss_diffs_vs_sync_control"] = _check_losses(
        ctl_res, res, lambda s: MODE_TOL, "phase 3e vs its sync control")
    _check_launched(launches, ("block_fp", "fused_adamw", "block_gather"),
                    "phase 3e")
    out.update(check_store(torch, dev, run, "topk_delta", 4,
                           model=build_model(cfg)))


def _poke_state(torch, state, how: str, bb: int):
    """A drifted copy of a state: every leaf's first element ("all"), the
    last element of the biggest params leaf ("one"), or the first element
    of a few blocks of it ("blocks")."""
    from repro_torch.checkpoint.serial import flatten_with_paths

    out = clone_state(state)
    with torch.no_grad():
        if how == "all":
            for part in ("params", "opt"):
                for _, x in flatten_with_paths(out[part]):
                    x.view(-1)[:1] += 1
            return out
        big = max((x for _, x in flatten_with_paths(out["params"])),
                  key=lambda x: x.numel())
        flat = big.view(-1)
        if how == "one":
            flat[-1:] += 2
            return out
        epb = bb // big.element_size()
        nb = -(-big.numel() * big.element_size() // bb)
        for i in range(max(2, min(4, nb // 4))):
            flat[i * epb:i * epb + 1] += 3
    return out


def clone_state(state):
    if isinstance(state, dict):
        return {k: clone_state(v) for k, v in state.items()}
    return state.clone()


def phase_3c(torch, dev, store: Path) -> dict:
    """Sync and overlapped saves commit identical manifests and objects on
    the card, with the predictor pinned at 1 and at 2^20 blocks and the
    state overwritten in place right after every ``begin``."""
    from repro_torch.checkpoint.overlap import DirtyPredictor, OverlappedSaver
    from repro_torch.checkpoint.saver import CheckpointManager
    from repro_torch.checkpoint.serial import flatten_with_paths
    from repro_torch.core.layer_registry import LayerRegistry
    from repro_torch.core.policies import make_policy
    from repro_torch.launch import steps

    bb = 4096
    model = _model(chain=True)
    registry = LayerRegistry(model)
    s1 = steps.init_state(model, SEED, dev)
    s2 = _poke_state(torch, s1, "all", bb)
    s3 = _poke_state(torch, s2, "one", bb)
    s4 = _poke_state(torch, s3, "blocks", bb)
    states = [s1, s1, s2, s3, s4]
    events = [(10, 0), (20, 1), (30, 2), (40, 3), (50, 4)]

    class Fixed(DirtyPredictor):
        def __init__(self, n):
            super().__init__()
            self.n = n

        def predict(self, name, kind, path, n_blocks, drift):
            return min(max(1, self.n), n_blocks)

    def mgr_at(root, codec="none"):
        return CheckpointManager(root, registry,
                                 make_policy("full", model.layer_units()),
                                 fp_block_bytes=bb, codec=codec)

    def signature(mgr):
        sig = {}
        for step, _ in events:
            m = mgr.manifests.load(step)
            sig[step] = {(u, k): (e.digest, e.stored, e.delta_base)
                         for u, kinds in m.entries.items()
                         for k, e in kinds.items()}
        return sig, sorted(mgr.store.iter_digests())

    def sync_chain(root, codec):
        mgr = mgr_at(root, codec)
        for step, si in events:
            mgr.save(states[si], step=step)
        sig = signature(mgr)
        mgr.close()
        return sig

    want = sync_chain(store / "sync", "none")
    want_int8 = sync_chain(store / "sync-int8", "int8")
    out = {}
    for guess, codec in ((1, "none"), (1 << 20, "none"), (1, "int8")):
        tag = f"{guess}" if codec == "none" else f"{guess}_int8"
        mgr = mgr_at(store / f"ov-{tag}", codec)
        ov = OverlappedSaver(mgr, spread_steps=SPREAD)
        ov.predictor = Fixed(guess)
        overflows = 0
        for step, si in events:
            st = clone_state(states[si])
            ov.begin(st, step)
            with torch.no_grad():          # the next optimizer step
                for part in ("params", "opt"):
                    for _, x in flatten_with_paths(st[part]):
                        x.add_(1)
            del st
            while ov.tick() is None:
                pass
            overflows += mgr.last_save_stats["overflow_redispatches"]
        got = signature(mgr)
        ov.close()
        mgr.close()
        if got != (want if codec == "none" else want_int8):
            raise AssertionError(f"phase 3c: overlapped saves (predictor "
                                 f"{guess}, codec {codec}) differ from the "
                                 "sync saves")
        if (overflows > 0) != (guess == 1 and codec == "none"):
            raise AssertionError(f"phase 3c: predictor {guess} gave "
                                 f"{overflows} overflow re-dispatches")
        out[f"predictor_{tag}"] = {"overflow_redispatches": overflows}
    stored = {e[1] for m in want_int8[0].values() for e in m.values()}
    if stored != {"full"}:
        raise AssertionError(f"phase 3c: the int8 chain stored {stored}")
    torch.cuda.synchronize()
    log(f"phase 3c: sync and overlapped chains identical, codec none and "
        f"int8 ({out})")
    return {"events": len(events), "objects": len(want[1]),
            "objects_int8": len(want_int8[1]), **out}


def _release(torch) -> None:
    """Free what earlier phases left to the cycle collector (a caught
    SimulatedFailure's traceback holds the failed run's device state) before
    a phase measures device memory."""
    gc.collect()
    torch.cuda.empty_cache()


def _params_equal(torch, a, b) -> bool:
    from repro_torch.checkpoint.serial import flatten_with_paths

    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    return ([p for p, _ in fa] == [p for p, _ in fb]
            and all(x.dtype == y.dtype and torch.equal(x, y)
                    for (_, x), (_, y) in zip(fa, fb)))


def _check_serve_launches(launches: dict, want: dict) -> None:
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{name} launched {launches[name]} times in "
                                 f"the serve run, want {n}")


def serve_full_depth(torch, dev, out: dict, arch: str, want: dict,
                     decode_tol: float) -> None:
    """A published model at full width and depth on random bf16 weights
    through ``repro_torch.launch.serve.serve``: batch 8, 1024-token
    prompts, 128 greedy tokens.  Each kernel must launch as often as
    ``want`` says; then one decode step against the prefilled cache must
    give the logits of prefilling the longer prompt within ``decode_tol``,
    all finite."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model
    from repro_torch.optim import tree_leaves

    cfg = get_config(arch, reduced=REDUCED)
    _release(torch)
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    _zero_counts()
    t0 = time.perf_counter()
    res = serve(arch=arch, reduced=REDUCED, batch=SERVE_BATCH,
                prompt_len=SERVE_PROMPT, new_tokens=SERVE_NEW, seed=SEED,
                device=str(dev))
    torch.cuda.synchronize()
    launches = _read_counts()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    n_params = sum(math.prod(s.shape) for s in tree_leaves(
        build_model(cfg).param_specs()))
    out.update({
        "config": f"{arch} full width, {cfg.num_layers} layers "
                  f"({n_params} params, random bf16), batch {SERVE_BATCH}, "
                  f"prompt {SERVE_PROMPT}, {SERVE_NEW} new tokens",
        "launches": launches, "peak_device_bytes": peak,
        "allocated_before_bytes": before, "seconds": wall,
        **{k: res[k] for k in ("prefill_seconds", "decode_seconds",
                               "decode_tokens_per_s", "sample_tokens",
                               "tokens_digest")}})
    log(f"serve {arch} done in {wall:.1f} s: prefill "
        f"{res['prefill_seconds']:.3f} s, decode "
        f"{res['decode_tokens_per_s']:.1f} tokens/s, peak "
        f"{peak / 1e9:.2f} GB ({before / 1e9:.2f} GB allocated before); "
        f"launches {launches}")
    _check_serve_launches(launches, want)
    if not all(0 <= t < cfg.vocab_size for t in res["sample_tokens"]):
        raise AssertionError(f"tokens out of range: {res['sample_tokens']}")
    out["decode_vs_prefill"], out["decode_profile"] = _decode_checks(
        torch, dev, cfg, res["decode_seconds"] / SERVE_NEW, decode_tol)


def phase_3d_serve(torch, dev, out: dict) -> None:
    """Yi-9B at full width and depth: every prefill and decode attention
    launches ``flash_attention`` (layers x (1 + new tokens)); decode vs
    prefill within DECODE_TOL."""
    from repro_torch.configs import get_config

    n = get_config(ARCH, reduced=REDUCED).num_layers
    serve_full_depth(torch, dev, out, ARCH,
                     {"flash_attention": n * (1 + SERVE_NEW), "ssd_scan": 0},
                     DECODE_TOL)


def _decode_checks(torch, dev, cfg, step_seconds: float, tol: float):
    """On the serve run's weights and prompts: max |decode-step logits -
    prefill(T + 1) last logits| (the JAX package's consistency check,
    held to ``tol``), and the
    device's busy time over PROFILE_STEPS more decode steps
    (``_decode_profile``) beside the serve run's unprofiled step time."""
    import numpy as np

    from repro_torch.models import build_model

    model = build_model(cfg)
    params = model.init(SEED, dev, dtype=torch.bfloat16)
    rng = np.random.RandomState(SEED)
    toks = torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT + 1)).astype(
            np.int32)).to(dev)
    _, cache = model.prefill(params, {"tokens": toks[:, :-1]},
                             cache_len=SERVE_PROMPT + 1 + PROFILE_STEPS)
    ld, _ = model.decode_step(params, cache, {"tokens": toks[:, -1:],
                                              "pos": SERVE_PROMPT})
    profile = _decode_profile(torch, model, params, cache, toks[:, -1:],
                              step_seconds)
    del cache
    lf, _ = model.prefill(params, {"tokens": toks})
    if not (torch.isfinite(ld).all() and torch.isfinite(lf).all()):
        raise AssertionError("non-finite logits")
    err = (ld - lf).abs().max().item()
    log(f"decode vs prefill of the longer prompt: max abs {err:.4g}")
    del params
    torch.cuda.empty_cache()
    if not err < tol:
        raise AssertionError(f"decode step off the prefill of T + 1 tokens: "
                             f"{err}")
    return err, profile


def _decode_gap_float32(torch, dev, cfg) -> float:
    """The decode-vs-prefill comparison of ``_decode_checks`` with the
    model computing in float32 (float32 weights and activations, the
    ssd_scan kernel's float32 path, a float32 conv window), which takes
    bf16 rounding out of it: a decode step that does not continue the
    prefill's state and conv window shows here, rounding does not.  Held
    to DECODE_F32_TOL."""
    import numpy as np

    from repro_torch.models import build_model

    model = build_model(cfg, compute_dtype=torch.float32)
    params = model.init(SEED, dev)
    rng = np.random.RandomState(SEED)
    toks = torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT + 1)).astype(
            np.int32)).to(dev)
    _, cache = model.prefill(params, {"tokens": toks[:, :-1]})
    ld, _ = model.decode_step(params, cache, {"tokens": toks[:, -1:],
                                              "pos": SERVE_PROMPT})
    del cache
    lf, _ = model.prefill(params, {"tokens": toks})
    err = (ld - lf).abs().max().item()
    del params
    torch.cuda.empty_cache()
    log(f"decode vs prefill in float32: max abs {err:.4g}")
    if not err < DECODE_F32_TOL:
        raise AssertionError(f"float32 decode step off the prefill of T + 1 "
                             f"tokens: {err}")
    return err


def _decode_profile(torch, model, params, cache, tok,
                    step_seconds: float) -> dict:
    """Device time of PROFILE_STEPS decode steps traced by torch.profiler
    (every kernel, copy and fill on the card, summed), per step, and its
    share of ``step_seconds``, the serve run's unprofiled decode step;
    ``flash_ms`` is the flash_attention kernels' part.  None where the
    profiler shows no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(PROFILE_STEPS):
            model.decode_step(params, cache, {"tokens": tok,
                                              "pos": SERVE_PROMPT + 1 + i})
        torch.cuda.synchronize()
    busy_us = flash_us = 0.0
    n_kernels = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        busy_us += us
        n_kernels += 1
        if "flash_attention_kernel" in e.name:
            flash_us += us
    if busy_us == 0:
        log("decode profile: the profiler shows no device time "
            "(not measured)")
        return {"device_ms_per_step": None, "busy_share": None}
    ms = busy_us / 1e3 / PROFILE_STEPS
    out = {"device_ms_per_step": ms,
           "flash_ms_per_step": flash_us / 1e3 / PROFILE_STEPS,
           "device_events_per_step": n_kernels / PROFILE_STEPS,
           "step_ms_unprofiled": step_seconds * 1e3,
           "busy_share": ms / (step_seconds * 1e3)}
    log(f"decode profile: {out}")
    return out


def phase_3d_store(torch, dev, store: Path, full_restore_bytes: int,
                   out: dict, model=None, serve_kw=None,
                   drift: bool = True) -> None:
    """Serving from a training store (phase 3b's by default: the main
    paths' model, 2 layers): a weights-only cold load of step 4 that opens
    no optimizer object; a poll to LATEST (8) that must equal a cold
    weights-only load of 8 bit for bit, and ``serve`` hot-swapped from 4
    must generate the tokens of ``serve`` cold-loaded at 8; then
    (``drift``) a constructed drift of a few 64 KiB blocks of one block
    unit's weights, saved on top of a full object the server holds, must
    take the scatter path and stay bit-exact.  ``serve_kw`` names the
    served model to ``serve``."""
    from repro_torch.checkpoint.saver import CheckpointManager
    from repro_torch.checkpoint.serial import flatten_with_paths
    from repro_torch.checkpoint.swap import WeightService
    from repro_torch.core.layer_registry import LayerRegistry
    from repro_torch.core.policies import make_policy
    from repro_torch.launch import steps
    from repro_torch.launch.serve import serve

    _release(torch)
    model = model or _model()
    serve_kw = serve_kw or dict(arch=ARCH, reduced=REDUCED,
                                num_layers=NUM_LAYERS)
    registry = LayerRegistry(model)
    names = registry.unit_names()
    like = steps.state_specs(model)
    wlike = {"params": like["params"]}
    mgr = CheckpointManager(store, registry,
                            make_policy("parity", model.layer_units()),
                            async_save=False)
    opt_digests = {r.digest for s in mgr.manifests.all_steps()
                   for kinds in mgr.manifests.load(s).entries.values()
                   for k, r in kinds.items() if k == "opt"}
    opened = []
    read = mgr.store.read_envelope

    def spy(digest, *a, **kw):
        opened.append(digest)
        return read(digest, *a, **kw)

    mgr.store.read_envelope = spy
    t0 = time.perf_counter()
    svc = WeightService(mgr, like, device=dev, step=4)
    cold4 = dict(svc.restore_stats)
    mgr.store.read_envelope = read
    weights_bytes = sum(x.numel() * x.element_size()
                        for _, x in flatten_with_paths(svc.current()))
    out.update({"cold_load_step4": cold4, "weights_bytes": weights_bytes,
                "full_restore_bytes_step4": full_restore_bytes})
    log(f"3d cold weights-only load of step 4: {cold4['seconds']:.3f} s, "
        f"{cold4['bytes_read']} bytes (full state restore of the same "
        f"manifest: {full_restore_bytes})")
    if set(opened) & opt_digests or not opened:
        raise AssertionError("the weights-only load opened an optimizer "
                             "object")
    if not cold4["bytes_read"] < 0.25 * full_restore_bytes:
        raise AssertionError("the weights-only load read too much")

    swap8 = svc.poll()
    cold8 = mgr.restore(wlike, device=dev, parts=("params",), step=8)
    out.update({"swap_4_to_8": swap8,
                "cold_load_step8": dict(mgr.last_restore_stats)})
    log(f"3d swap 4 -> 8: {swap8}")
    if svc.step != 8 or not _params_equal(torch, svc.current(),
                                          cold8["params"]):
        raise AssertionError("the swap to 8 is not a cold load of 8")
    del cold8
    kw = dict(serve_kw, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
              new_tokens=SERVE_NEW, from_ckpt=str(store), device=str(dev))
    hot = serve(from_step=4, hot_swap=True, swap_wait=0.0, **kw)
    cold = serve(**kw)
    out["tokens_digest"] = {"hot_swapped": hot["tokens_digest"],
                            "cold_loaded": cold["tokens_digest"]}
    if not (hot["served_step"] == cold["served_step"] == 8
            and hot["tokens_digest"] == cold["tokens_digest"]):
        raise AssertionError(f"hot-swapped and cold-loaded servers differ: "
                             f"{hot['served_step']}/{cold['served_step']}, "
                             f"{out['tokens_digest']}")
    if not drift:
        mgr.close()
        out["seconds"] = time.perf_counter() - t0
        return

    # the constructed case: one block unit drifts everywhere (a full
    # object the server takes whole), then in a few blocks (a BD02 delta
    # against that object: the scatter path)
    unit = names[2]
    state = mgr.restore(like, device=dev)
    leaves = [x for _, x in flatten_with_paths(
        registry.extract_unit(state["params"], unit))]
    with torch.no_grad():
        for x in leaves:
            x.add_(1)
    mgr.save(state, step=10, units=[unit])
    swap10 = svc.poll()
    big = max(leaves, key=lambda x: x.numel()).view(-1)
    epb = 65536 // big.element_size()
    poked = [i for i in (0, 5, 9) if i * epb < big.numel()]
    with torch.no_grad():
        for i in poked:
            big[i * epb] += 1
    mgr.save(state, step=12, units=[unit])
    del state, leaves, big
    torch.cuda.empty_cache()
    swap12 = svc.poll()
    cold12 = mgr.restore(wlike, device=dev, parts=("params",), step=12)
    exact = _params_equal(torch, svc.current(), cold12["params"])
    del cold12
    mgr.close()
    out.update({"drifted_unit": unit, "swap_to_10": swap10,
                "swap_to_12": swap12, "seconds": time.perf_counter() - t0})
    log(f"3d swap 10 -> 12 ({unit}, {len(poked)} blocks): {swap12}")
    if not (swap10["units_full"] == 1
            and swap10["units_skipped"] == len(names) - 1):
        raise AssertionError(f"swap to 10: {swap10}")
    if not (swap12["units_scattered"] == 1 and swap12["units_full"] == 0
            and swap12["units_skipped"] == len(names) - 1
            and swap12["blocks_applied"] == len(poked)
            and swap12["h2d_bytes"] < SWAP_H2D_FRAC * weights_bytes):
        raise AssertionError(f"swap to 12 did not scatter a few blocks: "
                             f"{swap12}")
    if not exact:
        raise AssertionError("the scattered swap is not a cold load of 12")


def _train_step_profile(torch, dev, step_seconds: float) -> dict:
    """Device time of one Mamba2-370m train step (phase 3e's shape, a
    fresh state, after one warm step) traced by torch.profiler: every
    kernel, copy and fill on the card, summed; the number of device events
    and of host kernel launches; the busy share of ``step_seconds``, the
    reference run's unprofiled median step.  None where the profiler shows
    no device events."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import steps
    from repro_torch.models import build_model

    model = build_model(get_config(SSM_ARCH, reduced=REDUCED))
    state = steps.init_state(model, SEED, dev)
    step = steps.make_train_step(model, TrainConfig(
        learning_rate=1e-3, warmup_steps=20, total_steps=SSM_STEPS))
    rng = np.random.RandomState(SEED)
    tokens = [torch.from_numpy(rng.randint(
        0, model.cfg.vocab_size, (SSM_BATCH, SSM_SEQ)).astype(
            np.int32)).to(dev) for _ in range(2)]
    state, m = step(state, {"tokens": tokens[0]})
    float(m["loss"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, m = step(state, {"tokens": tokens[1]})
        float(m["loss"])
        torch.cuda.synchronize()
    busy_us = 0.0
    n_dev = n_launch = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            busy_us += e.time_range.elapsed_us()
            n_dev += 1
        elif e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                        "cudaLaunchKernelExC"):
            n_launch += 1
    del state, step, model
    _release(torch)
    if busy_us == 0:
        log("train step profile: the profiler shows no device time "
            "(not measured)")
        return {"device_ms": None, "busy_share": None}
    out = {"device_ms": busy_us / 1e3, "device_events": n_dev,
           "host_kernel_launches": n_launch,
           "step_ms_unprofiled": step_seconds * 1e3,
           "busy_share": busy_us / 1e3 / (step_seconds * 1e3)}
    log(f"train step profile: {out}")
    return out


def phase_3e(torch, dev, store: Path, out: dict) -> None:
    """Mamba2-370m at full width and depth: train, save, fail and resume
    (``phase_3e_train``), serve from that store (weights-only cold load,
    hot-swap to LATEST, hot vs cold tokens) before it is removed, then
    serve on random weights: ``ssd_scan`` once per layer in the prefill
    (the decode is a recurrent step), decode vs prefill in bf16 within
    DECODE_SSM_TOL and in float32 within DECODE_F32_TOL, the bf16 prefill
    within SSD_PREFILL_TOL of the plain scan's forward."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(SSM_ARCH, reduced=REDUCED)
    phase_3e_train(torch, dev, store, out["train"])
    out["train"]["step_profile"] = _train_step_profile(
        torch, dev, out["train"]["step_seconds_median"])
    phase_3d_store(torch, dev, store / "run",
                   out["train"]["restore_on_resume"]["bytes_read"],
                   out["store"], model=build_model(cfg),
                   serve_kw=dict(arch=SSM_ARCH, reduced=REDUCED), drift=False)
    shutil.rmtree(store, ignore_errors=True)
    serve_full_depth(torch, dev, out["serve"], SSM_ARCH,
                     {"flash_attention": 0, "ssd_scan": cfg.num_layers},
                     DECODE_SSM_TOL)
    out["serve"]["decode_vs_prefill_float32"] = _decode_gap_float32(
        torch, dev, cfg)
    out["serve"]["prefill_vs_plain_scan"] = _prefill_vs_plain_scan(
        torch, dev, cfg)


def _prefill_vs_plain_scan(torch, dev, cfg) -> float:
    """Max |last logits of the bf16 prefill (``ssd_scan``) - those of the
    training path (the plain chunked scan)| on the serve run's weights and
    the longer prompt, held to SSD_PREFILL_TOL.  Launches made here are
    not counted: the serve run's counts were read before."""
    import numpy as np

    from repro_torch.models import build_model

    model = build_model(cfg)
    params = model.init(SEED, dev, dtype=torch.bfloat16)
    toks = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT + 1)).astype(
            np.int32)).to(dev)
    with torch.no_grad():
        lf, _ = model.prefill(params, {"tokens": toks})
        lt = model.logits(params, toks)[:, -1]
    err = (lf - lt).abs().max().item()
    del params, lf, lt
    torch.cuda.empty_cache()
    log(f"bf16 prefill vs the plain scan's forward: max abs {err:.4g}")
    if not err < SSD_PREFILL_TOL:
        raise AssertionError(f"the ssd_scan prefill is off the plain scan's "
                             f"forward at full depth: {err}")
    return err


def write_record(record: dict, path) -> None:
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(record, indent=1))


def report(record: dict, path) -> None:
    """Fill the kernels' launch counts from the main paths, rewrite the
    record, log the per-event split and print the summary lines."""
    kernels, mp = record["kernels"], record["main_path"]
    mp_a, mp_b, mp_c, mp_d = mp["3a"], mp["3b"], mp["3c"], mp["3d"]
    mp_e = mp["3e"]
    for k in kernels:
        if k["name"] == "flash_attention":     # the serving path
            k["launches"] = mp_d["serve"]["launches"][k["name"]]
        elif k["name"] == "ssd_scan":          # the Mamba serving path
            k["launches"] = mp_e["serve"]["launches"][k["name"]]
        elif k["name"] in ("quantize", "dequantize"):  # the int8 path
            k["launches"] = mp["3f"]["launches"][k["name"]]
        else:                                  # the training paths
            k["launches"] = mp_b["launches"][k["name"]]
            k["launches_sync_path"] = mp_a["launches"][k["name"]]
            k["launches_mamba_path"] = mp_e["train"]["launches"][k["name"]]
    write_record(record, path)
    a_secs = {e["step"]: e["seconds"] for e in mp_a["save_events"]}
    ctl_secs = {e["step"]: e["seconds"]
                for e in mp_b["sync_control_events"]}
    for e in mp_b["save_events"]:
        log(f"3b event {e['step']}: stall {e['stall_seconds']:.3f} s "
            f"(snapshot {e['snapshot_seconds']:.3f}, stage "
            f"{e['stage_seconds']:.3f}, writeback "
            f"{e['writeback_seconds']:.3f}, commit "
            f"{e['commit_seconds']:.3f}, gc {e['gc_seconds']:.3f}), d2h "
            f"{e['d2h_bytes']}, dirty {e['dirty_block_frac']:.3f}, "
            f"overflows {e['overflow_redispatches']}, ticked steps "
            f"{e['tick_step_seconds']}; sync control event: "
            f"{ctl_secs.get(e['step'])} s; 3a event: "
            f"{a_secs.get(e['step'])} s")
    summary = {
        "3a": {k: mp_a[k] for k in ("step_seconds_median", "loss_diffs",
                                    "launches", "peak_device_bytes")}
        | {"event_seconds": a_secs},
        "3b": {k: mp_b[k] for k in ("loss_diffs", "diff_vs_sync_control",
                                    "launches", "peak_device_bytes",
                                    "save_events", "sync_control_events",
                                    "store_bytes_at_end")},
        "3c": mp_c,
        "3d": {k: mp_d["serve"][k] for k in (
            "prefill_seconds", "decode_tokens_per_s", "peak_device_bytes",
            "allocated_before_bytes", "launches", "decode_vs_prefill",
            "decode_profile")}}
    card = {"card": record["card"]}
    print(json.dumps({"main_path": summary | card}))
    st = mp_d["store"]
    print(json.dumps({"serve": {
        "cold_load_step4": {k: st["cold_load_step4"][k]
                            for k in ("seconds", "bytes_read", "h2d_bytes")},
        "full_restore_bytes_step4": st["full_restore_bytes_step4"],
        "weights_bytes": st["weights_bytes"],
        **{k: st[k] for k in ("swap_4_to_8", "swap_to_10", "swap_to_12")},
        **card}}))
    et, es, ev = mp_e["train"], mp_e["store"], mp_e["serve"]
    for e in et["save_events"]:
        log(f"3e event {e['step']}: stall {e['stall_seconds']:.3f} s "
            f"(snapshot {e['snapshot_seconds']:.3f}, stage "
            f"{e['stage_seconds']:.3f}, writeback "
            f"{e['writeback_seconds']:.3f}, commit "
            f"{e['commit_seconds']:.3f}), d2h {e['d2h_bytes']}, units "
            f"{e['selected_units']}")
    print(json.dumps({"mamba": {
        "train": {k: et[k] for k in ("config", "step_seconds_median",
                                     "merge_loss_gap",
                                     "loss_diffs_full_control",
                                     "loss_diffs_vs_sync_control",
                                     "launches", "peak_device_bytes",
                                     "store_bytes_at_end", "step_profile")}
        | {"event_stall_seconds": {e["step"]: e["stall_seconds"]
                                   for e in et["save_events"]},
           "restore_seconds": et["restore_on_resume"]["seconds"],
           "restore_bytes": et["restore_on_resume"]["bytes_read"]},
        "store": {"cold_load_step4": {k: es["cold_load_step4"][k] for k in (
            "seconds", "bytes_read", "h2d_bytes")},
            "weights_bytes": es["weights_bytes"],
            "swap_4_to_8": {k: es["swap_4_to_8"][k] for k in (
                "seconds", "bytes_read", "h2d_bytes", "units_swapped",
                "units_skipped", "units_scattered", "units_full")},
            "tokens_digest": es["tokens_digest"]},
        "serve": {k: ev[k] for k in (
            "config", "prefill_seconds", "decode_tokens_per_s",
            "peak_device_bytes", "launches", "decode_vs_prefill",
            "decode_vs_prefill_float32", "prefill_vs_plain_scan",
            "decode_profile")}, **card}}))
    mp_f = mp["3f"]
    for e in mp_f["save_events"]:
        log(f"3f event {e['step']}: {e['seconds']:.3f} s, d2h "
            f"{e['d2h_bytes']}, written {e['written_bytes']}, full "
            f"{e['full_chunks']}, dedup {e['dedup_hits']}")
    print(json.dumps({"int8": {k: mp_f[k] for k in (
        "config", "loss_diffs_vs_3a_reference", "within_band",
        "event2_vs_3a", "launches", "peak_device_bytes",
        "store_bytes_at_end", "cpu_path_objects", "restored_vs_records",
        "resave", "serve")}
        | {"restore_seconds": mp_f["restore_on_resume"]["seconds"],
           "restore_bytes": mp_f["restore_on_resume"]["bytes_read"],
           "restore_h2d_bytes": mp_f["restore_on_resume"]["h2d_bytes"],
           "event_seconds": {e["step"]: e["seconds"]
                             for e in mp_f["save_events"]}} | card}))
    print(json.dumps({"kernels": [k | card for k in kernels]}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--record", type=Path,
                    help="also write the full record of every phase here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device available")
        return 2
    from repro_torch.kernels._build import BUILDER

    card = card_line()
    log(f"card: {card}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = t_start = time.perf_counter()
    BUILDER.build(["block_fp", "fused_adamw", "block_gather",
                   "flash_attention", "ssd_scan", "quantize"])
    for name, text in BUILDER.logs.items():
        log(f"--- nvcc {name}.cu ---\n{text.strip()}")
    log(f"kernels built in {time.perf_counter() - t:.1f} s")

    check_block_fp_dtypes(torch, dev)
    check_block_gather_cases(torch, dev)
    kernels = [block_fp_at_main_shapes(torch, dev)]
    torch.cuda.empty_cache()
    kernels.append(fused_adamw_at_main_shapes(torch, dev))
    torch.cuda.empty_cache()
    flash_err = check_flash_attention_cases(torch, dev)
    kernels.append(flash_attention_at_main_shapes(torch, dev, flash_err))
    ssd_err = check_ssd_scan_cases(torch, dev)
    kernels.append(ssd_scan_at_main_shape(torch, dev, ssd_err))
    check_quantize_cases(torch, dev)
    kernels.extend(quantize_at_main_shapes(torch, dev))
    log(f"phase 2 done at {time.perf_counter() - t_start:.1f} s")

    store = ROOT / "build" / "chip_smoke_store"
    shutil.rmtree(store, ignore_errors=True)
    store.mkdir(parents=True)
    free = shutil.disk_usage(store).free
    log(f"{free / 1e9:.1f} GB free under {store}")
    if free < STORE_BYTES_NEEDED:
        raise RuntimeError(f"only {free / 1e9:.1f} GB free under {store}; "
                           f"the main paths write about 25 GB at a time")
    record = {"card": card, "kernels": kernels,
              "main_path": {"3a": {}, "3b": {}, "3c": {},
                            "3d": {"serve": {}, "store": {}},
                            "3e": {"train": {}, "store": {}, "serve": {}},
                            "3f": {}}}
    mp = record["main_path"]
    try:
        ref = phase_3a(torch, dev, store / "3a", mp["3a"])
        shutil.rmtree(store / "3a", ignore_errors=True)
        torch.cuda.empty_cache()
        log(f"phase 3a done at {time.perf_counter() - t_start:.1f} s")
        phase_3b(torch, dev, store / "3b", ref, mp["3b"])
        kernels.append(block_gather_at_main_shape(torch, dev,
                                                  store / "3b" / "run"))
        log(f"phase 3b done at {time.perf_counter() - t_start:.1f} s")
        phase_3d_store(torch, dev, store / "3b" / "run",
                       mp["3b"]["restore_on_resume"]["bytes_read"],
                       mp["3d"]["store"])
        log(f"phase 3d (store) done at {time.perf_counter() - t_start:.1f} s")
        shutil.rmtree(store / "3b", ignore_errors=True)
        phase_3f(torch, dev, store / "3f", ref, mp["3f"],
                 {"3a_events": mp["3a"]["save_events"],
                  "3d_store": mp["3d"]["store"]})
        shutil.rmtree(store / "3f", ignore_errors=True)
        log(f"phase 3f done at {time.perf_counter() - t_start:.1f} s")
        mp["3c"].update(phase_3c(torch, dev, store / "3c"))
        log(f"phase 3c done at {time.perf_counter() - t_start:.1f} s")
        phase_3d_serve(torch, dev, mp["3d"]["serve"])
        log(f"phase 3d (serve) done at {time.perf_counter() - t_start:.1f} s")
        phase_3e(torch, dev, store / "3e", mp["3e"])
        log(f"phase 3e done at {time.perf_counter() - t_start:.1f} s")
    finally:
        shutil.rmtree(store, ignore_errors=True)
        write_record(record, args.record)
    report(record, args.record)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
