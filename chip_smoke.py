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
   non-causal, ragged-Sk, G = H, G = 1, bf16/float32, D 64/128 cases,
   decode steps on strided cache views (D 128 and 80), and cases at the
   edges of its three routes (bf16 prefill on tensor cores, bf16 split-K
   decode, float32): Sq on either side of ``ops.PREFILL_MIN_QUERIES``,
   causal and not, D 64, G = 1, G = H, Sk = 1 and 4097, and head dim 80
   (Zamba2) on each route (every route must be reached), and MLA's split
   head dims (``MLA_FLASH_CASES``: Dqk 192 / Dv 128 on the prefill and
   float32 routes, the absorbed decode's 576 / 512 over views of one
   cache's rows at scale 192^-1/2 on the decode and float32 routes; every
   route reached); then timed beside its plain version and SDPA (event
   time of one call, profiler device time, kernels per call) at the serve
   path's prefill and decode shapes at Yi-9B's heads, at Zamba2-2.7B's
   (32 / 32, D 80) and at DeepSeek-V2-Lite's MLA (16 heads; the prefill
   192 / 128, the absorbed decode 576 / 512 over 1032 cache rows), each on
   the route the wrapper picks, and the float32 route at Yi-9B's prefill
   shape and both MLA shapes; every bf16 shape under the two-ulp check
   below, SDPA recorded under it as a control (null, with its error,
   where it refuses the shapes); ``ptxas``'s registers and spills of
   every flash kernel recorded;
   ``ssd_scan`` over full, ragged-S, odd-Q, S < Q, G = 1, G = 2 and G = H
   cases in bf16 and float32 through the wrapper (the f32 route, CUDA
   cores), at state dim 128 and (the wrapper alone; the bf16 route must
   refuse them) 64, the bf16 cases at 128 also on the bf16 route (tensor
   cores), on model-style strided views and contiguous inputs (two
   launches bitwise equal), then both routes at the Mamba2-370m serve
   prefill shape under the two-ulp check, with the plain version rounding
   its decayed scores to bf16 as a control the check must reject, and the
   wrapper timed beside its plain version; both routes timed on the same
   bf16 inputs (event and device time, kernels per call, device time by
   kernel) there and at batch 1 x 4096, with the bf16 route's scratch
   bytes and ``ptxas``'s registers and spills; the wrapper at Zamba2-2.7B's
   serve prefill shape (80 heads, N 64) under the two-ulp check and timed
   beside its plain version; ``quantize`` and
   ``dequantize`` (one source) bitwise against their plain versions over
   n in {1, 255, 256, 257, 64*256+3}, f32 and bf16, and blocks of zeros,
   half-way ties, the clip edge, denormals, an underflowing scale, NaN and
   Inf (scales only there), then at the main path's shapes (a Yi-9B
   block's optimizer unit, 27 f32 leaves, and its weights unit, 9 bf16
   leaves), timed (event time of one wrapper call, profiler device time
   and the wrapper's host time up to its launch), a kernels row each;
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
      on random bf16 weights, batch 8, 1024-token prompts, SERVE_NEW (16)
      new tokens (every serve of the command decodes 16, since the hybrid
      came: 128 before): every prefill and decode attention launches
      ``flash_attention`` and one decode step matches the prefill of the
      longer prompt;
   e. Mamba2-370m at full width, batch 4, seq 1024, training at 4 of its
      48 layers (``SSM_TRAIN_LAYERS``: the cut that keeps the command
      inside its 1200-s limit, from 12 with 3h's to pay for 3l): an 8-step
      reference run, an overlapped
      topk_delta run (every 2 steps, spread 2, 2 writer threads) that
      fails at step 7 with event 6 in flight and its resume to step 8,
      under the checks of 3a/3b, and one profiled step; from that store a
      weights-only cold load of step 4, a hot-swap to LATEST bit-identical
      to a cold load and hot vs cold ``tokens_digest``; then serving on
      random weights at SSM_SERVE_LAYERS (24) of its 48 layers (the cut
      that pays, with 3o's, for 3p), batch 8, 1024-token prompts, 16 new
      tokens, with exactly 24 ``ssd_scan`` launches in the prefill and one
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
   g. the explicit merge (``repro_torch.core.tailor``), right after 3a on
      its store: (a) ``python -m repro_torch.core.tailor`` in a child
      process assembles step 4's implicit merge from a recipe (base @4,
      the units @4 carries over from step 2 taken from @2), with entries
      equal to @4's and objects equal to the source's byte for byte; a
      resume from it to step 6 gives 3a's resumed losses within MODE_TOL
      and @6's digests; (b) a Frankenstein (base @6, block_001 and embed
      from @2, weights only), restored weights-only, fingerprints to each
      unit's source table on the card, and serves (batch 8 x 1024, 128
      tokens) the tokens of its zero-copy variant served from the run
      (``variant_select``); a ``VariantSet`` serves @2's block_001 bit for
      bit; (c) a source whose final_norm object (copied; every other
      object a hard link) has a payload byte flipped under a recomputed
      crc32 fails the verifying merge with ``ChunkCorruption`` and commits
      no manifest, while ``verify=False`` copies it; ``block_fp`` launched
      by the merges, ``fused_adamw`` by the resume, ``flash_attention`` by
      the serves;
   h. the canonical save path (``ckpt_fingerprint=False``) in 3a's
      configuration, after 3g, the counts set to 0 before each part:
      (c) on 3a's store, a resume to step 8 whose event writes canonical
      objects over fp bases (their tables checked by ``block_fp``), its
      losses recorded against 3a's reference run; a weights-only cold load
      of 6 hot-swapped to 8 equals a cold load of 8, and a hot-swapped and
      a cold-loaded server give one ``tokens_digest``; then 3a's store is
      removed; (a) 3a's failing run and resume on the canonical path (the
      resume without its step-6 event since 3l came: the cut that pays
      for it; since 3m, 3h's runs write their objects on
      CANON_WRITER_THREADS writer threads, not inline): the resumed
      losses within MODE_TOL of 3a's, step 4's
      objects holding 3a's step-4 tensors (the resume's restore checks
      each object's canonical digest; what it decoded fingerprints to 3a's
      step-4 entry digests), no ``block_fp`` launch, the events recorded beside 3a's; (b) the
      unchanged re-save
      of step 6's embed unit, from one restore of that unit from a
      hard-linked copy of 3a's step-6 store: fingerprinted on that copy
      (moves 0 B) and canonical on (a)'s root (moves and hashes the unit,
      writes 0 B, both objects dedup hits); (d) the merge (in this
      process; 3g drives the CLI) copies (a)'s step-4 XOR-delta weights
      units and their bases into a merge on step 4 (weights only),
      verified, byte for byte; (e) one canonical int8
      event and its restore, at 1 of the 2 layers (``CANON_INT8_LAYERS``,
      with (a)'s and 3e's the cut that pays for 3l): ``quantize`` and
      ``dequantize`` launched,
      block_000's objects equal to the CPU path's, the restored leaves to
      their records dequantized;
   i. the storage tiers in 3a's configuration, after 3h (budget 150 s):
      (a) 3a's failing run and resume (no save) through
      ``store_backend="tiered"`` (a RAM hot tier of 4 GiB spilling to the
      disk tree): the resumed
      losses equal 3a's within MODE_TOL, steps 2 and 4 hold 3a's digests
      (recorded before 3h), every drained object hashes to its name, the
      disk tree passes the store checks of 3a; (c) servers through
      ``tiered`` and ``local`` on (a)'s root (cold load of 2, hot-swap to
      4) serve equal parameters and one ``tokens_digest``; (b)
      ``remote3`` (RAM -> disk -> a simulated bucket, 2 ms an op, 1%
      seeded faults) with the bucket down during event 2, which commits
      disk-durable and degraded, healed and drained to full replication;
      a lost disk copy of a step-2 object read back from the bucket by a
      resume to 4, whose losses equal 3a's uninterrupted run; (d) a
      weights-only merge that takes block_000's weights from a live
      RAM-tier (``memory``) store into a local root, restored bit for
      bit, ``block_fp`` launched once per copied object; (b) and (d) are
      cut to fit the budget;
   j. the streaming restore and the process IO workers, right after 3a
      on its store (budget 110 s): (a) four restores of step 4 (3a's
      merge) into fresh states, sequential, streaming on 4 reader
      threads, streaming on the process backend (4 workers) and
      streaming with ``restore_verify=False``: every leaf equal to the
      sequential restore's, ``block_fp`` launched once per target by the
      verifying arms and never by the unverified one, no more objects
      read than planned; (b) 3a's failing run to step 4 with
      ``io_backend="process"``: losses, step-2/4 digests and object sizes
      equal to 3a's, the event stalls beside 3a's; (c) a cold load of
      step 4 through the server on the process backend: the parameters
      and ``tokens_digest`` of the thread backend's, the workers holding
      neither torch nor jax;
   k. the block cache, right after 3g on 3a's store, before 3h removes it
      (budget 60 s): three weights-only variants through ``VariantSet``
      (@6, and @6 with one of two block units' weights from @2): (a) on a
      manager with a 4 GiB RAM cache and on one without: parameters
      bitwise equal, cached backend reads equal to the distinct digests
      the manifests name and uncached to their sum over the variants, the
      cache's misses and hits the same, ``block_fp`` once per target per
      variant in both; (b) the cache in ``/dev/shm``: equal parameters,
      segments before ``close()`` and none after; (c) a 256 MiB budget
      (objects bypass) and half the distinct bytes (evictions), equal
      parameters; (d) the process backend: equal parameters, no worker
      restart; (e) ``serve(cache_mb=...)`` of one variant gives the
      uncached server's ``tokens_digest``;
   l. the store scrub, right after 3k on 3a's store, before 3h removes it
      (budget 60 s): (a) an audit (``mgr.scrub(repair=False)``): every
      object healthy, as many checked as the manifests name (entries and
      bases), ``block_fp`` once per table-checked object, the store's
      files and sizes unchanged and no ``QUARANTINE.json``; (b) on a
      hard-linked copy, a LATEST object (whose unit an older manifest
      holds under another digest) with a payload byte flipped under a
      recomputed crc32: ``train(resume=True, scrub_on_start=True)`` one
      step past LATEST reports it unrecoverable with its manifests and
      unit, writes ``QUARANTINE.json``, and its resume skips it
      (``quarantined_skipped``) without reading it, the unit's restored
      tensors fingerprinting on the card to the older object's table; the
      good bytes put back, a second scrub releases it and removes the file;
   m. the resiliency supervisor, after 3h removed 3a's store (budget 100
      s): ``repro_torch.launch.supervisor.Supervisor`` runs 3a's model and
      data (policy ``full``, a save every 3 steps, 6 steps) as child
      trainers on the card; attempt 0 is SIGKILLed at step 4, attempt 1
      resumes and gets SIGTERM at step 4 (a preemption save of every unit,
      exit 17), attempt 2 resumes and completes; the store scrubbed and a
      weights-only restore probed between attempts, here on the card:
      the kill loses at most 3 steps with event 3 committed, the
      preemption none, merged losses equal 3a's reference within
      MODE_TOL, every scrub checks what the manifests name and finds
      nothing unrecoverable, a last probe reads step 6; the children
      report this card, and ``block_fp`` and ``fused_adamw`` launched in
      them, ``block_fp`` here;
   n. shard-native saves (ROADMAP A4.1), last (budget 60 s): 3a's run saved
      by 4 virtual participants (events 2 and 4) fails at step 5 and
      resumes by 2 (event 6, the elastic path): every event's shard sets
      tile the model's leaves and take one ``block_fp`` launch per shard
      object; the resumed losses equal 3a's within MODE_TOL; the resume's
      restore of step 4 fingerprints to 3a's step-4 entry digests, unit
      by unit (3a's store is gone by then); owned restores of
      step 4 by each of 2 participants read fewer bytes than it and
      ``combine_states`` of them equals it bitwise; an unchanged 4-wide
      re-save moves and writes 0 B;
   o. the hybrid family (Zamba2-2.7B, ROADMAP A5) at full width, after 3n
      (budget 60 s): (a) training at 6 layers (one group: six Mamba2
      layers and the shared attention block), batch 2, seq 1024, policy
      ``full``: a 6-step reference, a run with synchronous saves every 2
      steps (its objects on CANON_WRITER_THREADS writer threads) that
      fails at step 5, and its resume from step 4, whose losses
      equal the reference's within MODE_TOL; step 2's manifest holds the
      ``shared_attn`` unit's weights and optimizer objects, ``block_fp``
      launches once per saved (unit, kind), ``fused_adamw`` alike on every
      step; (b) serving at HYBRID_SERVE_LAYERS (18, three groups) of its
      54 layers on random bf16 weights, batch 8, 1024-token prompts,
      HYBRID_NEW (8) new tokens: exactly 18 ``ssd_scan`` launches in the
      prefill and 3 ``flash_attention`` launches (one a shared invocation)
      in the prefill and in every decode step; one decode step matches
      the prefill of the longer prompt within DECODE_HYBRID_TOL in bf16
      and DECODE_F32_TOL in float32 (the kernels' float32 routes at N 64
      and D 80);
   p. the MoE family with MLA (DeepSeek-V2-Lite, ROADMAP A5) at full
      width, last (budget 75 s): (a) training at 2 layers (block_000, the
      unstacked dense first layer, and block_001, MoE), batch 2, seq 1024,
      policy ``full``: a 6-step reference, a run whose synchronous saves
      every 2 steps go through 4 virtual participants (a MoE block's
      optimizer object is 7.02 GB, past msgpack's bin) that fails at step
      5, and its resume from step 4 within MODE_TOL of the reference;
      step 2 holds both block units as shard sets, every object under
      2^32 - 1 bytes, ``block_fp`` once per shard object, ``fused_adamw``
      alike on every step, the aux loss finite; (b) serving at all 27
      layers on random bf16 weights, batch 8, 1024-token prompts, 8 new
      tokens: exactly 27 ``flash_attention`` launches in the prefill and
      in every decode step; (c) decode vs the prefill of the longer
      prompt at 27 layers in bf16 on a no-drop copy of the config within
      DECODE_MOE_TOL, each row's first differing expert choice a near tie
      (the published factor's gap recorded), and in float32 at 4 layers
      within DECODE_F32_TOL;
4. print the main paths' step/save/restore times, the serve line, the
   Mamba line, the int8 line, the merge line, the canonical path's
   ``{"legacy": ...}`` line, the tiers line, the ``{"io": ...}`` line,
   the ``{"cache": ...}`` line, the ``{"scrub": ...}`` line, the
   ``{"supervisor": ...}`` line, the ``{"sharded": ...}`` line, the
   ``{"hybrid": ...}`` line, the ``{"moe": ...}`` line, the kernels line,
   the card line, and last
   the ``{"ok": true, "device": ...}`` line; each phase logs its wall
   time; with ``--record PATH``, the full record of every phase also goes
   to PATH (written even when a check fails).

The stores live under ``build/`` in this checkout; a part's store, once
done with, is renamed into ``build/chip_smoke_trash`` and deleted on a
background thread while the next part runs (``REMOVER``), and whatever
is left goes at the end.  The child processes keep their bytecode under
``build/pycache`` (``cache_bytecode``).
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import glob
import json
import math
import os
import queue
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
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
# Phase 3o, Zamba2-2.7B at full width and depth (54 Mamba2 layers, 9
# shared attention invocations), the same comparison in bf16, set before
# its first card run from the JAX package's own gap: on one set of
# weights and tokens (batch 8 x 1024, scripts/mamba_decode_gap.py --arch
# zamba2-2.7b, CPU) the JAX HybridLM reads 0.057, 0.072 and 0.054 at 6,
# 12 and 24 layers (no trend with depth), the port 0.058, 0.072 and
# 0.052.  Held to twice the largest, as 3e's bound is ~1.6x its: the
# float32 comparison is the sharp one (a decode step that attends
# without its own key reads 0.064 here at 6 layers in bf16, 0.16 in
# float32 on the reduced model).
DECODE_HYBRID_TOL = 0.15
# Phase 3p, DeepSeek-V2-Lite at full width and depth (27 layers), the same
# comparison in bf16 on a copy of the config whose capacity factor is
# num_experts / top_k (no token dropped; at the published 1.25 the
# longer prefill drops the last token's choices, which a decode step never
# does), set before its first card run from the JAX package's own gap
# under that copy: on one set of weights and tokens (batch 8 x 1024,
# scripts/mamba_decode_gap.py --arch deepseek-v2-lite-16b, CPU) the JAX
# model reads 0.944 and 2.683 at 2 and 4 layers, the port 0.044 and
# 0.089.  Held to twice the largest, as 3o's bound.  The JAX package's gap
# is a routing flip: the decode step's router logits (bf16, rounded from
# float32 sums of another shape) pick another expert than the prefill's
# where the 6th and 7th probabilities nearly tie (a few % of tokens), and
# the token's output moves by that expert's share.  The no-drop copy does
# not remove that, so this bound catches only garbage; the float32
# comparison (DECODE_F32_TOL at MOE_F32_LAYERS) is the sharp one, and each
# row's first differing choice is recorded (``_route_flips``).
DECODE_MOE_TOL = 5.4
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
# the stores' peak: 3h (a)'s canonical run beside a hard-linked copy of
# 3a's step-6 store (3h's ``store_bytes`` records it)
STORE_BYTES_NEEDED = 40e9
CHAIN_ARCH = "llama3.2-3b"   # phase 3c, reduced config
SSM_ARCH = "mamba2-370m"     # phase 3e, full width
HYBRID_ARCH = "zamba2-2.7b"  # phase 3o, full width
MOE_ARCH = "deepseek-v2-lite-16b"  # phase 3p, full width
# 3e's training, its store part and its step profile run 4 of the 48
# layers, which keeps the command inside its 1200-s limit: cut from 12,
# with 3h's cuts, to pay for phase 3l (scripts/phase_time.py in turns:
# 84.1 s -> 68.3 s a turn, H100 80GB HBM3, 700 W); every check stays.
# 3e's serve on random weights stays at full depth.
SSM_TRAIN_LAYERS = 4
# 3e's serve and its checks at 24 of Mamba2-370m's 48 layers, and 3o's at
# 18 of Zamba2-2.7B's 54 (three groups): the cuts that pay, with 3o's
# objects on writer threads and 3e's device-only step trace, for phase 3p
# (the checks' bounds were set at these depths and deeper)
SSM_SERVE_LAYERS = 24
HYBRID_SERVE_LAYERS = 18
# 3h (e)'s canonical int8 event and its restore run 1 of 3a's 2 layers
# (with 3h (a)'s resume saving no event 6 and 3e's depth, the cut that
# pays for phase 3l); every check of (e) stays
CANON_INT8_LAYERS = 1
# 3h's trainer runs write their objects (each object's blake2b, XOR diff,
# framing and file write) on this many writer threads, not inline as 3a
# does: the cut that pays for phase 3m (inline, a canonical event stalls
# 36-72 s).  So 3h's events stand beside 3a's with two things changed,
# the path and the writes (the record says ``writes`` and
# ``writes_3a``).  Every check of 3h stays.
CANON_WRITER_THREADS = 4
SSM_BATCH = 4
SSM_SEQ = 1024
SSM_STEPS = 8

# Serving (phase 3d): Yi-9B at full width and depth on random weights
SERVE_BATCH = 8
SERVE_PROMPT = 1024
# Decode is host-bound (~0.1-0.16 s a full-depth step): 16 tokens keep
# every launch count exact and the decode rate measured at an eighth of
# 128 tokens' time (one of the cuts that pay for phase 3o)
SERVE_NEW = 16
# phase 2 times a decode step of flash_attention over this many keys: the
# middle of a 128-token decode after a 1024-token prompt, the shape timed
# since PR 16
FLASH_DECODE_KEYS = SERVE_PROMPT + 64
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


# Trees a part is done with go here and are deleted behind the next part.
TRASH = ROOT / "build" / "chip_smoke_trash"


class _Remover:
    """Deletes trees on one background thread: ``discard`` renames a tree
    into TRASH (on the same filesystem: its path is free at once) and queues
    its deletion, which runs while the next part does (an rmtree on the
    H100 machine's root filesystem takes ~0.23 s per GB).  When fewer than
    STORE_BYTES_NEEDED bytes are free, ``discard`` and ``free_bytes`` wait
    for the queue first.  ``seconds`` adds up the deletions' time."""

    def __init__(self) -> None:
        self._queue: queue.Queue = queue.Queue()
        self._thread = None
        self._n = 0
        self.seconds = 0.0

    def discard(self, path: Path) -> None:
        path = Path(path)
        if not path.exists():
            return
        TRASH.mkdir(parents=True, exist_ok=True)
        self._n += 1
        dst = TRASH / f"{self._n:04d}-{path.name}"
        os.rename(path, dst)
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="chip-smoke-remover")
            self._thread.start()
        self._queue.put(dst)
        self.free_bytes(TRASH)

    def _run(self) -> None:
        while True:
            path = self._queue.get()
            t = time.perf_counter()
            shutil.rmtree(path, ignore_errors=True)
            self.seconds += time.perf_counter() - t
            self._queue.task_done()

    def drain(self) -> None:
        """Wait until every queued tree is deleted."""
        self._queue.join()

    def free_bytes(self, path: Path) -> int:
        """The free bytes under ``path``, after the queue's deletions when
        fewer than STORE_BYTES_NEEDED are free."""
        free = shutil.disk_usage(path).free
        if free < STORE_BYTES_NEEDED:
            self.drain()
            free = shutil.disk_usage(path).free
        return free


REMOVER = _Remover()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cache_bytecode() -> dict:
    """Let the child processes this script starts (the merge CLI, the
    supervisor's trainers, IO workers) keep the bytecode of what they
    import under ``build/pycache``, also where the environment says not
    to write bytecode (``PYTHONDONTWRITEBYTECODE``, which then stays set
    for this process): where the Python installation holds none, every
    process compiles torch's sources again (seconds for ``import
    torch``, seconds more for the ``torch._dynamo`` that the first
    ``torch.utils.checkpoint`` call imports).  Returns what this
    interpreter says of its bytecode."""
    import torch

    tree = Path(torch.__file__).parent
    out = {"dont_write_bytecode": sys.dont_write_bytecode,
           "torch_pycache_files": len(list(
               (tree / "__pycache__").glob("*.pyc")))}
    os.environ.setdefault("PYTHONPYCACHEPREFIX",
                          str(ROOT / "build" / "pycache"))
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    return out | {"pycache_prefix": os.environ["PYTHONPYCACHEPREFIX"]}


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


def host_us(fn, kernel, reps: int) -> float:
    """Median microseconds of ``fn()``'s host work up to its kernel's
    launch: ``kernel.launch`` does nothing while it is timed (the wrapper
    builds its table and outputs, and launches nothing)."""
    kernel.launch = lambda *args: None
    try:
        times = []
        for _ in range(reps + 1):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    finally:
        del kernel.launch
    return statistics.median(times[1:]) * 1e6


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
    unit, each bitwise against its plain version and timed: event ms of
    one wrapper call (its host work included), profiler device ms, and
    host us of the wrapper up to its launch; one kernels row each."""
    from repro_torch.kernels import quantize as qz

    params, master, m, v, grads = yi_block_unit(torch, dev, seed=4)
    del grads
    opt = master + m + v
    rows = []

    def timed(fn, kernel, name) -> dict:
        dms, per_call = device_ms(torch, fn, 10, name)
        return {"ms": cuda_ms(fn, 10, torch), "device_ms": dms,
                "kernels_per_call": per_call,
                "host_us": host_us(fn, kernel, 50)}

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
        t = timed(lambda: qz.quantize_unit(unit), qz.QUANTIZE, "quantize")
        plain_ms = cuda_ms(lambda: [qz.quantize_plain(x) for x in unit], 3,
                           torch)
        t_bytes = (nin + nout) / HBM_BYTES_PER_S
        t_ops = 5 * elems / F32_OPS_PER_S    # abs, max, 2 div, rint+clamp
        rows.append({"name": "quantize", "unit": name, **t,
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
            t = timed(lambda: qz.dequantize_unit(recs, outs),
                      qz.DEQUANTIZE, "dequantize")
            plain_ms = cuda_ms(lambda: [qz.dequantize_plain(
                q, s, o.numel(), o.dtype) for (q, s), o in zip(recs, outs)],
                3, torch)
            t_ops = elems / F32_OPS_PER_S
            rows.append({"name": "dequantize", "unit": name, **t,
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
        log(f"{r['name']} at the {r['shape']}: {r['ms']:.4f} ms (device "
            f"{r['device_ms']}, host {r['host_us']:.1f} us, bound "
            f"{r['bound_ms']:.4f}, plain {r['plain_ms']:.3f})")
        out.append({
            "name": r["name"], "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/quantize.cu",
            "replaces": ("src/repro/kernels/quantize/kernel.py:32"
                         if r["name"] == "quantize" else
                         "src/repro/kernels/quantize/kernel.py:53"),
            "max_abs_err": 0.0,
            **{k: r[k] for k in ("unit", "ms", "device_ms",
                                 "kernels_per_call", "host_us", "plain_ms",
                                 "bound_ms", "bound_by")},
            "library_ms": None,
            "library_note": "no single PyTorch call derives per-block "
                            "scales from amax and rounds to int8 "
                            "(quantize_per_channel takes given scales and "
                            "returns a quantized tensor type)",
            "shape": r["shape"]})
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
    # the embed unit's optimizer state alone (the other units restore as
    # zeros)
    state = mgr.restore(steps.state_specs(model), device=dev, step=4,
                        parts=("opt",), units=["embed"])
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
        # head dim 80 (Zamba2) on each route
        (2, 160, 160, 32, 32, 80, True, "bfloat16",
         "prefill, D 80, causal, G = H"),
        (1, 77, 130, 8, 2, 80, False, "bfloat16",
         "prefill, D 80, ragged Sq < Sk, GQA"),
        (2, t, 300, 32, 32, 80, True, "bfloat16",
         "prefill, D 80, causal Sq = t < Sk"),
        (2, t - 1, 300, 32, 32, 80, False, "bfloat16", "decode, D 80"),
        (1, 1, 333, 8, 2, 80, False, "bfloat16", "decode, D 80, GQA"),
        (2, 100, 100, 32, 32, 80, True, "float32", "float32, D 80, causal"),
        (1, 64, 130, 8, 2, 80, False, "float32", "float32, D 80, GQA"),
    )


# MLA's split head dims (v narrower than q and k), each on the routes the
# model sends it to: the latent-expanded prefill (q and k 192 columns, v
# 128, 16 heads, causal) on the prefill and float32 routes, and the
# absorbed decode (q 576 columns over one kv head's latent-cache rows, v
# their first 512 columns, scaled by (128 + 64) ** -0.5) on the decode and
# float32 routes.  (B, Sq, Sk, H, G, Dqk, Dv, causal, dtype name, what)
MLA_DECODE_SCALE = 192 ** -0.5
MLA_FLASH_CASES = (
    (2, 160, 160, 16, 16, 192, 128, True, "bfloat16", "MLA prefill, causal"),
    (1, 77, 201, 16, 16, 192, 128, True, "bfloat16",
     "MLA prefill, ragged Sq < Sk"),
    (1, 3, 300, 8, 2, 192, 128, False, "bfloat16",
     "MLA prefill, Sq = 3, GQA"),
    (2, 70, 70, 16, 16, 192, 128, True, "float32", "MLA float32 prefill"),
    (8, 1, 1032, 16, 1, 576, 512, False, "bfloat16", "MLA absorbed decode"),
    (2, 1, 1, 16, 1, 576, 512, False, "bfloat16", "MLA decode, Sk = 1"),
    (1, 2, 333, 16, 1, 576, 512, True, "bfloat16",
     "MLA decode, causal Sq = 2"),
    (2, 1, 213, 16, 1, 576, 512, False, "float32", "MLA float32 decode"),
)


def mla_flash_inputs(torch, dev, gen, b, sq, sk, h, g, dqk, dv, dt):
    """(q, k, v, scale) of an MLA attention call: separate tensors at
    the prefill's head dims; at the absorbed decode's, k the whole rows
    and v the first ``dv`` columns of one (B, Sk + 8, Dqk) cache (views,
    as the model passes them)."""
    q = torch.randn(b, sq, h, dqk, generator=gen, device=dev).to(dt)
    if dqk == 192:
        k = torch.randn(b, sk, g, dqk, generator=gen, device=dev).to(dt)
        v = torch.randn(b, sk, g, dv, generator=gen, device=dev).to(dt)
        return q, k, v, None
    rows = torch.randn(b, sk + 8, dqk, generator=gen, device=dev).to(dt)
    k = rows[:, :sk, None, :]
    return q, k, k[..., :dv], MLA_DECODE_SCALE


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
        for d in (128, 80):
            cache = torch.randn(2, 300, 2, 2, d, generator=g,
                                device=dev).to(dt)
            cases.append((2, 1, 213, 8, 2, d, False, dt,
                          f"decode Sq = 1 on a cache view ({dt}, D {d})",
                          cache))
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
    mla_routes = {}
    for b, sq, sk, h, gg, dqk, dv, causal, dt, what in MLA_FLASH_CASES:
        dt = getattr(torch, dt)
        q, k, v, scale = mla_flash_inputs(torch, dev, g, b, sq, sk, h, gg,
                                          dqk, dv, dt)
        route = fa.ops.pick_route(dt, sq)
        got = fa.flash_attention(q, k, v, causal=causal, scale=scale)
        want = fa.attention_plain(q, k, v, causal=causal, scale=scale)
        torch.cuda.synchronize()
        tol = _flash_tol(dt, torch)
        ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
        err = (got.float() - want.float()).abs().max().item()
        if got.shape != (b, sq, h, dv) or not ok:
            raise AssertionError(f"flash_attention differs from the plain "
                                 f"version ({what}, {route} route): max abs "
                                 f"{err}")
        mla_routes[route] = mla_routes.get(route, 0) + 1
        worst = max(worst, err)
    if set(mla_routes) != set(fa.ops.ROUTES):
        raise AssertionError(f"phase 2's MLA cases miss a route: "
                             f"{mla_routes}")
    log(f"flash_attention: {len(cases)} cases and "
        f"{len(MLA_FLASH_CASES)} MLA cases within tolerance (max abs "
        f"{worst:.3g}; cases per route {routes}, MLA {mla_routes})")
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
    # device activity alone: the sums read no host event, and host events
    # cost seconds of the trace's processing
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


def _sdpa(F, qt, kt, vt, causal, scale):
    return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                          enable_gqa=True, scale=scale)


def _flash_at_shape(torch, name, q, k, v, causal, scale) -> dict:
    """Check and time one attention call on the route the wrapper picks:
    against its plain version (the two-ulp check in bf16, FLASH_F32_TOL in
    float32), beside SDPA on the same inputs (recorded under the same
    check; null with the reason where SDPA refuses them).  Event times
    (one call: host work and device) and profiler device times; the bound
    from the bytes each input is read (once, a view of another input's
    memory not again) and the output written, and the operations."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    f32 = q.dtype == torch.float32
    b, sq, h, dqk = q.shape
    sk, gg, dv = k.shape[1], k.shape[2], v.shape[-1]
    route = fa.ops.pick_route(q.dtype, sq)
    got = fa.flash_attention(q, k, v, causal=causal, scale=scale)
    want = fa.attention_plain(q, k, v, causal=causal, scale=scale)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    try:
        lib = _sdpa(F, qt, kt, vt, causal, scale).transpose(1, 2)
        lib_refused = None
    except RuntimeError as e:   # e.g. no backend for Dv != Dqk
        lib, lib_refused = None, str(e).splitlines()[0][:200]
    torch.cuda.synchronize()
    if f32:
        kchk = {"max_abs_err": (got - want).abs().max().item(),
                "within": torch.allclose(got, want, atol=FLASH_F32_TOL,
                                         rtol=FLASH_F32_TOL)}
        lchk = {"max_abs_err": None if lib is None else
                (lib - want).abs().max().item(), "within": None}
    else:
        kchk = _main_shape_check(got, want)
        lchk = ({"max_abs_err": None, "within": None} if lib is None
                else _main_shape_check(lib, want))
    log(f"flash_attention {name} ({route} route) vs plain: {kchk}; SDPA "
        f"vs plain: {lchk if lib is not None else lib_refused}")
    if not kchk["within"]:
        raise AssertionError(f"flash_attention off the plain version at "
                             f"the {name} shape: {kchk}")
    if lib is not None and not lchk["max_abs_err"] <= SDPA_SANITY_TOL:
        raise AssertionError(f"SDPA off the plain version at the {name} "
                             f"shape: {lchk} (sanity check)")
    del got, want, lib
    torch.cuda.empty_cache()
    call = lambda: fa.flash_attention(q, k, v, causal=causal,  # noqa
                                      scale=scale)
    sdpa = lambda: _sdpa(F, qt, kt, vt, causal, scale)  # noqa: E731
    ms = cuda_ms(call, 20, torch)
    plain_ms = cuda_ms(lambda: fa.attention_plain(q, k, v, causal=causal,
                                                  scale=scale), 3, torch)
    library_ms = lib_dev_ms = None
    if lib_refused is None:
        library_ms = cuda_ms(sdpa, 20, torch)
        lib_dev_ms, _ = device_ms(torch, sdpa, 20, "")
    dev_ms, per_call = device_ms(torch, call, 20, "flash_attention_kernel")
    size = q.element_size()
    shares_k = v.data_ptr() == k.data_ptr()
    nbytes = size * (q.numel() + k.numel() + (0 if shares_k else v.numel())
                     + b * sq * h * dv)
    flops = 2 * b * h * sq * sk * (dqk + dv)
    if causal and sq == sk:
        flops //= 2
    peak = F32_OPS_PER_S if f32 else BF16_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    out = {"route": route, "kernels_per_call": per_call,
           "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "library_device_ms": lib_dev_ms,
           "library_refused": lib_refused,
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
           "shape": f"q ({b},{sq},{h},{dqk}) k ({b},{sk},{gg},{dqk}) v "
                    f"({b},{sk},{gg},{dv}) {str(q.dtype).split('.')[-1]}"
                    f", causal={causal}"
                    + ("" if scale is None else f", scale {scale:.6g}")
                    + (", v a view of k" if shares_k else "")}
    log(f"flash_attention {name} ({route}): {ms:.4f} ms, device "
        f"{dev_ms} ms, {per_call} kernels a call (bound "
        f"{out['bound_ms']:.4f}, plain {plain_ms:.3f}, SDPA "
        f"{library_ms}, device {lib_dev_ms})")
    return out


def flash_attention_at_main_shapes(torch, dev, err: float) -> dict:
    """Time the kernel, its plain version and SDPA at the serve path's two
    shapes, each on the route the wrapper picks: the prefill (batch 8 x
    1024 tokens, causal: the bf16 prefill route) and a decode step over a
    FLASH_DECODE_KEYS-key cache prefix (non-causal, strided view: the
    split-K decode route), at Yi-9B's heads (32 / 4, D 128), at
    Zamba2-2.7B's (32 / 32, D 80) and at DeepSeek-V2-Lite's MLA (16 heads:
    the prefill at Dqk 192 / Dv 128, the absorbed decode at 576 / 512
    over one kv head's cache rows of a 1024-token prompt and 8 decoded
    tokens); and the float32 route at Yi-9B's prefill shape and at both
    MLA shapes (``_flash_at_shape``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels._build import BUILDER

    g = torch.Generator(device=dev).manual_seed(8)
    bf = torch.bfloat16
    out = {}
    for name in ("prefill", "decode", "f32", "zamba2_prefill",
                 "zamba2_decode"):
        cfg = get_config(HYBRID_ARCH if name.startswith("zamba2") else ARCH)
        h, gg, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        dt = torch.float32 if name == "f32" else bf
        if not name.endswith("decode"):
            sq = sk = SERVE_PROMPT
            q = torch.randn(SERVE_BATCH, sq, h, d, generator=g, device=dev)
            k = torch.randn(SERVE_BATCH, sk, gg, d, generator=g, device=dev)
            v = torch.randn(SERVE_BATCH, sk, gg, d, generator=g, device=dev)
            q, k, v = q.to(dt), k.to(dt), v.to(dt)
            causal = True
        else:
            sk = FLASH_DECODE_KEYS
            cache = torch.randn(SERVE_BATCH, FLASH_DECODE_KEYS + 64, 2, gg,
                                d, generator=g, device=dev).to(bf)
            q = torch.randn(SERVE_BATCH, 1, h, d, generator=g,
                            device=dev).to(bf)
            k, v = cache[:, :sk, 0], cache[:, :sk, 1]
            causal = False
        out[name] = _flash_at_shape(torch, name, q, k, v, causal, None)
        del q, k, v
        torch.cuda.empty_cache()
    mla = get_config(MOE_ARCH).mla
    h = get_config(MOE_ARCH).num_heads
    dqk = mla.qk_nope_head_dim + mla.qk_rope_head_dim
    for name in ("mla_prefill", "mla_decode", "mla_f32_prefill",
                 "mla_f32_decode"):
        dt = torch.float32 if "f32" in name else bf
        if name.endswith("prefill"):
            q, k, v, scale = mla_flash_inputs(
                torch, dev, g, SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, h, h,
                dqk, mla.v_head_dim, dt)
        else:
            q, k, v, scale = mla_flash_inputs(
                torch, dev, g, SERVE_BATCH, 1, SERVE_PROMPT + MOE_NEW, h, 1,
                mla.kv_lora_rank + mla.qk_rope_head_dim, mla.kv_lora_rank,
                dt)
        out[name] = _flash_at_shape(torch, name, q, k, v,
                                    name.endswith("prefill"), scale)
        del q, k, v
        torch.cuda.empty_cache()
    pre = out["prefill"]
    ptxas = ptxas_report(BUILDER.logs.get("flash_attention", ""))
    log(f"flash_attention ptxas: {ptxas}")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:71",
            "max_abs_err": max(err, *(o["max_abs_err"]
                                      for k, o in out.items()
                                      if "f32" not in k)),
            "ms": pre["ms"], "plain_ms": pre["plain_ms"],
            "bound_ms": pre["bound_ms"], "bound_by": pre["bound_by"],
            "library_ms": pre["library_ms"], "shape": pre["shape"],
            "prefill": pre, "decode": out["decode"], "f32": out["f32"],
            "zamba2": {"prefill": out["zamba2_prefill"],
                       "decode": out["zamba2_decode"]},
            "mla": {"prefill": out["mla_prefill"],
                    "decode": out["mla_decode"],
                    "f32_prefill": out["mla_f32_prefill"],
                    "f32_decode": out["mla_f32_decode"]},
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
# State dim 64 (Zamba2's), the f32 route alone (the wrapper's; the bf16
# route takes N 128 only and must refuse these).
SSD_CASES_N64 = (
    (2, 512, 8, 1, 256, "bfloat16", "N 64, full chunks, G = 1"),
    (1, 1025, 4, 1, 256, "float32", "N 64, ragged S = 4 x 256 + 1"),
    (2, 300, 4, 2, 37, "bfloat16", "N 64, odd Q = 37, ragged S, G = 2"),
    (2, 77, 4, 4, 256, "float32", "N 64, S < Q, G = H"),
)
# Timed besides the serve prefill shape: one long prompt.
SSD_LONG = (1, 4096)


def ssd_inputs(torch, dev, b, s, h, g, dtype, gen, views: bool = True,
               n=None):
    """SSD inputs as the model makes them: x, B and C views of one conv
    output row (B, S, H*P + 2*G*N) in ``dtype`` (or contiguous tensors),
    dt = softplus(randn) float32, a_log = log(linspace(1, 16, H)); N is
    ``n`` or the bf16 route's 128."""
    from repro_torch.kernels.ssd_scan import ops

    p, n = ops.HEAD_DIM, n or ops.STATE_DIM
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
    cases = [c + (128,) for c in SSD_CASES] + [c + (64,)
                                               for c in SSD_CASES_N64]
    for i, (b, s, h, g, q, dt_name, what, nd) in enumerate(cases):
        dtype = getattr(torch, dt_name)
        args = ssd_inputs(torch, dev, b, s, h, g, dtype, gen,
                          views=i % 2 == 0, n=nd)
        want_y, want_fin = ssd.ssd_scan_plain(*args, q)
        calls = {"wrapper, f32 route": lambda: ssd.ssd_scan(*args, q)}
        if dtype == torch.bfloat16 and nd == ssd.ops.STATE_DIM:
            calls["bf16 route"] = lambda: ssd.ops.launch(*args, q, "bf16")
        elif dtype == torch.bfloat16:
            before = ssd.KERNEL.launches
            try:
                ssd.ops.launch(*args, q, "bf16")
                raise AssertionError(f"ssd_scan's bf16 route took N {nd}")
            except ValueError:
                pass
            if ssd.KERNEL.launches != before:
                raise AssertionError("a refused bf16 route launched")
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
    xs, bs = args[0], args[3]
    b, s, _, p = xs.shape
    n = bs.shape[-1]
    nbytes, flops, t_bytes, t_ops = ssd_work(args, q)
    del args, xs, bs
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
                    f"{n}), Q {q}",
           "zamba2": ssd_scan_at_hybrid_shape(torch, dev, gen)}
    log(f"ssd_scan at the serve prefill shape: {ms:.4f} ms (bound "
        f"{out['bound_ms']:.4f}, {out['bound_by']}; plain {plain_ms:.3f}); "
        f"routes {routes}; batch {lb} x {ls}: {long_routes}; ptxas {ptxas}")
    return out


def ssd_work(args, q: int):
    """(bytes, operations, bytes time, operations time) the SSD chunk scan
    needs on ``args`` at chunk ``q``: x, dt, a_log, B, C read once, y and
    the final state written once."""
    xs, dt, a_log, bs, cs = args
    b, s, h, p = xs.shape
    g_, n = bs.shape[2], bs.shape[3]
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
    return (nbytes, flops, nbytes / HBM_BYTES_PER_S,
            flops / BF16_OPS_PER_S)


def ssd_scan_at_hybrid_shape(torch, dev, gen) -> dict:
    """The wrapper (f32 route) at Zamba2-2.7B's serve prefill shape (batch
    8 x 1024 tokens, 80 heads, P 64, N 64, Q 256, one group, bf16 views of
    the conv output): the two-ulp check against the plain version, then
    event and profiler device time beside the plain version and the
    bound."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as ssd

    cfg = get_config(HYBRID_ARCH)
    sc = cfg.ssm
    h, g_, n = sc.num_heads(cfg.d_model), sc.ngroups, sc.state_dim
    q = min(sc.chunk_size, SERVE_PROMPT)
    args = ssd_inputs(torch, dev, SERVE_BATCH, SERVE_PROMPT, h, g_,
                      torch.bfloat16, gen, n=n)
    want_y, want_fin = ssd.ssd_scan_plain(*args, q)
    y, fin = ssd.ssd_scan(*args, q)
    chk = _ssd_check(torch, y, want_y, fin, want_fin)
    del y, fin, want_y, want_fin
    log(f"ssd_scan at the Zamba2 serve shape vs plain: {chk}")
    if not chk["within"]:
        raise AssertionError(f"ssd_scan off the plain version at the "
                             f"Zamba2 serve shape: {chk}")
    call = lambda: ssd.ssd_scan(*args, q)  # noqa: E731
    ms = cuda_ms(call, 20, torch)
    dev_ms, per_call = device_ms(torch, call, 20, "ssd_")
    plain_ms = cuda_ms(lambda: ssd.ssd_scan_plain(*args, q), 3, torch)
    nbytes, flops, t_bytes, t_ops = ssd_work(args, q)
    del args
    torch.cuda.empty_cache()
    out = {"shape": f"x ({SERVE_BATCH},{SERVE_PROMPT},{h},"
                    f"{ssd.ops.HEAD_DIM}) bf16 views, B/C ({SERVE_BATCH},"
                    f"{SERVE_PROMPT},{g_},{n}), Q {q}",
           "route": "f32", "ms": ms, "device_ms": dev_ms,
           "kernels_per_call": per_call, "plain_ms": plain_ms,
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "flops": flops, **chk}
    log(f"ssd_scan at the Zamba2 serve shape: {ms:.4f} ms (device "
        f"{dev_ms}, bound {out['bound_ms']:.4f}, {out['bound_by']}; plain "
        f"{plain_ms:.3f})")
    return out


# ------------------------------------------------------------------ phase 3
def _model(chain: bool = False, num_layers: int = NUM_LAYERS):
    """The main paths' model (at ``num_layers``), or (``chain``) phase 3c's
    reduced config."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    if chain:
        return build_model(get_config(CHAIN_ARCH, reduced=True))
    return build_model(get_config(ARCH, reduced=REDUCED).replace(
        num_layers=num_layers))


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


@contextlib.contextmanager
def _counts_at_restore(into: dict):
    """Copy the launch counts into ``into`` as each
    ``CheckpointManager.restore`` (a trainer's resume) returns."""
    from repro_torch.checkpoint.saver import CheckpointManager

    plain = CheckpointManager.restore

    def restore(self, *args, **kwargs):
        state = plain(self, *args, **kwargs)
        into.update(_read_counts())
        return state

    CheckpointManager.restore = restore
    try:
        yield into
    finally:
        CheckpointManager.restore = plain


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


def flip_payload_byte(path: Path, digest: str) -> None:
    """Rewrite the full object at ``path`` with one payload byte of its
    first record flipped and that record's crc32 recomputed: the envelope,
    its fingerprint table and so its address stay, and only a recompute of
    the table from the tensors can see the change."""
    from repro_torch.checkpoint import _msgpack, workers

    env = workers.parse_envelope(path.read_bytes(), digest)
    if env["format"] != "full":
        raise AssertionError(f"{digest} is a {env['format']} object")
    meta, items = workers.decode_chunk_items(env["payload"])
    name, shape, dtype, raw = items[0]
    data = bytearray(raw)
    data[0] ^= 0x01
    items[0] = (name, shape, dtype, memoryview(data))
    env["payload"] = workers.encode_chunk_blob(items, meta)
    path.write_bytes(b"".join(bytes(p) for p in _msgpack.pack_parts(env)))


def _write_recipe(path: Path, base: str, output: Path, select,
                  optimizer: bool = True) -> Path:
    from repro_torch.core import yamlish

    path.write_text(yamlish.dumps({
        "base": base, "output": str(output), "optimizer": optimizer,
        "select": [{"units": list(u), "from": f} for u, f in select]}) + "\n")
    return path


def _tailor_cli(recipe: Path, dev) -> dict:
    """``python -m repro_torch.core.tailor RECIPE`` in a child process on
    ``dev``; returns its stats line and the child's ``block_fp`` launch
    count (the merge's own: nothing else runs there)."""
    code = ("import json, runpy, sys\n"
            "from repro_torch.kernels import block_fp\n"
            "sys.argv = ['tailor', *sys.argv[1:]]\n"
            "runpy.run_module('repro_torch.core.tailor', "
            "run_name='__main__')\n"
            "print(json.dumps({'block_fp': block_fp.KERNEL.launches}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code, str(recipe),
                          "--workers", "4", "--device", str(dev)],
                         capture_output=True, text=True, env=env,
                         timeout=900)
    if out.returncode != 0:
        raise AssertionError(f"the merge CLI failed ({out.returncode}):\n"
                             f"{out.stdout}\n{out.stderr}")
    lines = out.stdout.strip().splitlines()
    log(lines[0])
    return {"stats": json.loads(lines[-2]),
            "block_fp_launches": json.loads(lines[-1])["block_fp"]}


def _entry_digests(root: Path, step: int) -> dict:
    from repro_torch.core.manifest import ManifestStore

    m = ManifestStore(root).load(step)
    return {(u, k): r.digest for u, kinds in m.entries.items()
            for k, r in kinds.items()}


def _unit_fp_digests(registry, state) -> dict:
    """"unit/kind" -> the digest the fingerprint save path gives the
    unit's tensors in ``state`` (``fp_digest`` of their packed ``block_fp``
    table): equal to a store's entry digest when they hold its content."""
    from repro_torch.checkpoint import fingerprint as fputil
    from repro_torch.kernels import block_fp as bfp

    out = {}
    for unit in registry.unit_names():
        for kind, tree in (
                ("weights", registry.extract_unit(state["params"], unit)),
                ("opt", registry.extract_opt_unit(state["opt"], unit))):
            out[f"{unit}/{kind}"] = fputil.fp_digest(fputil.pack_table(
                bfp.tree_to_host(bfp.fingerprint_tree(tree))))
    return out


def _fill(f, buf: bytearray) -> int:
    """Read from ``f`` until ``buf`` is full or the file ends."""
    view, n = memoryview(buf), 0
    while n < len(buf):
        k = f.readinto(view[n:])
        if not k:
            break
        n += k
    return n


def _files_equal(a: Path, b: Path) -> bool:
    """Whether two files hold the same bytes, read 64 MiB at a time
    (``cmp`` reads a page at a time: 4 GiB took it 24.4 s on the H100
    machine's root filesystem, where ``cat`` reads it in 1.2 s)."""
    if a.stat().st_size != b.stat().st_size:
        return False
    piece = 64 << 20
    ba, bb = bytearray(piece), bytearray(piece)
    with open(a, "rb", buffering=0) as fa, open(b, "rb", buffering=0) as fb:
        while True:
            na, nb = _fill(fa, ba), _fill(fb, bb)
            if na != nb:
                return False
            if na < piece:
                return ba[:na] == bb[:nb]
            if ba != bb:
                return False


def phase_3g(torch, dev, store: Path, resumed_3a, out: dict) -> None:
    """The explicit merge on 3a's store (``store / "run"``: parity, events
    2, 4 and 6), with the launch counts set to 0 before it and read after:
    (a) the merge CLI, in a child process on the card, assembles the
    implicit merge of step 4 from a recipe (base @4, the units @4 carries
    over from step 2 taken from @2): its entries equal @4's and every
    object equals the source's byte for byte; a resume from it to step 6
    repeats 3a's resumed losses within MODE_TOL and commits @6's digests;
    (b) a Frankenstein (base @6, block_001 and embed from @2, weights
    only) restores to each unit's source table on the card, and serves the
    tokens of its zero-copy variant (``variant_select``); a ``VariantSet``
    serves @2's block_001 bit for bit; (c) a source whose final_norm
    object has a payload byte flipped under a recomputed crc32 fails the
    verifying merge with ``ChunkCorruption`` and no manifest, and
    ``verify=False`` copies it."""
    from repro_torch.checkpoint.saver import CheckpointManager
    from repro_torch.checkpoint.serial import ChunkCorruption
    from repro_torch.checkpoint import fingerprint as fputil
    from repro_torch.checkpoint.swap import VariantSet
    from repro_torch.core import Recipe, merge
    from repro_torch.core.layer_registry import LayerRegistry
    from repro_torch.core.manifest import ManifestStore
    from repro_torch.core.policies import make_policy
    from repro_torch.kernels import block_fp as bfp
    from repro_torch.launch import steps
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import train

    run = store / "run"
    t0 = time.perf_counter()
    _release(torch)
    _zero_counts()
    # (a) the implicit merge of step 4, made explicit
    m4 = ManifestStore(run).load(4)
    carried = sorted({u for u, kinds in m4.entries.items()
                      for r in kinds.values() if r.step == 2})
    merged_a = store / "merged_a"
    marks = [time.perf_counter()]
    cli = _tailor_cli(_write_recipe(store / "a.yaml", f"{run}@4", merged_a,
                                    [(carried, f"{run}@2")]), dev)
    if _entry_digests(merged_a, 4) != _entry_digests(run, 4):
        raise AssertionError("the explicit merge's entries differ from the "
                             "implicit merge of step 4")
    marks.append(time.perf_counter())
    objs = sorted((merged_a / "objects").glob("*/*.chunk"))
    # one ``cmp`` per object, 8 at a time: ~27 GB of reads
    with ThreadPoolExecutor(8) as pool:
        same = list(pool.map(
            lambda p: _files_equal(p, run / p.relative_to(merged_a)), objs))
    if not objs or not all(same):
        raise AssertionError("a merged object differs from its source")
    marks.append(time.perf_counter())
    kw = dict(arch=ARCH, reduced=REDUCED, num_layers=NUM_LAYERS,
              batch=BATCH, seq_len=SEQ, policy_name="parity", seed=SEED,
              device=str(dev), ckpt_async=False)
    res = train(ckpt_dir=str(merged_a), total_steps=STEPS,
                ckpt_interval=CKPT_INTERVAL, resume=True, **kw)
    marks.append(time.perf_counter())
    diffs = {s: abs(l - dict(resumed_3a)[s]) for s, l in res["losses"]}
    out["a"] = {"recipe_carried_units": carried, "merge": cli["stats"],
                "merge_block_fp_launches": cli["block_fp_launches"],
                "objects": len(objs),
                # wall seconds: the CLI child (start-up included), the
                # byte compare, the resume (restore, 2 steps, event 6)
                "seconds": dict(zip(("cli", "compare", "resume"),
                                    (b - a for a, b in zip(marks,
                                                           marks[1:])))),
                "resume_restore": res["restore_stats"],
                "losses_vs_3a_resumed": diffs}
    log(f"3g (a) merge {cli['stats']}, {len(objs)} objects; resumed losses "
        f"vs 3a: {diffs}")
    if [s for s, _ in res["losses"]] != [s for s, _ in resumed_3a] or \
            not all(d <= MODE_TOL for d in diffs.values()):
        raise AssertionError(f"the resume from the merged root left 3a's "
                             f"losses: {diffs}")
    if _entry_digests(merged_a, STEPS) != _entry_digests(run, STEPS):
        raise AssertionError("the merged root's step-6 digests differ from "
                             "the run's")
    _check_launched({"block_fp": cli["block_fp_launches"]}, ["block_fp"],
                    "the merge CLI")
    REMOVER.discard(merged_a)
    _release(torch)

    # (b) a Frankenstein and its zero-copy variant
    model = _model()
    registry = LayerRegistry(model)
    like = steps.state_specs(model)
    wlike = {"params": like["params"]}
    select = [(["block_001", "embed"], f"{run}@2")]
    merged_b = store / "merged_b"
    tb = time.perf_counter()
    n0 = bfp.KERNEL.launches
    stats_b = merge(Recipe.load(_write_recipe(
        store / "b.yaml", f"{run}@6", merged_b, select, optimizer=False)),
        device=dev)
    merge_b_launches = bfp.KERNEL.launches - n0
    mgr_b = CheckpointManager(merged_b, registry, make_policy(
        "parity", model.layer_units()), async_save=False)
    params = mgr_b.restore(wlike, device=dev, parts=("params",))["params"]
    mgr_b.close()
    mgr = CheckpointManager(run, registry, make_policy(
        "parity", model.layer_units()), async_save=False)
    for unit in registry.unit_names():
        src = 2 if unit in select[0][0] else 6
        digest = mgr.manifests.load(src).entries[unit]["weights"].digest
        cur = bfp.tree_to_host(bfp.fingerprint_tree(
            registry.extract_unit(params, unit)))
        if fputil.pack_table(cur) != fputil.pack_table(
                mgr.store.load_fp_table(digest)):
            raise AssertionError(f"3g (b): {unit}'s device fingerprints "
                                 f"differ from step {src}'s table")
    del params
    skw = dict(arch=ARCH, reduced=REDUCED, num_layers=NUM_LAYERS,
               batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
               new_tokens=SERVE_NEW, seed=SEED, device=str(dev))
    explicit = serve(from_ckpt=str(merged_b), **skw)
    variant = serve(from_ckpt=str(run), variant_base_step=STEPS,
                    variant_select=["block_001,embed@2"], **skw)
    vs = VariantSet(mgr, like, device=dev)
    vs.materialize("base", base_step=STEPS)
    vs.materialize("mix", base_step=STEPS,
                   select=[(["block_001", "embed"], 2)])
    cold2 = mgr.restore(wlike, device=dev, parts=("params",), step=2)
    mix_is_step2 = _params_equal(
        torch, registry.extract_unit(vs.params("mix"), "block_001"),
        registry.extract_unit(cold2["params"], "block_001"))
    base_differs = not _params_equal(
        torch, registry.extract_unit(vs.params("base"), "block_001"),
        registry.extract_unit(cold2["params"], "block_001"))
    vstats = vs.stats()
    del vs, cold2
    mgr.close()
    out["b"] = {"merge": stats_b, "merge_block_fp_launches": merge_b_launches,
                "seconds": time.perf_counter() - tb,
                "tokens_digest": {"merged": explicit["tokens_digest"],
                                  "variant": variant["tokens_digest"]},
                "serve_prefill_seconds": {
                    "merged": explicit["prefill_seconds"],
                    "variant": variant["prefill_seconds"]},
                "variant_set": {"backend_reads": vstats["backend_reads"],
                                "cache": vstats["cache"],
                                "restore_seconds": {
                                    n: v["seconds"] for n, v in
                                    vstats["variants"].items()}}}
    log(f"3g (b) merge {stats_b}; digests {out['b']['tokens_digest']}")
    if explicit["tokens_digest"] != variant["tokens_digest"]:
        raise AssertionError("the Frankenstein and its zero-copy variant "
                             "serve different tokens")
    if not (mix_is_step2 and base_differs):
        raise AssertionError(f"VariantSet: mix's block_001 equals step 2's: "
                             f"{mix_is_step2}; base's differs: "
                             f"{base_differs}")
    _check_launched({"block_fp": merge_b_launches}, ["block_fp"],
                    "the merge of (b)")
    REMOVER.discard(merged_b)
    _release(torch)

    # (c) a flipped byte under a recomputed crc32
    tc = time.perf_counter()
    scr = store / "corrupt_src"
    (scr / "manifests").mkdir(parents=True)
    for f in (run / "manifests").glob("*.json"):
        shutil.copyfile(f, scr / "manifests" / f.name)
    shutil.copyfile(run / "LATEST", scr / "LATEST")
    bad = ManifestStore(run).load(STEPS).entries["final_norm"]["weights"]
    for f in (run / "objects").glob("*/*.chunk"):
        dst = scr / f.relative_to(run)
        dst.parent.mkdir(parents=True, exist_ok=True)
        if f.stem == bad.digest:
            shutil.copyfile(f, dst)
        else:
            os.link(f, dst)
    bad_path = scr / bad.relpath
    flip_payload_byte(bad_path, bad.digest)
    merged_c = store / "merged_c"
    recipe_c = Recipe.load(_write_recipe(
        store / "c.yaml", f"{scr}@{STEPS}", merged_c,
        [(["block_001", "embed"], f"{scr}@2")], optimizer=False))
    try:
        merge(recipe_c, device=dev)
        caught = None
    except ChunkCorruption as e:
        caught = str(e)
    committed = ManifestStore(merged_c).all_steps()
    REMOVER.discard(merged_c)
    merge(recipe_c, verify=False, device=dev)
    copied = _files_equal(merged_c / bad.relpath, bad_path)
    REMOVER.discard(merged_c)
    REMOVER.discard(scr)
    torch.cuda.synchronize()
    launches = _read_counts()
    out["c"] = {"caught": caught, "manifests_committed": committed,
                "unverified_copy_equal": copied,
                "seconds": time.perf_counter() - tc}
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    log(f"3g (c) caught: {caught}; phase 3g in {out['seconds']:.1f} s, "
        f"launches {launches}")
    if caught is None or "fingerprint mismatch" not in caught or committed:
        raise AssertionError(f"3g (c): the flipped byte was not caught by "
                             f"the table recompute ({caught!r}), or a "
                             f"manifest was committed ({committed})")
    if not copied:
        raise AssertionError("3g (c): --no-verify did not copy the object")
    _check_launched(launches, ("block_fp", "fused_adamw", "flash_attention"),
                    "phase 3g")


_CANON_EVENT_KEYS = ("step", "stall_seconds", "d2h_bytes", "hashed_bytes",
                     "written_bytes", "delta_chunks", "full_chunks",
                     "dedup_hits", "encode_seconds", "write_io_seconds")


def _event_rows(events) -> list:
    return [{k: e[k] for k in _CANON_EVENT_KEYS} for e in events]


def _link_copy(src: Path, dst: Path, step: int) -> None:
    """A store at ``dst`` holding ``src``'s step-``step`` manifest (as
    LATEST) and the objects it references, hard-linked: it keeps them
    when ``src`` is removed, and neither store's writes touch the other's
    files."""
    from repro_torch.core.manifest import ManifestStore

    m = ManifestStore(src).load(step)
    ManifestStore(dst).commit(m)
    for digest in set(m.referenced_digests()):
        rel = Path("objects") / digest[:2] / f"{digest}.chunk"
        (dst / rel).parent.mkdir(parents=True, exist_ok=True)
        os.link(src / rel, dst / rel)


def _used_bytes(store: Path) -> int:
    """Bytes the files under ``store`` take (a hard-linked file once)."""
    seen, total = set(), 0
    for p in store.rglob("*"):
        st = p.lstat()
        if p.is_file() and st.st_ino not in seen:
            seen.add(st.st_ino)
            total += st.st_size
    return total


def _state_bytes(state) -> int:
    from repro_torch.checkpoint.serial import flatten_with_paths

    return sum(x.numel() * x.element_size()
               for part in ("params", "opt")
               for _, x in flatten_with_paths(state[part]))


def phase_3h(torch, dev, store: Path, ref: dict, rec_a: dict,
             out: dict) -> None:
    """The canonical save path (``ckpt_fingerprint=False``) at 3a's
    configuration, its objects written on CANON_WRITER_THREADS writer
    threads (the cut that pays for phase 3m), the launch counts set to 0
    before each part and read after it: (c) on 3a's store, a resume to
    step 8 whose event writes canonical objects over fp bases (their
    tables checked by ``block_fp``),
    then a weights-only cold load of 6 hot-swapped to 8, equal to a cold
    load of 8, and hot vs cold ``tokens_digest``; (a) 3a's run on the
    canonical path (fail at 5, resume to 6 with no event: 3a's events 2
    and 4, and no event 6, the cut that with (e)'s and 3e's pays for phase
    3l): resumed losses equal to 3a's within MODE_TOL, step 4's objects
    decoding to 3a's step-4 tensors (the resume's restore, which checks
    each object's canonical digest, fingerprinted to 3a's step-4 entry
    digests after the launch counts are read), no ``block_fp`` launch; (b) the
    unchanged re-save of step 6's embed unit (its content saved at step 4)
    from one restore of that unit from a hard-linked copy of 3a's step-6
    store taken before (c): fingerprint path on that copy, canonical on
    (a)'s root; (d) the merge (in this process) copies (a)'s step-4
    XOR-delta weights objects and their bases into a merge on step 4 (weights only), verified, byte for
    byte; (e) one canonical int8 event and its restore (``quantize``,
    ``dequantize``) at CANON_INT8_LAYERS (1) of 3a's 2 layers,
    block_000's objects equal to the CPU path's and the restored leaves to
    their records dequantized.  ``ref`` is 3a's reference run and ``rec_a`` 3a's record.
    3a's store is removed after (c).  ``out["store_bytes"]`` records the
    bytes under ``store`` at each part's peak.  Fills ``out`` before its
    checks."""
    from repro_torch.checkpoint import workers
    from repro_torch.checkpoint.chunk_store import ChunkStore
    from repro_torch.checkpoint.saver import CheckpointManager
    from repro_torch.checkpoint.serial import flatten_with_paths
    from repro_torch.checkpoint.swap import WeightService
    from repro_torch.core import Recipe, merge
    from repro_torch.core.layer_registry import LayerRegistry
    from repro_torch.core.manifest import ManifestStore
    from repro_torch.core.policies import make_policy
    from repro_torch.kernels import block_fp as bfp
    from repro_torch.launch import steps
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import SimulatedFailure, train

    t0 = time.perf_counter()
    run3a = store / "3a" / "run"
    root = store / "3h"
    kw = dict(arch=ARCH, reduced=REDUCED, num_layers=NUM_LAYERS,
              batch=BATCH, seq_len=SEQ, policy_name="parity", seed=SEED,
              device=str(dev), ckpt_async=True,
              writer_threads=CANON_WRITER_THREADS, ckpt_fingerprint=False)
    model = _model()
    registry = LayerRegistry(model)
    like = steps.state_specs(model)
    wlike = {"params": like["params"]}
    policy = make_policy("parity", model.layer_units())
    launches = out["launches"] = {}
    _release(torch)
    # 3a's store at step 6 for (b)'s fingerprint re-save, before (c)
    _link_copy(run3a, root / "fp_resave", STEPS)
    disk = out["store_bytes"] = {"start": _used_bytes(store)}

    # (c) from the fingerprint path to the canonical one, on 3a's store
    tc = time.perf_counter()
    _zero_counts()
    with _counts_at_restore({}) as at_restore:
        res_c = train(ckpt_dir=str(run3a), total_steps=REF_STEPS,
                      ckpt_interval=CKPT_INTERVAL, resume=True, **kw)
    torch.cuda.synchronize()
    launches["c_train"] = _read_counts()
    ref_loss = dict(ref["losses"])
    m8 = ManifestStore(run3a).load(REF_STEPS)
    store3a = ChunkStore(run3a)
    # event 8's XOR deltas whose base is a fingerprint-addressed object
    xd01_fp = sorted(f"{u}/{k}" for u, kinds in m8.entries.items()
                     for k, r in kinds.items()
                     if r.step == REF_STEPS and r.stored == "delta"
                     and store3a.load_fp_table(r.delta_base) is not None)
    out["c"] = {"losses": res_c["losses"],
                "loss_diffs_vs_3a_reference": {
                    s + 1: abs(l - ref_loss[s]) for s, l in res_c["losses"]},
                "event": _event_rows(res_c["save_events"]),
                "restore": res_c["restore_stats"],
                "event8_xd01": sorted(f"{u}/{k}" for u, kinds in
                                      m8.entries.items()
                                      for k, r in kinds.items()
                                      if r.step == REF_STEPS
                                      and r.stored == "delta"),
                "event8_xd01_over_fp_bases": xd01_fp,
                "launches_when_the_resume_restore_ended": dict(at_restore)}
    log(f"3h (c) resumed losses {res_c['losses']}, event "
        f"{out['c']['event']}, launches {launches['c_train']} "
        f"({at_restore} when the resume's restore ended)")
    _check_launched(launches["c_train"], ("fused_adamw",), "3h (c)")
    # the base checks come after the resume's restore, which checks its
    # own objects by block_fp too
    _check_launched({"block_fp": launches["c_train"]["block_fp"]
                     - at_restore.get("block_fp", 0)}, ("block_fp",),
                    "3h (c)'s canonical event over fp bases")
    if not xd01_fp:
        raise AssertionError("3h (c): event 8 wrote no XOR delta over a "
                             "fingerprint-addressed base")
    _release(torch)
    _zero_counts()
    mgr = CheckpointManager(run3a, registry, policy, async_save=False,
                            fingerprint=False)
    svc = WeightService(mgr, wlike, device=dev, step=STEPS)
    swap = svc.swap(m8)
    cold8 = mgr.restore(wlike, device=dev, parts=("params",),
                        step=REF_STEPS)
    swapped_equal = _params_equal(torch, svc.current(), cold8["params"])
    del svc, cold8
    mgr.close()
    _release(torch)
    skw = dict(arch=ARCH, reduced=REDUCED, num_layers=NUM_LAYERS,
               batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
               new_tokens=SERVE_NEW, seed=SEED, device=str(dev),
               from_ckpt=str(run3a))
    hot = serve(from_step=STEPS, hot_swap=True, swap_wait=0.0, **skw)
    cold = serve(**skw)
    torch.cuda.synchronize()
    launches["c_serve"] = _read_counts()
    out["c"].update({"swap_6_to_8": swap, "swap_equals_cold_load":
                     swapped_equal,
                     "tokens_digest": {"hot_swapped": hot["tokens_digest"],
                                       "cold_loaded": cold["tokens_digest"]},
                     "seconds": time.perf_counter() - tc})
    log(f"3h (c) swap 6 -> 8 {swap}; digests {out['c']['tokens_digest']}")
    if not swapped_equal:
        raise AssertionError("3h (c): the swap to 8 is not a cold load of 8")
    if not (hot["served_step"] == cold["served_step"] == REF_STEPS
            and hot["tokens_digest"] == cold["tokens_digest"]):
        raise AssertionError(f"3h (c): hot-swapped and cold-loaded servers "
                             f"differ: {out['c']['tokens_digest']}")
    _check_launched(launches["c_serve"], ("flash_attention",), "3h (c)")
    _release(torch)
    disk["after_c"] = _used_bytes(store)
    REMOVER.discard(store / "3a")

    # (a) 3a's run on the canonical path
    ta = time.perf_counter()
    run = root / "run"
    _zero_counts()
    try:
        train(ckpt_dir=str(run), total_steps=STEPS,
              ckpt_interval=CKPT_INTERVAL, fail_at=FAIL_AT, **kw)
        raise AssertionError("3h (a): the checkpointed run did not fail")
    except SimulatedFailure as e:
        failed = e
    # the resume saves nothing: (b) and (d) use the step-4 objects
    restored = {}
    with _restored_state(restored):
        res_a = train(ckpt_dir=str(run), total_steps=STEPS,
                      ckpt_interval=STEPS + 1, resume=True, **kw)
    torch.cuda.synchronize()
    launches["a"] = _read_counts()
    disk["after_a"] = _used_bytes(store)
    events = failed.save_events + res_a["save_events"]
    del failed
    m4 = ManifestStore(run).load(4)
    xd01_4 = sorted(f"{u}/{k}" for u, kinds in m4.entries.items()
                    for k, r in kinds.items()
                    if r.step == 4 and r.stored == "delta")
    want = dict(rec_a["losses_resumed"])
    diffs = {s: abs(l - want[s]) for s, l in res_a["losses"]}
    out["a"] = {"losses_resumed": res_a["losses"],
                "loss_diffs_vs_3a_resumed": diffs,
                "events": _event_rows(events),
                "writes": f"{CANON_WRITER_THREADS} writer threads",
                "events_3a": _event_rows(rec_a["save_events"]),
                "writes_3a": "inline",
                "restore_on_resume": res_a["restore_stats"],
                "event4_xd01": xd01_4}
    log(f"3h (a) resumed losses vs 3a: {diffs}; XD01 at event 4: {xd01_4}")
    for e, e3 in zip(out["a"]["events"], out["a"]["events_3a"]):
        log(f"3h (a) event {e['step']} ({CANON_WRITER_THREADS} writer "
            f"threads): {e} | 3a (inline): {e3}")
    if [s for s, _ in res_a["losses"]] != [s for s, _ in want.items()] \
            or not all(d <= MODE_TOL for d in diffs.values()):
        raise AssertionError(f"3h (a): resumed losses off 3a's: {diffs}")
    if launches["a"]["block_fp"] != 0:
        raise AssertionError(f"3h (a): block_fp launched on the canonical "
                             f"path: {launches['a']}")
    _check_launched(launches["a"], ("fused_adamw",), "3h (a)")
    # step 4 as the resume decoded it (each object checked against its
    # canonical digest), fingerprinted as 3a's store addressed its step 4
    if restored["stats"]["step"] != 4:
        raise AssertionError(f"3h (a): the resume restored "
                             f"{restored['stats']}")
    got4 = _unit_fp_digests(registry, restored.pop("state"))
    want4 = rec_a["entry_digests"]["4"]
    out["a"]["step4_equal_3a"] = got4 == want4
    out["a"]["seconds"] = time.perf_counter() - ta
    if got4 != want4:
        raise AssertionError("3h (a): step 4's objects do not decode to 3a's "
                             "step-4 tensors: " + str(sorted(
                                 k for k in got4 if got4[k] != want4.get(k))))
    _release(torch)

    # (b) the unchanged re-save of the embed unit, both paths, from one
    # restore of its step-6 tensors (from the fingerprint root: the
    # canonical re-save's dedup hits prove it is (a)'s step 6 as well)
    tb = time.perf_counter()
    _zero_counts()
    fp_root = root / "fp_resave"
    mgr = CheckpointManager(fp_root, registry, policy, async_save=False)
    # the embed unit alone (the other units restore as zeros)
    state = mgr.restore(like, device=dev, step=STEPS, units=["embed"])
    resave = {}
    for path, where in (("fingerprint", fp_root), ("canonical", run)):
        if path == "canonical":
            mgr = CheckpointManager(
                where, registry, policy, fingerprint=False,
                async_save=True, writer_threads=CANON_WRITER_THREADS)
        mgr.save(state, step=STEPS + 1, units=["embed"])
        resave[path] = dict(mgr.last_save_stats, unit_bytes=sum(
            x.numel() * x.element_size() for tree in (
                registry.extract_unit(state["params"], "embed"),
                registry.extract_opt_unit(state["opt"], "embed"))
            for _, x in flatten_with_paths(tree)))
        mgr.close()
    del state
    _release(torch)
    torch.cuda.synchronize()
    launches["b"] = _read_counts()
    out["b"] = {p: {k: r[k] for k in _CANON_EVENT_KEYS + ("unit_bytes",
                                                         "seconds")}
                for p, r in resave.items()}
    out["b"]["roots"] = ("the embed unit re-saved at step 7 from one "
                         "restore of that unit from 3a's step-6 store "
                         "(a hard-linked "
                         "copy taken before (c)): fingerprint path on "
                         "that copy, canonical path on (a)'s root")
    out["b"]["seconds"] = time.perf_counter() - tb
    log(f"3h (b) re-saves: {out['b']}")
    rc, rf = resave["canonical"], resave["fingerprint"]
    if not (rc["d2h_bytes"] == rc["unit_bytes"]
            and rc["hashed_bytes"] == rc["logical_bytes"] > rc["d2h_bytes"]
            and rc["written_bytes"] == 0 and rc["dedup_hits"] == 2):
        raise AssertionError(f"3h (b): the canonical re-save {rc}")
    if not (rf["d2h_bytes"] == 0 and rf["written_bytes"] == 0
            and rf["dedup_hits"] == 2):
        raise AssertionError(f"3h (b): the fingerprint re-save {rf}")
    REMOVER.discard(fp_root)

    # (d) the merge of canonical objects: XOR deltas and their bases
    td = time.perf_counter()
    _zero_counts()
    picked = sorted({u.split("/")[0] for u in xd01_4})
    if not picked:
        raise AssertionError("3h (d): event 4 wrote no XD01 object to merge")
    merged = root / "merged"
    n0 = bfp.KERNEL.launches
    stats_d = merge(Recipe.load(_write_recipe(
        root / "d.yaml", f"{run}@4", merged, [(picked, f"{run}@4")],
        optimizer=False)), workers=4, device=dev)
    merge_d_launches = bfp.KERNEL.launches - n0
    objs = sorted((merged / "objects").glob("*/*.chunk"))
    fmts = [workers.parse_envelope(p.read_bytes(), p.stem)["format"]
            for p in objs]
    with ThreadPoolExecutor(8) as pool:
        same = list(pool.map(
            lambda p: _files_equal(p, run / p.relative_to(merged)), objs))
    launches["d"] = _read_counts()
    disk["after_d"] = _used_bytes(store)
    out["d"] = {"recipe_units_from_step4": picked, "merge": stats_d,
                "merge_block_fp_launches": merge_d_launches,
                "objects": len(objs), "xd01_objects": fmts.count("delta"),
                "seconds": time.perf_counter() - td}
    log(f"3h (d) merge {stats_d}, {len(objs)} objects, "
        f"{fmts.count('delta')} XD01")
    if not fmts.count("delta") or not objs or not all(same):
        raise AssertionError(f"3h (d): no XD01 object merged ({fmts}), or a "
                             "merged object differs from its source")
    REMOVER.discard(merged)
    REMOVER.discard(root)
    _release(torch)

    # (e) canonical int8: one event and its restore, at CANON_INT8_LAYERS
    te = time.perf_counter()
    root_e = store / "3h_e"
    model_e = _model(num_layers=CANON_INT8_LAYERS)
    _zero_counts()
    res_e = train(ckpt_dir=str(root_e), total_steps=CKPT_INTERVAL,
                  ckpt_interval=CKPT_INTERVAL, codec="int8",
                  **dict(kw, num_layers=CANON_INT8_LAYERS))
    torch.cuda.synchronize()
    launches["e_save"] = _read_counts()
    _release(torch)
    _zero_counts()
    mgr = CheckpointManager(root_e, LayerRegistry(model_e),
                            make_policy("parity", model_e.layer_units()),
                            async_save=False, codec="int8", fingerprint=False)
    state = mgr.restore(steps.state_specs(model_e), device=dev)
    torch.cuda.synchronize()
    launches["e_restore"] = _read_counts()
    out["e"] = {"event": _event_rows(res_e["save_events"]),
                "restore": dict(mgr.last_restore_stats)}
    disk["after_e_save"] = _used_bytes(store)
    _check_launched(launches["e_save"], ("quantize",), "3h (e)'s save")
    _check_launched(launches["e_restore"], ("dequantize",),
                    "3h (e)'s restore")
    out["e"]["restored_vs_records"] = _check_int8_restore(
        torch, dev, mgr, state, CKPT_INTERVAL)
    mgr.close()
    del state
    _release(torch)
    out["e"]["cpu_path_objects"] = _check_cpu_path_objects(
        torch, dev, root_e, store / "3h_e_cpu", fingerprint=False,
        num_layers=CANON_INT8_LAYERS)
    out["e"]["seconds"] = time.perf_counter() - te
    REMOVER.discard(root_e)
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 3h in {out['seconds']:.1f} s; launches {launches}")


# ---------------------------------------------------------------- phase 3i
TIER_HOT_BUDGET_MB = 4096
TIER_REMOTE = {"latency": 0.002, "error_rate": 0.01, "seed": 0}


def _check_free(store: Path, what: str) -> float:
    free = REMOVER.free_bytes(store)
    if free < STORE_BYTES_NEEDED:
        raise RuntimeError(f"{what}: only {free / 1e9:.1f} GB free under "
                           f"{store}, want {STORE_BYTES_NEEDED / 1e9:.0f} GB")
    return free


@contextlib.contextmanager
def _rss_peak(into: dict):
    """Sample the process's resident bytes every 50 ms; ``into["peak"]``
    is the largest sample (``/proc/self/statm``)."""
    import threading

    page = os.sysconf("SC_PAGE_SIZE")
    stop = threading.Event()

    def rss() -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * page

    def sample() -> None:
        while True:
            into["peak"] = max(into.get("peak", 0), rss())
            if stop.wait(0.05):
                return

    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        yield into
    finally:
        stop.set()
        t.join()


def _fp_named(path: Path) -> bool:
    """Whether the fingerprint table in the object file at ``path`` hashes
    to the file's name (the envelope is parsed from a map of the file, so
    the payload is never read)."""
    import mmap

    from repro_torch.checkpoint import fingerprint as fputil
    from repro_torch.checkpoint import workers

    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0,
                                          access=mmap.ACCESS_READ) as mm:
        mv = memoryview(mm)
        try:
            env = workers.parse_envelope(mv, path.stem)
            fp = env.get("fp")
            fp = None if fp is None else bytes(fp)
            del env
        finally:
            mv.release()
    if fp is None:
        raise AssertionError(f"{path} is not fingerprint-addressed")
    return fputil.fp_digest(fp) == path.stem


def _check_named(root: Path, pattern: str, what: str) -> int:
    files = sorted(root.glob(pattern))
    bad = [p.name for p in files if not _fp_named(p)]
    if bad:
        raise AssertionError(f"{what}: objects that do not hash to their "
                             f"names: {bad}")
    return len(files)


def _stems(root: Path, pattern: str) -> set:
    return {p.name.split(".")[0] for p in root.glob(pattern)}


@contextlib.contextmanager
def _outage_on_event(at: int, into: dict):
    """Wrap ``CheckpointManager.save`` so the event at step ``at`` runs with
    the bucket's ``OUTAGE`` marker touched and a durability barrier, then
    heals the bucket and waits out the breaker's cooldown; ``into`` gets
    the event's storage record and the remote counters at its commit."""
    from repro_torch.checkpoint.saver import CheckpointManager

    plain = CheckpointManager.save

    def save(self, state, *, step=None, **kwargs):
        if step != at:
            return plain(self, state, step=step, **kwargs)
        remote = self.store.backend.tier_backends()["remote"]
        remote.service.set_outage(True)
        try:
            m = plain(self, state, step=step, durability_barrier=True,
                      **kwargs)
        finally:
            remote.service.set_outage(False)
        into.update(storage=dict(m.meta["storage"]),
                    tier_stats_at_commit=self.store.tier_stats())
        deadline = time.monotonic() + remote.breaker.cooldown + 1.0
        while not remote.breaker.allow() and time.monotonic() < deadline:
            time.sleep(0.05)
        return m

    CheckpointManager.save = save
    try:
        yield into
    finally:
        CheckpointManager.save = plain


_TIER_EVENT_KEYS = ("step", "stall_seconds", "durable_on", "spill_pending",
                    "backend", "written_bytes", "d2h_bytes",
                    "encode_seconds", "write_io_seconds", "commit_seconds",
                    "gc_seconds")
# (d)'s stores hold these units only, block_000's weights taken from RAM
# (the first cut of 3i to its 150-s budget)
TIER_MERGE_UNITS = ("block_000", "final_norm")


@contextlib.contextmanager
def _served_params(into: list):
    """Append to ``into`` every tree ``WeightService.current`` returns (a
    server's last one is what it generated from)."""
    from repro_torch.checkpoint.swap import WeightService

    plain = WeightService.current

    def current(self):
        tree = plain(self)
        into.append(tree)
        return tree

    WeightService.current = current
    try:
        yield into
    finally:
        WeightService.current = plain


def _units_registry(model, names):
    """A registry of ``model`` that knows only the units ``names``."""
    from repro_torch.core.layer_registry import LayerRegistry

    reg = LayerRegistry(model)
    reg.units = [u for u in reg.units if u.name in names]
    reg.by_name = {u.name: u for u in reg.units}
    return reg


def phase_3i(torch, dev, store: Path, rec_a: dict, out: dict) -> None:
    """The storage tiers at 3a's configuration (Yi-9B full width, 2
    layers, batch 2 x 1024, parity, a save every 2 steps, sync saves),
    after 3h, the launch counts set to 0 before each part and read after.
    Budget: 150 s.  ``rec_a`` is 3a's record (its resumed losses, events,
    and the step-2 and step-4 entry digests taken before 3h removed its
    store).  Each part checks free disk first and removes its root at its
    end.  Fills ``out`` before its checks.

    (a) ``store_backend="tiered"`` (RAM hot tier, 4 GiB budget, spill to
    the disk tree, no barrier): the run that fails at step 5 and its
    resume to 6, which saves nothing; the resumed losses equal 3a's within MODE_TOL, steps 2
    and 4 hold 3a's digests, every drained object hashes to its name, the
    durable tree passes ``check_store``; per event the stall beside 3a's,
    ``durable_on`` and ``spill_pending`` at commit; the drain, hot bytes,
    evictions, reads per tier and the host's peak RSS recorded.
    (c) servers on (a)'s root at 2 layers (batch 8 x 1024, 128 tokens)
    through ``tiered`` and ``local``: a weights-only cold load of 2
    hot-swapped to 4 serves equal parameters and one ``tokens_digest``;
    the loads' and swaps' reads per tier recorded.
    (b) ``store_backend="remote3"`` (RAM -> disk -> remote; 2 ms per op, 1%
    seeded faults, seed 0), cut to event 2 to fit the budget: a run to
    step 2 whose event runs with the bucket down and a barrier (it commits
    ``durable_on="durable"``, degraded) and heals after; the run's end
    drains to full replication (the bucket's digests equal the disk
    tree's, every blob hashes to its name); one step-2 object's disk copy
    is deleted and a new manager resumes to 4: the object is read from the
    bucket and is back on disk, the losses equal 3a's uninterrupted run
    (event 2 is full), steps 2 and 4 hold 3a's digests; the retry, hedge
    and breaker counters recorded.
    (d) a merge from a live RAM tier, cut to TIER_MERGE_UNITS (block_000
    and final_norm) to fit the budget: the initial full-width state saved
    by a ``memory`` manager, the state with block_000 bumped by a
    ``local`` one; a weights-only recipe takes block_000's weights from
    the RAM store (``stores=``) into a local output, restored on the card:
    every unit equals its source, ``meta["storage"]`` is local/durable,
    and the merge's verify launches ``block_fp`` once per copied
    object."""
    from repro_torch.checkpoint.saver import CheckpointManager
    from repro_torch.checkpoint.serial import flatten_with_paths
    from repro_torch.core.manifest import ManifestStore
    from repro_torch.core.policies import make_policy
    from repro_torch.core.recipe import CheckpointRef, Recipe, SelectRule
    from repro_torch.core.tailor import merge
    from repro_torch.launch import steps
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import SimulatedFailure, train

    t0 = time.perf_counter()
    root = store / "3i"
    root.mkdir(parents=True, exist_ok=True)
    kw = dict(arch=ARCH, reduced=REDUCED, num_layers=NUM_LAYERS,
              batch=BATCH, seq_len=SEQ, policy_name="parity", seed=SEED,
              device=str(dev), ckpt_async=False,
              hot_budget_mb=TIER_HOT_BUDGET_MB)
    model = _model()
    wlike = {"params": steps.state_specs(model)["params"]}
    launches = out["launches"] = {}
    want_losses = rec_a["losses_resumed"]
    if [s for s, _ in want_losses] != list(range(FAIL_AT - 1, STEPS)):
        raise AssertionError(f"3a's resumed steps: {want_losses}")
    a_stalls = {e["step"]: e["stall_seconds"] for e in rec_a["save_events"]}

    def losses_equal(res, want, what: str) -> dict:
        """The resumed losses against 3a's at the same steps."""
        want = dict(want)
        diffs = {s: abs(l - want[s]) for s, l in res["losses"] if s in want}
        if (len(diffs) != len(res["losses"])
                or not all(d <= MODE_TOL for d in diffs.values())):
            raise AssertionError(f"{what}: resumed losses {res['losses']} "
                                 f"off 3a's {sorted(want.items())}")
        return diffs

    def digests_equal(run: Path, what: str) -> None:
        for s in (2, 4):
            got = {f"{u}/{k}": d for (u, k), d in
                   _entry_digests(run, s).items()}
            if got != rec_a["entry_digests"][str(s)]:
                raise AssertionError(f"{what}: step-{s} entries differ "
                                     "from 3a's")

    # (a) the RAM hot tier over the disk tree
    ta = time.perf_counter()
    run_a = root / "a"
    out["a"] = {"free_bytes": _check_free(root, "3i (a)")}
    rss = {}
    _zero_counts()
    with _rss_peak(rss):
        try:
            train(ckpt_dir=str(run_a), total_steps=STEPS,
                  ckpt_interval=CKPT_INTERVAL, fail_at=FAIL_AT,
                  store_backend="tiered", **kw)
            raise AssertionError("3i (a): the checkpointed run did not fail")
        except SimulatedFailure as e:
            failed = e
        # the resume saves nothing: (c) swaps 2 -> 4
        res = train(ckpt_dir=str(run_a), total_steps=STEPS,
                    ckpt_interval=STEPS + 1, resume=True,
                    store_backend="tiered", **kw)
    torch.cuda.synchronize()
    launches["a"] = _read_counts()
    events = failed.save_events + res["save_events"]
    ts = res["tier_stats"]
    out["a"].update({
        "losses_resumed": res["losses"],
        "events": [{k: e[k] for k in _TIER_EVENT_KEYS} | {
            "stall_seconds_3a": a_stalls.get(e["step"])} for e in events],
        "spill_drain_seconds": res["spill_drain_seconds"],
        "tier_stats": {k: ts[k] for k in (
            "hot_writes", "hot_reads", "durable_reads", "spilled_objects",
            "spilled_bytes", "promotions", "evictions", "evicted_bytes",
            "hot_resident_bytes", "pending_spill")},
        "restore": {k: res["restore_stats"][k] for k in (
            "seconds", "bytes_read", "tier_reads", "unit_tiers",
            "io_retries")},
        "host_peak_rss_bytes": rss.get("peak"),
        "launches": launches["a"]})
    log(f"3i (a) events {out['a']['events']}; drain "
        f"{res['spill_drain_seconds']:.3f} s; tiers {out['a']['tier_stats']}"
        f"; restore {out['a']['restore']}; peak RSS {rss.get('peak')}")
    out["a"]["loss_diffs"] = losses_equal(res, want_losses, "3i (a)")
    digests_equal(run_a, "3i (a)")
    out["a"]["objects_named"] = _check_named(run_a, "objects/*/*.chunk",
                                             "3i (a)")
    _check_launched(launches["a"], ("block_fp", "fused_adamw"), "3i (a)")
    _release(torch)
    out["a"].update(check_store(torch, dev, run_a, "parity", STEPS - 2))
    out["a"]["seconds"] = time.perf_counter() - ta
    log(f"3i (a) in {out['a']['seconds']:.1f} s")

    # (c) serving from (a)'s root through the tiered backend
    tc = time.perf_counter()
    _release(torch)
    _zero_counts()
    skw = dict(arch=ARCH, reduced=REDUCED, num_layers=NUM_LAYERS,
               batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
               new_tokens=SERVE_NEW, seed=SEED, device=str(dev),
               from_ckpt=str(run_a), from_step=CKPT_INTERVAL,
               hot_swap=True, swap_wait=0.0)
    runs, served = {}, {}
    for backend in ("tiered", "local"):
        with _served_params([]) as trees:
            runs[backend] = serve(store_backend=backend, **skw)
        served[backend] = trees[-1]
    torch.cuda.synchronize()
    launches["c"] = _read_counts()
    params_equal = _params_equal(torch, served["tiered"], served["local"])
    del served
    _release(torch)
    out["c"] = {"reads": {b: {
        "load": {k: r["restore"][k] for k in (
            "seconds", "bytes_read", "tier_reads")},
        "swap": {k: r["swap"][k] for k in (
            "seconds", "bytes_read", "tier_reads", "units_swapped",
            "units_scattered", "units_full")}} for b, r in runs.items()},
        "params_equal": params_equal,
        "tokens_digest": {b: r["tokens_digest"] for b, r in runs.items()},
        "served_step": {b: r["served_step"] for b, r in runs.items()},
        "launches": launches["c"],
        "seconds": time.perf_counter() - tc}
    log(f"3i (c) {out['c']}")
    if not params_equal:
        raise AssertionError("3i (c): tiered and local loads and swaps "
                             "serve different parameters")
    if (len(set(out["c"]["tokens_digest"].values())) != 1
            or set(out["c"]["served_step"].values())
            != {2 * CKPT_INTERVAL}):
        raise AssertionError(f"3i (c): servers differ: {out['c']}")
    _check_launched(launches["c"], ("flash_attention",), "3i (c)")
    REMOVER.discard(run_a)

    # (b) RAM -> disk -> remote, an outage on event 2, a lost disk copy;
    # cut to event 2 (the second cut of 3i to its 150-s budget)
    tb = time.perf_counter()
    run_b = root / "b"
    out["b"] = {"free_bytes": _check_free(root, "3i (b)")}
    kb = dict(kw, store_backend="remote3", remote_opts=dict(TIER_REMOTE))
    at2 = {}
    _zero_counts()
    with _outage_on_event(CKPT_INTERVAL, at2):
        res1 = train(ckpt_dir=str(run_b), total_steps=CKPT_INTERVAL,
                     ckpt_interval=CKPT_INTERVAL, **kb)
    disk, bucket = (_stems(run_b, "objects/*/*.chunk"),
                    _stems(run_b, "remote/*/*.blob"))
    out["b"].update({
        "outage_event_storage": at2.get("storage"),
        "events": [{k: e[k] for k in _TIER_EVENT_KEYS}
                   for e in res1["save_events"]],
        "spill_drain_seconds": res1["spill_drain_seconds"],
        "tier_stats_at_outage_event": at2.get("tier_stats_at_commit"),
        "tier_stats": res1["tier_stats"],
        "disk_objects": len(disk), "bucket_objects": len(bucket)})
    log(f"3i (b) event 2 storage {at2.get('storage')}; drain "
        f"{res1['spill_drain_seconds']:.3f} s; tiers {res1['tier_stats']}")
    st = at2.get("storage") or {}
    if not (st.get("durable_on") == "durable" and st.get("degraded")):
        raise AssertionError(f"3i (b): event 2 did not commit degraded on "
                             f"the disk tier: {st}")
    if res1["tier_stats"]["pending_spill"] or disk != bucket or not disk:
        raise AssertionError(f"3i (b): not fully replicated after the "
                             f"drain: pending {res1['tier_stats']}, disk "
                             f"{len(disk)}, bucket {len(bucket)}")
    out["b"]["blobs_named"] = _check_named(run_b, "remote/*/*.blob",
                                           "3i (b) bucket")
    m2 = ManifestStore(run_b).load(CKPT_INTERVAL)
    lost_unit, lost = next((f"{u}/{k}", r.digest) for u, kinds in
                           sorted(m2.entries.items())
                           for k, r in sorted(kinds.items()))
    (run_b / "objects" / lost[:2] / f"{lost}.chunk").unlink()
    # a full event 2: the resume repeats 3a's uninterrupted run
    res2 = train(ckpt_dir=str(run_b), total_steps=2 * CKPT_INTERVAL,
                 ckpt_interval=CKPT_INTERVAL, resume=True, **kb)
    torch.cuda.synchronize()
    launches["b"] = _read_counts()
    rewarmed = (run_b / "objects" / lost[:2] / f"{lost}.chunk").is_file()
    ts2 = res2["tier_stats"]
    out["b"].update({
        "lost_disk_copy": lost_unit,
        "lost_read_from": res2["restore_stats"]["unit_tiers"].get(lost_unit),
        "rewarmed_on_disk": rewarmed,
        "restore": {k: res2["restore_stats"][k] for k in (
            "seconds", "bytes_read", "tier_reads", "io_retries")},
        "resume_events": [{k: e[k] for k in _TIER_EVENT_KEYS}
                          for e in res2["save_events"]],
        "resume_spill_drain_seconds": res2["spill_drain_seconds"],
        "remote_counters": {k: ts2[k] for k in sorted(ts2)
                            if k.startswith("remote_")},
        "losses_resumed": res2["losses"], "launches": launches["b"]})
    log(f"3i (b) lost {lost_unit} read from {out['b']['lost_read_from']}, "
        f"rewarmed {rewarmed}; restore {out['b']['restore']}; remote "
        f"{out['b']['remote_counters']}")
    out["b"]["loss_diffs"] = losses_equal(res2, rec_a["losses_ref"],
                                          "3i (b)")
    digests_equal(run_b, "3i (b)")
    if out["b"]["lost_read_from"] != "remote" or not rewarmed:
        raise AssertionError(f"3i (b): the lost disk copy of {lost_unit} "
                             "was not read from the bucket and re-warmed")
    if _stems(run_b, "objects/*/*.chunk") != _stems(run_b,
                                                     "remote/*/*.blob"):
        raise AssertionError("3i (b): the bucket and the disk tree differ "
                             "after the resume's drain")
    _check_launched(launches["b"], ("block_fp", "fused_adamw"), "3i (b)")
    out["b"]["seconds"] = time.perf_counter() - tb
    REMOVER.discard(run_b)
    _release(torch)

    # (d) a merge from a live RAM tier, over TIER_MERGE_UNITS
    td = time.perf_counter()
    out["d"] = {"free_bytes": _check_free(root, "3i (d)")}
    ram_root, disk_root, out_root = root / "ram", root / "disk", root / "out"
    state = steps.init_state(model, SEED, dev)
    registry = _units_registry(model, TIER_MERGE_UNITS)
    few = make_policy("full", registry.units)
    mgr_ram = CheckpointManager(ram_root, registry, few, async_save=False,
                                store_backend="memory")
    mgr_disk = CheckpointManager(disk_root, registry, few,
                                 async_save=False)
    try:
        mgr_ram.save(state, step=4)
        unit0 = registry.extract_unit(state["params"], "block_000")
        block0 = {p: x.clone() for p, x in flatten_with_paths(unit0)}
        (_, leaf), *_ = flatten_with_paths(unit0)
        with torch.no_grad():
            leaf.view(-1)[:8] += 1.0
        mgr_disk.save(state, step=4)
        ram_ref = CheckpointRef(ram_root, 4)
        recipe = Recipe(base=CheckpointRef(disk_root, 4), output=out_root,
                        select=[SelectRule(units=["block_000"],
                                           source=ram_ref)],
                        optimizer=False)
        _zero_counts()
        stats = merge(recipe, workers=4, device=dev,
                      stores={str(ram_ref): mgr_ram.store})
        torch.cuda.synchronize()
        launches["d_merge"] = _read_counts()
    finally:
        mgr_ram.close()
        mgr_disk.close()
    meta = ManifestStore(out_root).load(4).meta
    mgr = CheckpointManager(out_root, registry, few, async_save=False)
    try:
        got = mgr.restore(wlike, device=dev, parts=("params",))["params"]
    finally:
        mgr.close()
    unit_equal = {}
    for name in registry.unit_names():
        want = (block0 if name == "block_000" else dict(flatten_with_paths(
            registry.extract_unit(state["params"], name))))
        have = dict(flatten_with_paths(registry.extract_unit(got, name)))
        unit_equal[name] = (sorted(want) == sorted(have) and all(
            torch.equal(want[p], have[p]) for p in want))
    out["d"].update({"merge": stats, "storage": meta["storage"],
                     "merged_from": meta["merged_from"],
                     "unit_equal": unit_equal,
                     "launches": launches["d_merge"],
                     "seconds": time.perf_counter() - td})
    log(f"3i (d) {out['d']}")
    del state, got, block0
    _release(torch)
    if not all(unit_equal.values()):
        raise AssertionError(f"3i (d): restored units differ from their "
                             f"sources: {unit_equal}")
    if (meta["storage"]["backend"], meta["storage"]["durable_on"]) \
            != ("local", "durable"):
        raise AssertionError(f"3i (d): merged storage {meta['storage']}")
    if launches["d_merge"]["block_fp"] != stats["chunks"]:
        raise AssertionError(f"3i (d): block_fp launched "
                             f"{launches['d_merge']['block_fp']} times for "
                             f"{stats['chunks']} copied objects")
    REMOVER.discard(root)
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 3i in {out['seconds']:.1f} s; launches {launches}")


# Phase 3j: its budget and the restore arms of (a); were 3j to run over,
# (b) would be cut to event 2 first, then (a)'s unverified arm
IO_BUDGET_S = 110.0
IO_WORKERS = 4
IO_ARMS = (
    ("sequential", {"restore_threads": 1}),
    ("streaming", {}),
    ("process", {"io_backend": "process", "io_workers": IO_WORKERS}),
    ("unverified", {"restore_verify": False}),
)
_IO_EVENT_KEYS = ("step", "stall_seconds", "d2h_bytes", "written_bytes",
                  "encode_seconds", "write_io_seconds", "commit_seconds",
                  "io_backend")
_IO_RESTORE_KEYS = ("seconds", "pipelined", "io_threads", "verify",
                    "io_backend", "bytes_read", "h2d_bytes", "objects_read",
                    "unique_digests", "planned_object_reads", "targets",
                    "read_seconds", "wait_seconds", "read_io_seconds",
                    "decode_seconds", "h2d_seconds", "verify_seconds",
                    "fallback_units")


def _children_rss(pids) -> int:
    """Resident bytes of the processes ``pids`` (0 for one that is gone)."""
    page = os.sysconf("SC_PAGE_SIZE")
    total = 0
    for pid in pids:
        try:
            with open(f"/proc/{pid}/statm") as f:
                total += int(f.read().split()[1]) * page
        except OSError:
            pass
    return total


@contextlib.contextmanager
def _worker_modules(into: list):
    """Append to ``into`` the modules each process-backed manager's
    workers hold, asked just before the manager closes."""
    from repro_torch.checkpoint.saver import CheckpointManager

    plain = CheckpointManager.close

    def close(self):
        pool = self.transfer_pool
        if pool is not None and pool.workers is not None:
            into.append(pool.workers.call("modules"))
        return plain(self)

    CheckpointManager.close = close
    try:
        yield into
    finally:
        CheckpointManager.close = plain


def phase_3j(torch, dev, store: Path, rec_a: dict, out: dict) -> None:
    """The streaming restore and the process IO workers, right after 3a on
    its store (``store / "3a" / "run"``), the launch counts set to 0
    before each part and read after.  Budget: IO_BUDGET_S (110 s).
    ``rec_a`` is 3a's record (its failing run's losses and events, its
    step-2 and step-4 entry digests).  Fills ``out`` before its checks.

    (a) four full-state restores of step 4 (3a's merge), each into a fresh
    state, the host's pinned-memory cache emptied before each: sequential
    (``restore_threads=1``), streaming (4 reader threads), streaming on
    the process backend (4 threads, IO_WORKERS workers) and streaming with
    ``restore_verify=False``; every leaf ``torch.equal`` to the sequential
    restore's, ``block_fp`` launched by the verifying arms (once per
    target) and never by the unverified one, ``objects_read`` at most
    ``planned_object_reads``; per arm the seconds and their split, the
    worker counts and the host's and the workers' peak RSS.
    (b) 3a's failing run to step 4 on ``io_backend="process"``
    (IO_WORKERS workers, synchronous inline saves): its losses equal 3a's
    failing run's, the step-2 and step-4 entries hold 3a's digests, every
    object's table hashes to its name and its file is as long as 3a's
    (the bytes are held against 3a's on the CPU); the stall of events 2 and
    4 beside 3a's, and the events' worker tasks and shared-memory bytes.
    (c) a weights-only cold load of step 4 through the server
    (``serve(io_backend="process")``) against the thread backend's: equal
    parameters and ``tokens_digest``, and the workers that decoded the
    load hold neither torch nor jax."""
    from repro_torch.checkpoint.saver import CheckpointManager
    from repro_torch.core.layer_registry import LayerRegistry
    from repro_torch.core.policies import make_policy
    from repro_torch.launch import steps
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import SimulatedFailure, train

    t0 = time.perf_counter()
    log(f"phase 3j: budget {IO_BUDGET_S:.0f} s")
    run = store / "3a" / "run"
    root = store / "3j"
    root.mkdir(parents=True, exist_ok=True)
    model = _model()
    registry = LayerRegistry(model)
    like = steps.state_specs(model)
    launches = out["launches"] = {}
    empty_host_cache = getattr(torch._C, "_host_emptyCache", None)

    # (a) four restores of step 4
    ta = time.perf_counter()
    _release(torch)
    arms, ref = {}, None
    launches["a"] = {}
    for name, kw in IO_ARMS:
        if empty_host_cache is not None:
            empty_host_cache()
        mgr = CheckpointManager(run, registry,
                                make_policy("parity", model.layer_units()),
                                async_save=False, **kw)
        pool = mgr.transfer_pool
        pids = (lambda: pool.workers.worker_pids()) \
            if pool is not None and pool.workers is not None else list
        rss, kids = {}, {"peak": 0}
        _zero_counts()
        try:
            with _rss_peak(rss):
                t_arm = time.perf_counter()
                state = mgr.restore(like, device=dev, step=4)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t_arm
                kids["peak"] = _children_rss(pids())
            stats = dict(mgr.last_restore_stats)
        finally:
            mgr.close()
        counts = _read_counts()
        launches["a"][name] = counts
        arms[name] = {k: stats[k] for k in _IO_RESTORE_KEYS} | {
            "wall_seconds": wall, "workers": stats.get("workers"),
            "host_peak_rss_bytes": rss.get("peak"),
            "workers_rss_bytes_at_end": kids["peak"] or None,
            "block_fp_launches": counts["block_fp"]}
        if ref is None:
            ref = state
            arms[name]["equal_sequential"] = True
        else:
            arms[name]["equal_sequential"] = all(
                _params_equal(torch, ref[p], state[p])
                for p in ("params", "opt"))
            del state
        log(f"3j (a) {name}: {arms[name]}")
        torch.cuda.empty_cache()
    del ref
    _release(torch)
    out["a"] = {"arms": arms, "host_cache_emptied": bool(empty_host_cache),
                "seconds": time.perf_counter() - ta}
    log(f"3j (a) in {out['a']['seconds']:.1f} s")
    for name, arm in arms.items():
        if not arm["equal_sequential"]:
            raise AssertionError(f"3j (a) {name}: the restore differs from "
                                 "the sequential one")
        if arm["objects_read"] > arm["planned_object_reads"]:
            raise AssertionError(f"3j (a) {name}: {arm['objects_read']} "
                                 "objects read, more than planned")
        want = arm["targets"] if arm["verify"] else 0
        if arm["block_fp_launches"] != want:
            raise AssertionError(f"3j (a) {name}: {arm['block_fp_launches']}"
                                 f" block_fp launches, want {want}")
        if arm["fallback_units"]:
            raise AssertionError(f"3j (a) {name}: fallbacks "
                                 f"{arm['fallback_units']}")
    if arms["process"]["workers"]["tasks"] <= 0:
        raise AssertionError("3j (a): the process arm ran no worker task")

    # (b) 3a's failing run on the process backend
    tb = time.perf_counter()
    run_b = root / "b"
    _zero_counts()
    rss = {}
    try:
        with _rss_peak(rss):
            train(ckpt_dir=str(run_b), arch=ARCH, reduced=REDUCED,
                  num_layers=NUM_LAYERS, batch=BATCH, seq_len=SEQ,
                  policy_name="parity", seed=SEED, device=str(dev),
                  ckpt_async=False, total_steps=STEPS,
                  ckpt_interval=CKPT_INTERVAL, fail_at=FAIL_AT,
                  io_backend="process", io_workers=IO_WORKERS)
        raise AssertionError("3j (b): the checkpointed run did not fail")
    except SimulatedFailure as e:
        failed = e
    torch.cuda.synchronize()
    launches["b"] = _read_counts()
    log(f"3j (b) run in {time.perf_counter() - tb:.1f} s")
    a_events = {e["step"]: e for e in rec_a["save_events"]}
    want_losses = dict(rec_a["losses_failed_run"])
    events = failed.save_events
    out["b"] = {
        "run_seconds": time.perf_counter() - tb,
        "host_peak_rss_bytes": rss.get("peak"),
        "events": [{k: e[k] for k in _IO_EVENT_KEYS} | {
            "workers": e.get("workers"),
            "stall_seconds_3a": a_events[e["step"]]["stall_seconds"],
            "encode_seconds_3a": a_events[e["step"]]["encode_seconds"],
            "write_io_seconds_3a": a_events[e["step"]]["write_io_seconds"]}
            for e in events],
        "loss_diffs": {s: abs(l - want_losses[s])
                       for s, l in failed.losses},
        "launches": launches["b"]}
    steps_b = sorted(int(s) for s in rec_a["entry_digests"]
                     if int(s) < FAIL_AT)
    digests_equal = True
    for s in steps_b:
        got = {f"{u}/{k}": d for (u, k), d in _entry_digests(run_b, s).items()}
        digests_equal &= got == rec_a["entry_digests"][str(s)]
    # every object's table hashes to its name, and its file is as long as
    # 3a's (the bytes are held against 3a's on the CPU:
    # tests/test_torch_io_workers.py)
    files = sorted((run_b / "objects").glob("*/*.chunk"))
    named = _check_named(run_b, "objects/*/*.chunk", "3j (b)")
    sizes_equal = all(
        p.stat().st_size
        == (run / "objects" / p.parent.name / p.name).stat().st_size
        for p in files)
    out["b"].update({"steps": steps_b, "digests_equal": digests_equal,
                     "objects_named": named, "sizes_equal": sizes_equal,
                     "seconds": time.perf_counter() - tb})
    REMOVER.discard(run_b)
    log(f"3j (b) {out['b']}")
    if not digests_equal or not sizes_equal:
        raise AssertionError("3j (b): the process backend's entries or "
                             "objects differ from 3a's")
    if not all(d <= MODE_TOL for d in out["b"]["loss_diffs"].values()):
        raise AssertionError(f"3j (b): losses off 3a's: "
                             f"{out['b']['loss_diffs']}")
    if [e["step"] for e in events] != steps_b or any(
            e["io_backend"] != "process" or not e["workers"]["lanes"]
            for e in events):
        raise AssertionError(f"3j (b): events {out['b']['events']}")
    _check_launched(launches["b"], ("block_fp", "fused_adamw"), "3j (b)")

    # (c) the server's cold load through the workers
    tc = time.perf_counter()
    _release(torch)
    _zero_counts()
    skw = dict(arch=ARCH, reduced=REDUCED, num_layers=NUM_LAYERS, batch=2,
               prompt_len=128, new_tokens=8, seed=SEED, device=str(dev),
               from_ckpt=str(run), from_step=4)
    runs, served = {}, {}
    with _worker_modules([]) as mods:
        for backend in ("thread", "process"):
            with _served_params([]) as trees:
                runs[backend] = serve(io_backend=backend,
                                      io_workers=IO_WORKERS, **skw)
            served[backend] = trees[-1]
    torch.cuda.synchronize()
    launches["c"] = _read_counts()
    params_equal = _params_equal(torch, served["thread"], served["process"])
    del served
    _release(torch)
    bad = sorted({m for ms in mods for m in ms
                  if m.split(".")[0] in ("torch", "jax", "jaxlib", "repro")})
    out["c"] = {"load": {b: {k: r["restore"][k] for k in (
        "seconds", "bytes_read", "objects_read", "io_backend")}
        | {"workers": r["restore"].get("workers")} for b, r in runs.items()},
        "params_equal": params_equal,
        "tokens_digest": {b: r["tokens_digest"] for b, r in runs.items()},
        "worker_modules": len(mods[0]) if mods else None,
        "worker_forbidden_modules": bad,
        "launches": launches["c"], "seconds": time.perf_counter() - tc}
    log(f"3j (c) {out['c']}")
    if not params_equal or len(set(out["c"]["tokens_digest"].values())) != 1:
        raise AssertionError(f"3j (c): the process load serves other "
                             f"weights: {out['c']}")
    if not mods or bad:
        raise AssertionError(f"3j (c): worker modules {bad} (asked "
                             f"{len(mods)} pools)")
    _check_launched(launches["c"], ("block_fp", "flash_attention"), "3j (c)")
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 3j in {out['seconds']:.1f} s of its {IO_BUDGET_S:.0f}-s "
        "budget")


CACHE_BUDGET_S = 60.0
CACHE_MB = 4096         # (a), (b), (d), (e): holds every distinct object
CACHE_SMALL_BYTES = 256 << 20  # (c): below one block unit's weights object
_CACHE_LOAD_KEYS = ("seconds", "read_seconds", "wait_seconds",
                    "read_io_seconds", "decode_seconds",
                    "cache_copy_seconds", "h2d_seconds", "verify_seconds",
                    "objects_read", "bytes_read", "targets")


def _cache_segments() -> list:
    return sorted(glob.glob(f"/dev/shm/repro-io-{os.getpid():x}-cache-*"))


def phase_3k(torch, dev, store: Path, out: dict) -> None:
    """The block cache on 3a's store (``store / "3a" / "run"``: parity,
    events 2, 4 and 6), right after 3g and before 3h removes that store,
    the launch counts set to 0 before it and read after.  Budget:
    CACHE_BUDGET_S (60 s).  Three weights-only variants through
    ``VariantSet`` on one manager: @6, @6 with one block unit's weights
    from @2, @6 with another's (the first two block units whose @2 and @6
    weights digests differ; recorded).  Fills ``out`` before its checks.

    (a) the three on a manager with a CACHE_MB RAM cache and on one
    without: every cached variant's parameters bitwise equal to its
    uncached twin's; cached ``backend_reads`` equal to the distinct digests
    the three manifests name (objects and delta bases), uncached to the
    sum over the variants; ``misses`` equal to the distinct count and
    ``hits`` to the rest; ``block_fp`` launched once per target per
    variant in both arms; each load's seconds and split (read, file read,
    decode, the cache's copies, h2d, verify), the snapshot and the host's
    peak RSS recorded.
    (b) the cached arm with ``block_cache_shm=True``: equal parameters;
    ``repro-io-<pid:x>-cache-*`` segments exist before ``close()`` and
    none after.
    (c) the cached arm with a CACHE_SMALL_BYTES budget (below one block
    unit's weights object: ``bypassed`` > 0), then with half the distinct
    objects' bytes (``evictions`` > 0), each with (a)'s parameters.
    (d) the cached arm on ``io_backend="process"`` (IO_WORKERS workers):
    equal parameters, no worker restart.
    (e) ``serve(cache_mb=CACHE_MB, variant_select=...)`` of the first
    mixed variant (batch 8 x 1024, 128 tokens, as 3g) against the same
    variant served without a cache: a snapshot in the result and one
    ``tokens_digest``."""
    from repro_torch.checkpoint.saver import CheckpointManager
    from repro_torch.checkpoint.swap import VariantSet
    from repro_torch.core.layer_registry import LayerRegistry
    from repro_torch.core.manifest import ManifestStore
    from repro_torch.core.policies import make_policy
    from repro_torch.core.tailor import variant_manifest
    from repro_torch.launch import steps
    from repro_torch.launch.serve import serve

    t0 = time.perf_counter()
    log(f"phase 3k: budget {CACHE_BUDGET_S:.0f} s")
    run = store / "3a" / "run"
    model = _model()
    registry = LayerRegistry(model)
    like = steps.state_specs(model)
    ms = ManifestStore(run)
    m2, m6 = ms.load(2), ms.load(STEPS)
    picked = [u for u in registry.unit_names() if u.startswith("block_")
              and m2.entries[u]["weights"].digest
              != m6.entries[u]["weights"].digest][:2]
    if len(picked) < 2:
        raise AssertionError(f"3k: fewer than two block units differ "
                             f"between @2 and @{STEPS}: {picked}")
    variants = (("base", []), (f"{picked[0]}@2", [([picked[0]], 2)]),
                (f"{picked[1]}@2", [([picked[1]], 2)]))
    reads_of = {}
    for name, select in variants:
        m = variant_manifest(ms, base_step=STEPS, select=select)
        reads_of[name] = {d for kinds in m.entries.values()
                          for d in (kinds["weights"].digest,
                                    kinds["weights"].delta_base) if d}
    distinct = set().union(*reads_of.values())
    sizes = {d: (run / "objects" / d[:2] / f"{d}.chunk").stat().st_size
             for d in distinct}
    want_sum = sum(len(r) for r in reads_of.values())
    out.update({"variants": [n for n, _ in variants], "units": picked,
                "distinct_digests": len(distinct),
                "distinct_bytes": sum(sizes.values()),
                "reads_summed_over_variants": want_sum})
    launches = out["launches"] = {}

    def arm(label: str, before_close=None, **kw) -> dict:
        """The three variants on one manager: its record, and the served
        params by variant (kept for the comparisons)."""
        _release(torch)
        _zero_counts()
        mgr = CheckpointManager(run, registry, make_policy(
            "parity", model.layer_units()), async_save=False, **kw)
        rss, rec = {}, {}
        try:
            with _rss_peak(rss):
                t_arm = time.perf_counter()
                r0 = mgr.store.backend_reads
                vs = VariantSet(mgr, like, device=dev)
                for name, select in variants:
                    vs.materialize(name, base_step=STEPS, select=select)
                torch.cuda.synchronize()
                rec["seconds"] = time.perf_counter() - t_arm
            st = vs.stats()
            rec.update({
                "backend_reads": mgr.store.backend_reads - r0,
                "cache": st["cache"], "host_peak_rss_bytes": rss.get("peak"),
                "loads": {n: {k: v.get(k) for k in _CACHE_LOAD_KEYS}
                          | {"workers": v.get("workers")}
                          for n, v in st["variants"].items()}})
            if before_close is not None:
                rec.update(before_close())
            params = {n: vs.params(n) for n, _ in variants}
        finally:
            mgr.close()
        launches[label] = _read_counts()
        rec["block_fp_launches"] = launches[label]["block_fp"]
        log(f"3k {label}: {rec}")
        return rec, params

    def equal(a: dict, b: dict) -> bool:
        return all(_params_equal(torch, a[n], b[n]) for n, _ in variants)

    # (a) cached and uncached
    ta = time.perf_counter()
    cached, ref = arm("a_cached", block_cache_bytes=CACHE_MB << 20)
    uncached, twin = arm("a_uncached")
    a_equal = equal(ref, twin)
    del twin
    out["a"] = {"cached": cached, "uncached": uncached,
                "params_equal": a_equal, "seconds": time.perf_counter() - ta}
    n_targets = len(registry.unit_names()) * len(variants)
    snap = cached["cache"]
    if not a_equal:
        raise AssertionError("3k (a): a cached variant differs from its "
                             "uncached twin")
    if (cached["backend_reads"] != len(distinct)
            or uncached["backend_reads"] != want_sum):
        raise AssertionError(
            f"3k (a): backend reads cached {cached['backend_reads']} (want "
            f"{len(distinct)}), uncached {uncached['backend_reads']} (want "
            f"{want_sum})")
    if (snap["misses"] != len(distinct)
            or snap["hits"] != want_sum - len(distinct)):
        raise AssertionError(f"3k (a): cache counters {snap}")
    if cached["block_fp_launches"] != n_targets \
            or uncached["block_fp_launches"] != n_targets:
        raise AssertionError(
            f"3k (a): block_fp launched {cached['block_fp_launches']} and "
            f"{uncached['block_fp_launches']} times, want {n_targets} each")

    # (b) entries in /dev/shm
    tb = time.perf_counter()
    shm, got = arm("b_shm", lambda: {"segments_before_close":
                                     len(_cache_segments())},
                   block_cache_bytes=CACHE_MB << 20, block_cache_shm=True)
    shm.update({"params_equal": equal(ref, got),
                "segments_after_close": len(_cache_segments()),
                "seconds": time.perf_counter() - tb})
    del got
    out["b"] = shm
    if not shm["params_equal"] or not shm["segments_before_close"] \
            or shm["segments_after_close"]:
        raise AssertionError(f"3k (b): {shm}")

    # (c) a budget below one object, then below the working set
    tc = time.perf_counter()
    out["c"] = {}
    for label, budget in (("below_one_object", CACHE_SMALL_BYTES),
                          ("below_working_set", sum(sizes.values()) // 2)):
        rec, got = arm(f"c_{label}", block_cache_bytes=budget)
        rec.update({"budget_bytes": budget,
                    "params_equal": equal(ref, got)})
        del got
        out["c"][label] = rec
    out["c"]["seconds"] = time.perf_counter() - tc
    small, half = out["c"]["below_one_object"], out["c"]["below_working_set"]
    if not (small["params_equal"] and half["params_equal"]):
        raise AssertionError("3k (c): a small cache served other weights")
    if small["cache"]["bypassed"] <= 0 or half["cache"]["evictions"] <= 0:
        raise AssertionError(f"3k (c): bypassed {small['cache']}, evicted "
                             f"{half['cache']}")

    # (d) the process backend
    td = time.perf_counter()
    proc, got = arm("d_process", block_cache_bytes=CACHE_MB << 20,
                    io_backend="process", io_workers=IO_WORKERS)
    restarts = sum((v["workers"] or {}).get("worker_restarts", 0)
                   for v in proc["loads"].values())
    proc.update({"params_equal": equal(ref, got),
                 "worker_restarts": restarts,
                 "seconds": time.perf_counter() - td})
    del got, ref
    out["d"] = proc
    if not proc["params_equal"] or restarts \
            or proc["backend_reads"] != len(distinct):
        raise AssertionError(f"3k (d): {proc}")

    # (e) the server through the cache
    te = time.perf_counter()
    _release(torch)
    _zero_counts()
    skw = dict(arch=ARCH, reduced=REDUCED, num_layers=NUM_LAYERS,
               batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
               new_tokens=SERVE_NEW, seed=SEED, device=str(dev),
               from_ckpt=str(run), variant_base_step=STEPS,
               variant_select=[f"{picked[0]}@2"])
    served = {"cached": serve(cache_mb=CACHE_MB, **skw),
              "uncached": serve(**skw)}
    torch.cuda.synchronize()
    launches["e"] = _read_counts()
    out["e"] = {"cache": served["cached"]["cache"],
                "tokens_digest": {k: r["tokens_digest"]
                                  for k, r in served.items()},
                "load_seconds": {k: r["restore"]["seconds"]
                                 for k, r in served.items()},
                "prefill_seconds": {k: r["prefill_seconds"]
                                    for k, r in served.items()},
                "seconds": time.perf_counter() - te}
    out["seconds"] = time.perf_counter() - t0
    log(f"3k (e) {out['e']}; phase 3k in {out['seconds']:.1f} s of its "
        f"{CACHE_BUDGET_S:.0f}-s budget, launches {launches}")
    if out["e"]["cache"] is None or len(set(
            out["e"]["tokens_digest"].values())) != 1:
        raise AssertionError(f"3k (e): {out['e']}")
    _check_launched(launches["e"], ("block_fp", "flash_attention"), "3k (e)")


# ---------------------------------------------------------------- phase 3l
SCRUB_BUDGET_S = 60.0


def _envelope_fields(path: Path, digest: str) -> dict:
    """An object's envelope but its payload, parsed from a map of the file
    (the payload's pages are never read)."""
    import mmap

    from repro_torch.checkpoint import workers

    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    try:
        env = workers.parse_envelope(mm, digest)
        fields = {k: (bytes(v) if isinstance(v, memoryview) else v)
                  for k, v in env.items() if k != "payload"}
    finally:
        env = None
        mm.close()
    return fields


def _listing(root: Path) -> dict:
    return {str(p.relative_to(root)): p.stat().st_size
            for p in sorted(root.rglob("*")) if p.is_file()}


def _hard_link_tree(src: Path, dst: Path) -> None:
    """Every file of ``src`` hard-linked under ``dst``."""
    for f in sorted(src.rglob("*")):
        if f.is_file():
            (dst / f.relative_to(src)).parent.mkdir(parents=True,
                                                    exist_ok=True)
            os.link(f, dst / f.relative_to(src))


@contextlib.contextmanager
def _backend_reads(into: list):
    """Record the digest of every object read through a store (restores,
    a delta's base), not the scrub's reads of tier copies."""
    from repro_torch.checkpoint.chunk_store import ChunkStore

    plain = ChunkStore._read_blob

    def read_blob(self, digest, alloc=None):
        into.append(digest)
        return plain(self, digest, alloc)

    ChunkStore._read_blob = read_blob
    try:
        yield into
    finally:
        ChunkStore._read_blob = plain


def phase_3l(torch, dev, store: Path, out: dict) -> None:
    """The store scrub on 3a's store (``store / "3a" / "run"``: parity,
    events 2, 4 and 6), right after 3k and before 3h resumes and removes
    that store, the launch counts set to 0 before each part and read after
    it.  Budget: SCRUB_BUDGET_S (60 s).  Fills ``out`` before its checks.

    (a) An audit, ``mgr.scrub(repair=False)`` on the card: every object
    healthy; ``checked_objects`` equal to the distinct digests (entries
    and delta bases) the committed manifests name; ``block_fp`` launched
    once per table-checked object (one tier); the store's file listing
    and sizes unchanged, and no ``QUARANTINE.json``.
    (b) On a hard-linked copy of the store: the smallest (unit, kind) of
    LATEST saved there as a full object whose unit an older manifest holds
    under another digest; its object copied out of the link and one
    payload byte flipped under a recomputed crc32 (as 3g (c)), so its
    records and table hash still pass and only the table recomputed on the
    card sees it.  ``train(resume=True, scrub_on_start=True)`` one step
    past LATEST, no save: the report lists the digest unrecoverable
    ("corrupt in every tier") with its manifests and (unit, kind);
    ``QUARANTINE.json`` is written; the restore reports
    ``quarantined_skipped`` >= 1 and reads no byte of the victim; the
    unit's restored tensors fingerprint on the card to the table of the
    older object the planner chose.  The good bytes put back, a second
    ``mgr.scrub()`` lists the digest in ``released_from_quarantine`` and
    removes ``QUARANTINE.json``."""
    from repro_torch.checkpoint import fingerprint as fputil
    from repro_torch.checkpoint import workers
    from repro_torch.checkpoint.chunk_store import table_checked
    from repro_torch.checkpoint.saver import CheckpointManager
    from repro_torch.core.layer_registry import LayerRegistry
    from repro_torch.core.manifest import ManifestStore
    from repro_torch.core.policies import make_policy
    from repro_torch.kernels import block_fp as bfp
    from repro_torch.launch.train import train

    t0 = time.perf_counter()
    log(f"phase 3l: budget {SCRUB_BUDGET_S:.0f} s")
    run = store / "3a" / "run"
    model = _model()
    registry = LayerRegistry(model)
    policy = make_policy("parity", model.layer_units())
    ms = ManifestStore(run)
    named = set()
    for s in ms.all_steps():
        named.update(ms.load(s).digest_provenance())
    envs = {d: _envelope_fields(run / "objects" / d[:2] / f"{d}.chunk", d)
            for d in sorted(named)}
    n_table = sum(table_checked(e) for e in envs.values())
    nbytes = sum((run / "objects" / d[:2] / f"{d}.chunk").stat().st_size
                 for d in named)
    out.update({"objects": len(named), "table_checked": n_table,
                "bytes": nbytes})
    launches = out["launches"] = {}
    listing = _listing(run)

    # (a) the audit
    _release(torch)
    _zero_counts()
    ta = time.perf_counter()
    mgr = CheckpointManager(run, registry, policy, async_save=False)
    try:
        rep_a = mgr.scrub(repair=False, device=dev)
    finally:
        mgr.close()
    torch.cuda.synchronize()
    launches["a"] = _read_counts()
    out["a"] = {"report": {k: v for k, v in rep_a.items()
                           if k not in ("repaired", "unrecoverable")},
                "seconds": time.perf_counter() - ta,
                "listing_unchanged": _listing(run) == listing}
    log(f"3l (a) {out['a']}, launches {launches['a']}")
    if not (rep_a["checked_objects"] == rep_a["healthy"] == len(named)
            and not rep_a["repaired"] and not rep_a["unrecoverable"]):
        raise AssertionError(f"3l (a): the audit of a healthy store: "
                             f"{rep_a}")
    if launches["a"]["block_fp"] != n_table:
        raise AssertionError(f"3l (a): block_fp launched "
                             f"{launches['a']['block_fp']} times, want one "
                             f"per table-checked object ({n_table})")
    if not out["a"]["listing_unchanged"] \
            or (run / "QUARANTINE.json").exists():
        raise AssertionError("3l (a): the audit changed the store")

    # (b) a flip only the card's table check sees, through the trainer
    tb = time.perf_counter()
    copy = store / "3l"
    _hard_link_tree(run, copy)
    latest = ms.load()
    older = [(s, ms.load(s)) for s in reversed(ms.all_steps())
             if s < latest.step]
    victim = fallback = None
    for (unit, kind), ref in sorted(
            (((u, k), r) for u, kinds in latest.entries.items()
             for k, r in kinds.items()), key=lambda x: (x[1].nbytes, x[0])):
        if ref.step != latest.step or ref.stored != "full":
            continue
        # the planner's next candidate: the newest older entry of another
        # digest
        prev = next((m.entries[unit][kind] for _, m in older
                     if unit in m.entries
                     and m.entries[unit][kind].digest != ref.digest), None)
        if prev is not None:
            victim, fallback = (unit, kind, ref), prev
            break
    if victim is None:
        raise AssertionError("3l (b): no LATEST object with an older "
                             "digest of its unit")
    unit, kind, ref = victim
    vpath = copy / ref.relpath
    data = vpath.read_bytes()
    vpath.unlink()
    vpath.write_bytes(data)     # out of the link: 3a's file stays good
    del data
    flip_payload_byte(vpath, ref.digest)
    env = workers.parse_envelope(vpath.read_bytes(), ref.digest)
    workers.decode_chunk_items(env["payload"], True)   # the crc32s pass
    if fputil.fp_digest(bytes(env["fp"])) != ref.digest:
        raise AssertionError("3l (b): the flip changed the table")
    del env
    _release(torch)
    _zero_counts()
    at_restore, read = {}, []
    plain_restore = CheckpointManager.restore

    def restore(self, *args, **kwargs):
        state = plain_restore(self, *args, **kwargs)
        at_restore.update(_read_counts())
        tree = (registry.extract_unit(state["params"], unit)
                if kind == "weights" else
                registry.extract_opt_unit(state["opt"], unit))
        cur = bfp.tree_to_host(bfp.fingerprint_tree(tree))
        at_restore["unit_equals_older_table"] = (
            fputil.pack_table(cur) == fputil.pack_table(
                self.store.load_fp_table(fallback.digest)))
        return state

    CheckpointManager.restore = restore
    try:
        with _backend_reads(read):
            res = train(arch=ARCH, reduced=REDUCED, num_layers=NUM_LAYERS,
                        batch=BATCH, seq_len=SEQ, policy_name="parity",
                        seed=SEED, device=str(dev), ckpt_async=False,
                        ckpt_dir=str(copy), total_steps=latest.step + 1,
                        ckpt_interval=CKPT_INTERVAL, resume=True,
                        scrub_on_start=True)
    finally:
        CheckpointManager.restore = plain_restore
    torch.cuda.synchronize()
    launches["b_train"] = _read_counts()
    rep_b = res["scrub_report"]
    rstats = res["restore_stats"]
    bad = {r["digest"]: r for r in rep_b["unrecoverable"]}
    quarantined = (copy / "QUARANTINE.json").exists()
    out["b"] = {"victim": {"unit": unit, "kind": kind, "step": ref.step,
                           "digest": ref.digest, "bytes": ref.nbytes,
                           "fallback_manifest": next(
                               st for st, m in older
                               if m.entries[unit][kind].digest
                               == fallback.digest),
                           "fallback_object_step": fallback.step,
                           "fallback_digest": fallback.digest},
                "report": {k: v for k, v in rep_b.items()
                           if k not in ("repaired",)},
                "quarantine_written": quarantined,
                "restore": {k: rstats.get(k) for k in (
                    "seconds", "quarantined_skipped", "fallback_units",
                    "objects_read", "bytes_read")},
                "victim_read": ref.digest in read,
                "unit_equals_older_table":
                    at_restore.get("unit_equals_older_table"),
                "losses": res["losses"] if "losses" in res else None,
                "steps": res["steps"]}
    rec = bad.get(ref.digest)
    log(f"3l (b) victim {unit}/{kind}@{ref.step}: {rec}; restore "
        f"{out['b']['restore']}; launches {launches['b_train']}")
    if rec is None or rec["reason"] != "corrupt in every tier" \
            or [unit, kind] not in rec["units"] \
            or latest.step not in rec["manifests"] or len(bad) != 1:
        raise AssertionError(f"3l (b): the flip was not reported "
                             f"unrecoverable with its provenance: "
                             f"{rep_b['unrecoverable']}")
    if not quarantined or not rstats["quarantined_skipped"] >= 1 \
            or ref.digest in read:
        raise AssertionError(f"3l (b): quarantine written {quarantined}, "
                             f"skipped {rstats['quarantined_skipped']}, "
                             f"victim read {ref.digest in read}")
    if not at_restore.get("unit_equals_older_table") or res["steps"] != 1:
        raise AssertionError(f"3l (b): {unit}/{kind} restored is not step "
                             f"{fallback.step}'s object, or the run took "
                             f"{res['steps']} steps")
    _check_launched(launches["b_train"], ("block_fp", "fused_adamw"),
                    "3l (b)")
    # the operator puts the good bytes back: the next scrub releases it
    _release(torch)
    _zero_counts()
    tr = time.perf_counter()
    tmp = vpath.with_suffix(".good")
    shutil.copyfile(run / ref.relpath, tmp)
    os.replace(tmp, vpath)
    mgr = CheckpointManager(copy, registry, policy, async_save=False)
    try:
        rep_r = mgr.scrub(device=dev)
    finally:
        mgr.close()
    torch.cuda.synchronize()
    launches["b_release"] = _read_counts()
    out["b"]["release"] = {
        "released_from_quarantine": rep_r["released_from_quarantine"],
        "quarantined": rep_r["quarantined"],
        "healthy": rep_r["healthy"],
        "quarantine_file_removed": not (copy / "QUARANTINE.json").exists(),
        "seconds": time.perf_counter() - tr}
    out["b"]["seconds"] = time.perf_counter() - tb
    REMOVER.discard(copy)
    out["seconds"] = time.perf_counter() - t0
    out["within_budget"] = out["seconds"] <= SCRUB_BUDGET_S
    log(f"3l (b) release {out['b']['release']}; phase 3l in "
        f"{out['seconds']:.1f} s of its {SCRUB_BUDGET_S:.0f}-s budget, "
        f"launches {launches}")
    if rep_r["released_from_quarantine"] != [ref.digest] \
            or rep_r["unrecoverable"] or rep_r["healthy"] != len(named) \
            or not out["b"]["release"]["quarantine_file_removed"]:
        raise AssertionError(f"3l (b): the repaired store's scrub: {rep_r}")
    if launches["b_release"]["block_fp"] != n_table:
        raise AssertionError(f"3l (b): the release scrub launched block_fp "
                             f"{launches['b_release']['block_fp']} times, "
                             f"want {n_table}")


# ---------------------------------------------------------------- phase 3m
# Phase 3m: its budget, stated before its first run (three events of ~10
# s at 3a's event 2, two restores of ~8 s, three process starts, two
# scrubs of 6-11 s as 3l's, two params-only probes) and its drill.
SUPERVISOR_BUDGET_S = 100.0
SUP_STEPS = 6
SUP_INTERVAL = 3
SUP_KILL_AT = 4
SUP_TERM_AT = 4


def phase_3m(torch, dev, store: Path, ref: dict, out: dict) -> None:
    """The resiliency supervisor at 3a's configuration (model, data, seed,
    lr; policy ``full``, a save every SUP_INTERVAL steps, SUP_STEPS
    steps), after 3h removed 3a's store, the launch counts set to 0 before
    it and read after it.  Budget: SUPERVISOR_BUDGET_S.  Fills ``out``
    before its checks.

    ``Supervisor`` runs ``python -m repro_torch.launch.train`` on the card
    as a child: attempt 0 is SIGKILLed once it reports step SUP_KILL_AT
    (event 3 committed), attempt 1 resumes and gets SIGTERM at step
    SUP_TERM_AT (a preemption save of every unit one or two steps later,
    exit 17), attempt 2 resumes from it, commits event 6 and exits 0;
    between attempts the supervisor scrubs the store and probes a
    weights-only restore, both on the card in this process.  Checks (the
    JAX package's acceptance drill, ``tests/test_resiliency.py``): the run
    completes; the kill loses at most SUP_INTERVAL steps with event 3
    committed; the preemption loses none and commits the step it reached;
    every MTTR window closes; no probe falls back; goodput in (0, 1]; the
    merged losses cover every step, each within MODE_TOL of 3a's
    uninterrupted run ``ref`` (policies do not change training); a last
    probe reads step SUP_STEPS with no fallback; each scrub finds nothing
    unrecoverable and checks as many objects as the manifests name; the
    preempted and the completed child ran on this card (their
    ``device`` and ``peak_device_bytes``) and launched ``fused_adamw``
    and ``block_fp``; the scrubs and probes launched ``block_fp``
    here."""
    from repro_torch.core.manifest import ManifestStore
    from repro_torch.launch import elastic
    from repro_torch.launch.supervisor import (EXIT_PREEMPTED, Injection,
                                               Supervisor, merged_losses)

    t0 = time.perf_counter()
    log(f"phase 3m: budget {SUPERVISOR_BUDGET_S:.0f} s")
    _release(torch)
    root = store / "3m"
    ckpt = root / "ckpt"
    _zero_counts()
    sup = Supervisor(
        ckpt, run_dir=root / "run", arch=ARCH, reduced=REDUCED,
        num_layers=NUM_LAYERS, batch=BATCH, seq_len=SEQ, seed=SEED,
        policy="full", steps=SUP_STEPS, interval=SUP_INTERVAL,
        injections=[Injection("kill", at_step=SUP_KILL_AT),
                    Injection("sigterm", at_step=SUP_TERM_AT)],
        verify_restore=True, scrub_on_restart=True, io_backend="thread",
        device=str(dev), max_restarts=0, attempt_timeout=300)
    report = sup.run()
    torch.cuda.synchronize()
    launches = _read_counts()
    _release(torch)
    _zero_counts()
    final = elastic.probe_restore(ckpt, ARCH, reduced=REDUCED,
                                  num_layers=NUM_LAYERS, device=dev)
    final["block_fp_launches"] = _read_counts()["block_fp"]
    _release(torch)
    merged = merged_losses(root / "run")
    # the digests that the manifests on disk named when each scrub ran
    # (those up to the step then committed: nothing is removed at keep 8)
    ms = ManifestStore(ckpt)
    named = {s: set(ms.load(s).digest_provenance()) for s in ms.all_steps()}
    scrubs = [dict(i["scrub"], named_digests=len(set().union(
        *(d for s, d in named.items() if s <= i["committed_step"]))))
        for i in report["interruptions"] if i.get("scrub")]
    probes = [i["restore_probe"] for i in report["interruptions"]]
    ref_loss = dict(ref["losses"])
    diffs = {s: abs(l - ref_loss[s]) for s, l in merged.items()}
    attempts = report["attempts"]
    child_launches = {
        a["attempt"]: (a["result"] or {}).get("kernel_launches")
        for a in attempts}
    out.update({
        "config": f"{ARCH} full width, {NUM_LAYERS} layers, batch {BATCH}, "
                  f"seq {SEQ}, full, ckpt every {SUP_INTERVAL}, "
                  f"{SUP_STEPS} steps, kill at {SUP_KILL_AT}, sigterm at "
                  f"{SUP_TERM_AT}, thread IO backend",
        "report": report, "scrubs": scrubs, "probes": probes,
        "final_probe": final, "merged_losses": merged,
        "loss_diffs_vs_3a_reference": diffs, "launches": launches,
        "child_launches": child_launches})
    # the phase's seconds end once its store is out of the way (its
    # deletion runs behind the next phase)
    REMOVER.discard(root)
    out["seconds"] = time.perf_counter() - t0
    out["within_budget"] = out["seconds"] <= SUPERVISOR_BUDGET_S
    for a in attempts:
        log(f"3m attempt {a['attempt']}: exit {a['exit_code']}, "
            f"{a['steps_executed']} steps to {a['reached_step']} in "
            f"{a['seconds']:.1f} s, first progress after "
            f"{a['launch_to_first_progress']:.1f} s, startup "
            f"{a['startup']}, result {a['result']}")
    for i in report["interruptions"]:
        log(f"3m interruption {i}")
    log(f"3m scrubs {scrubs}; probes {probes}; final probe {final}; loss "
        f"diffs vs 3a {diffs}; phase 3m in {out['seconds']:.1f} s (to its "
        f"store's discard) of its {SUPERVISOR_BUDGET_S:.0f}-s budget, "
        f"launches {launches}")
    if not report["completed"] or len(report["interruptions"]) != 2:
        raise AssertionError(f"3m: the supervised run: {report}")
    kill, preempt = report["interruptions"]
    if not (kill["kind"] == "kill" and not kill["preempted"]
            and 0 <= kill["lost_steps"] <= SUP_INTERVAL
            and kill["committed_step"] >= SUP_INTERVAL):
        raise AssertionError(f"3m: the kill {kill}")
    if not (preempt["kind"] == "sigterm" and preempt["preempted"]
            and preempt["exit_code"] == EXIT_PREEMPTED
            and preempt["lost_steps"] == 0
            and preempt["committed_step"] == preempt["reached_step"]):
        raise AssertionError(f"3m: the preemption {preempt}")
    for i in (kill, preempt):
        if i["mttr_seconds"] is None or i["restore_probe"]["fallback_units"]:
            raise AssertionError(f"3m: an open MTTR window or a probe that "
                                 f"fell back: {i}")
    if not 0 < report["goodput_steps"] <= 1:
        raise AssertionError(f"3m: goodput_steps {report['goodput_steps']}")
    if sorted(merged) != list(range(SUP_STEPS)) or \
            not all(d <= MODE_TOL for d in diffs.values()):
        raise AssertionError(f"3m: merged losses off 3a's reference: "
                             f"{diffs}")
    if final["step"] != SUP_STEPS or final["fallback_units"]:
        raise AssertionError(f"3m: the last probe {final}")
    if len(scrubs) != 2 or any(
            s["unrecoverable"] or s["checked_objects"] != s["named_digests"]
            for s in scrubs):
        raise AssertionError(f"3m: the scrubs between attempts: {scrubs}")
    on_card = dev.type == "cuda"
    name = torch.cuda.get_device_name(dev) if on_card else "cpu"
    for a in attempts[1:]:
        r = a["result"] or {}
        if r.get("device") != name or (on_card and
                                       not r.get("peak_device_bytes")):
            raise AssertionError(f"3m: attempt {a['attempt']} did not run "
                                 f"on {name}: {r}")
    # (the last attempt runs no step when the preemption came at the end)
    _check_launched({k: sum(a["result"]["kernel_launches"][k]
                            for a in attempts[1:])
                     for k in ("fused_adamw", "block_fp")},
                    ("fused_adamw", "block_fp"), "3m's children")
    _check_launched(launches, ("block_fp",), "3m's scrubs and probes")


# ---------------------------------------------------------------- phase 3n
SHARD_BUDGET_S = 60.0
SHARD_PARTICIPANTS = 4          # the failing run's save participants
SHARD_RESUME_PARTICIPANTS = 2   # the resume's (the elastic path)
_SHARD_EVENT_KEYS = ("stall_seconds", "snapshot_seconds", "commit_seconds",
                     "participant_seconds",
                     "participant_fingerprint_seconds",
                     "participant_d2h_seconds", "participant_write_seconds",
                     "d2h_bytes", "written_bytes", "dedup_hits",
                     "delta_chunks", "full_chunks")


@contextlib.contextmanager
def _restored_state(into: dict):
    """Keep in ``into`` a copy of the state and the stats of the first
    ``CheckpointManager.restore`` made while the block runs (a trainer's
    resume: its state is then trained in place)."""
    from repro_torch.checkpoint.saver import CheckpointManager

    plain = CheckpointManager.restore

    def restore(self, *args, **kwargs):
        state = plain(self, *args, **kwargs)
        if not into:
            into["state"] = clone_state(state)
            into["stats"] = dict(self.last_restore_stats)
        return state

    CheckpointManager.restore = restore
    try:
        yield into
    finally:
        CheckpointManager.restore = plain


@contextlib.contextmanager
def _sharded_events(into: list):
    """Append a row to ``into`` for each ``ShardedCheckpointer.save`` that
    commits: its step, participants and shard objects, the ``block_fp``
    launches made while it ran (the trainers of 3n launch nothing else
    meanwhile) and its stats."""
    from repro_torch.checkpoint.sharded import ShardedCheckpointer
    from repro_torch.kernels import block_fp as bfp

    plain = ShardedCheckpointer.save

    def save(self, *args, **kwargs):
        n0 = bfp.KERNEL.launches
        manifest = plain(self, *args, **kwargs)
        st = self.mgr.last_save_stats
        into.append({"step": manifest.step,
                     "participants": st["participants"],
                     "shard_objects": st["shard_objects"],
                     "block_fp_launches": bfp.KERNEL.launches - n0}
                    | {k: st[k] for k in _SHARD_EVENT_KEYS})
        return manifest

    ShardedCheckpointer.save = save
    try:
        yield into
    finally:
        ShardedCheckpointer.save = plain


def phase_3n(torch, dev, store: Path, rec_a: dict, out: dict) -> None:
    """Shard-native saves with virtual participants (ROADMAP A4.1) at 3a's
    configuration (model, data, seed, parity, a save every 2 steps, the
    crash at step 5): a run saving through SHARD_PARTICIPANTS (4)
    participants fails at step 5, and its resume from step 4 saves through
    SHARD_RESUME_PARTICIPANTS (2), the elastic path; the launch counts set
    to 0 before the runs and read after them.  Budget: SHARD_BUDGET_S.
    ``rec_a`` is 3a's record (3a's store is gone by then: 3n runs last and
    holds nothing of the phases before it).  Fills ``out`` before its
    checks.

    (a) every event (2 and 4 by 4 participants, 6 by 2) commits shard sets
    that the coordinator finds tiling the model's leaves, each with as
    many shard objects as the event reports, and its ``block_fp``
    launches equal those shard objects: one per (unit, kind, participant)
    with a piece; (b) the resumed losses equal 3a's within MODE_TOL (the
    same Frankenstein from the same bytes); (c) step 4 restored from 3n's
    store (the resume's full restore, copied on the card as it returned)
    fingerprints to 3a's step-4 entry digests, the content addresses 3a's
    store gave its step-4 tensors, unit by unit; (d) owned restores of step 4 by each of 2
    participants each read fewer bytes than that full restore, and
    ``combine_states`` of them equals it bitwise; (e) the unchanged
    re-save of the restored step 4 by 4 participants moves 0 B device->
    host and writes 0 B."""
    from repro_torch.checkpoint.saver import CheckpointManager
    from repro_torch.checkpoint.sharded import (ShardCoordinator,
                                                ShardedCheckpointer,
                                                combine_states,
                                                participant_wanted)
    from repro_torch.core.layer_registry import LayerRegistry
    from repro_torch.core.manifest import ManifestStore, is_sharded
    from repro_torch.core.policies import make_policy
    from repro_torch.kernels import block_fp as bfp
    from repro_torch.launch import steps
    from repro_torch.launch.train import SimulatedFailure, train

    t0 = time.perf_counter()
    log(f"phase 3n: budget {SHARD_BUDGET_S:.0f} s")
    _release(torch)
    root = store / "3n"
    run = root / "run"
    model = _model()
    registry = LayerRegistry(model)
    like = steps.state_specs(model)
    parts = ("params", "opt")
    kw = dict(arch=ARCH, reduced=REDUCED, num_layers=NUM_LAYERS,
              batch=BATCH, seq_len=SEQ, policy_name="parity", seed=SEED,
              device=str(dev), ckpt_async=False, ckpt_dir=str(run),
              total_steps=STEPS, ckpt_interval=CKPT_INTERVAL)
    events, restored = [], {}
    _zero_counts()
    with _sharded_events(events):
        try:
            train(fail_at=FAIL_AT, shard_participants=SHARD_PARTICIPANTS,
                  **kw)
            raise AssertionError("3n: the sharded run did not fail")
        except SimulatedFailure as e:
            losses_failed = list(e.losses)
        with _restored_state(restored):
            res = train(resume=True,
                        shard_participants=SHARD_RESUME_PARTICIPANTS, **kw)
    torch.cuda.synchronize()
    launches = _read_counts()
    t_runs = time.perf_counter() - t0
    want = dict(rec_a["losses_resumed"])
    diffs = {s: abs(l - want[s]) for s, l in res["losses"]}
    out.update({
        "config": f"{ARCH} full width, {NUM_LAYERS} layers, batch {BATCH}, "
                  f"seq {SEQ}, parity, ckpt every {CKPT_INTERVAL}, sync "
                  f"inline saves by {SHARD_PARTICIPANTS} participants, the "
                  f"resume by {SHARD_RESUME_PARTICIPANTS}",
        "events": events, "launches": launches,
        "losses_failed_run": losses_failed,
        "losses_resumed": res["losses"], "loss_diffs_vs_3a_resumed": diffs,
        "restore_on_resume": res["restore_stats"],
        "runs_seconds": t_runs})
    _release(torch)
    log(f"3n runs in {t_runs:.1f} s: events {events}; resumed losses vs "
        f"3a {diffs}; launches {launches}")

    # (a) the shard sets of every event, and one block_fp per shard object
    ms = ManifestStore(run)
    mgr = CheckpointManager(run, registry,
                            make_policy("parity", model.layer_units()),
                            async_save=False)
    coord = ShardCoordinator(mgr)
    specs = model.param_specs()
    covers = {}
    for ev in events:
        m = ms.load(ev["step"])
        n_refs = 0
        for unit in m.saved_units:
            for kind, entry in m.entries[unit].items():
                if not is_sharded(entry):
                    raise AssertionError(f"3n (a): event {ev['step']} "
                                         f"saved {unit}/{kind} unsharded")
                coord._check_cover(unit, kind, entry, specs)
                n_refs += len(entry)
        covers[ev["step"]] = {
            "participants": m.meta["sharded"]["n_participants"],
            "shard_refs": n_refs}
    out["a"] = covers
    if [ev["step"] for ev in events] != [2, 4, STEPS] or \
            [ev["participants"] for ev in events] != [
                SHARD_PARTICIPANTS, SHARD_PARTICIPANTS,
                SHARD_RESUME_PARTICIPANTS]:
        raise AssertionError(f"3n (a): events {events}")
    for ev in events:
        c = covers[ev["step"]]
        if not (c["participants"] == ev["participants"]
                and c["shard_refs"] == ev["shard_objects"]
                == ev["block_fp_launches"] > 0):
            raise AssertionError(f"3n (a): event {ev['step']}: {ev}, "
                                 f"manifest {c}")
    _check_launched(launches, ("block_fp", "fused_adamw"), "phase 3n")

    # (b) the same Frankenstein from the same bytes
    if [s for s, _ in res["losses"]] != list(want) or \
            not all(d <= MODE_TOL for d in diffs.values()):
        raise AssertionError(f"3n (b): resumed losses off 3a's: {diffs}")

    # (c) step 4 of 3n's store against 3a's step-4 content addresses
    tc = time.perf_counter()
    full, full_stats = restored.pop("state"), restored.pop("stats")
    if full_stats["step"] != 4:
        raise AssertionError(f"3n: the resume restored {full_stats}")
    got4 = _unit_fp_digests(registry, full)
    want4 = rec_a["entry_digests"]["4"]
    out["c"] = {"equal_3a_step4": got4 == want4,
                "units_compared": len(got4),
                "seconds": time.perf_counter() - tc}
    if got4 != want4:
        raise AssertionError("3n (c): step 4 of 3n's store differs from "
                             "3a's: " + str(sorted(
                                 k for k in got4 if got4[k] != want4.get(k))))

    # (d) owned restores by 2 participants, stitched (one after the
    # other: two at once took 15.3 s against 7.6, PERF.md section 6)
    td = time.perf_counter()
    results, wanteds, owned = [], [], []
    for pid in range(SHARD_RESUME_PARTICIPANTS):
        wanted = participant_wanted(registry, pid,
                                    SHARD_RESUME_PARTICIPANTS)
        results.append(mgr.restore(like, device=dev, step=4, owned=wanted))
        wanteds.append(wanted)
        owned.append({k: mgr.last_restore_stats[k] for k in (
            "seconds", "bytes_read", "targets", "shards_skipped")})
    combined = combine_states(like, registry, results, wanteds)
    del results
    combined_equal = all(_params_equal(torch, full[p], combined[p])
                         for p in parts)
    del combined
    _release(torch)
    out["d"] = {"owned": owned, "full_bytes_read": full_stats["bytes_read"],
                "combined_equal_full": combined_equal,
                "seconds": time.perf_counter() - td}
    if not combined_equal or not all(
            0 < o["bytes_read"] < full_stats["bytes_read"]
            and o["shards_skipped"] > 0 for o in owned):
        raise AssertionError(f"3n (d): owned restores {out['d']}")

    # (e) the unchanged re-save, 4 participants
    n0 = bfp.KERNEL.launches
    ShardedCheckpointer(mgr, SHARD_PARTICIPANTS).save(
        full, step=4, units=registry.unit_names())
    resave = dict(mgr.last_save_stats)
    out["e"] = {k: resave[k] for k in ("d2h_bytes", "written_bytes",
                                       "dedup_hits", "shard_objects",
                                       "stall_seconds")} | {
        "block_fp_launches": bfp.KERNEL.launches - n0}
    mgr.close()
    del full
    _release(torch)
    if resave["d2h_bytes"] != 0 or resave["written_bytes"] != 0:
        raise AssertionError(f"3n (e): the unchanged re-save moved bytes: "
                             f"{out['e']}")
    REMOVER.discard(root)
    out["seconds"] = time.perf_counter() - t0
    out["within_budget"] = out["seconds"] <= SHARD_BUDGET_S
    log(f"phase 3n in {out['seconds']:.1f} s of its "
        f"{SHARD_BUDGET_S:.0f}-s budget: runs {t_runs:.1f}, (c) "
        f"{out['c']['seconds']:.1f}, (d) {out['d']['seconds']:.1f}; "
        f"(d) {out['d']}; (e) {out['e']}")


def sharded_summary(mp_n: dict) -> dict:
    """3n's line: per event its participants, shard objects, block_fp
    launches, stall and bytes; the resumed losses against 3a's; the
    resume's (full) and the owned restores of step 4; the re-save;
    seconds and budget."""
    return {
        "events": [{k: e[k] for k in (
            "step", "participants", "shard_objects", "block_fp_launches",
            "stall_seconds", "snapshot_seconds", "commit_seconds",
            "participant_d2h_seconds", "d2h_bytes", "written_bytes")}
            for e in mp_n["events"]],
        "loss_diffs_vs_3a_resumed": mp_n["loss_diffs_vs_3a_resumed"],
        "restore_on_resume": {k: mp_n["restore_on_resume"][k] for k in (
            "seconds", "bytes_read", "targets")},
        "owned_restores_step4": mp_n["d"]["owned"],
        "resave": mp_n["e"], "launches": mp_n["launches"],
        "seconds": mp_n["seconds"], "budget_seconds": SHARD_BUDGET_S}


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
    REMOVER.discard(ctl)
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


def _step2_state(torch, dev, num_layers: int = NUM_LAYERS):
    """(model, registry, state) of ``train`` after its first two steps in
    3f's configuration (at ``num_layers``): the same model, schedule,
    registry, data and seed, so its units fingerprint to event 2's
    digests."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.layer_registry import LayerRegistry
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.launch import steps

    model = _model(num_layers=num_layers)
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


def _check_cpu_path_objects(torch, dev, run: Path, scratch: Path,
                            fingerprint: bool = True,
                            num_layers: int = NUM_LAYERS) -> dict:
    """3f (a), and 3h (e) with ``fingerprint=False``: event 2's block_000
    objects (weights, opt) of an int8 store (of a model at ``num_layers``)
    equal, byte for byte, those the port's CPU path (plain quantize, plain
    fingerprints) writes on the same save path from the same unit copied
    to the host."""
    from repro_torch.checkpoint.saver import CheckpointManager
    from repro_torch.core.manifest import ManifestStore
    from repro_torch.core.policies import make_policy

    what = "3f (a)" if fingerprint else "3h (e)"
    model, registry, state = _step2_state(torch, dev, num_layers)
    event2 = ManifestStore(run).load(2).entries["block_000"]
    cpu = CheckpointManager(scratch, registry,
                            make_policy("parity", model.layer_units()),
                            async_save=False, codec="int8",
                            fingerprint=fingerprint)
    out = {}
    for kind in ("weights", "opt"):
        tree = (registry.extract_unit(state["params"], "block_000")
                if kind == "weights" else
                registry.extract_opt_unit(state["opt"], "block_000"))
        host = _to_cpu(tree)
        acc = {"d2h_bytes": 0, "blocks_moved": 0, "blocks_total": 0,
               "fingerprint_seconds": 0.0, "d2h_seconds": 0.0,
               "write_seconds": 0.0}
        if fingerprint:
            ref, _ = cpu._save_unit_fp(2, "block_000", kind, host, None, acc)
        else:
            ref = cpu._save_unit_canonical(2, "block_000", kind, host, None,
                                           acc)
        want = event2[kind]
        if ref.digest != want.digest:
            raise AssertionError(f"{what}: the replayed step-2 block_000 "
                                 f"{kind} is not event 2's content")
        got = cpu.store.object_path(ref.digest).read_bytes()
        if got != (run / want.relpath).read_bytes():
            raise AssertionError(f"{what}: event 2's block_000 {kind} "
                                 "object differs from the CPU path's")
        out[kind] = {"object_bytes": len(got),
                     "cpu_path_d2h_bytes": acc["d2h_bytes"]}
        del host
    cpu.close()
    REMOVER.discard(scratch)
    del state
    _release(torch)
    log(f"{what}: event 2's block_000 objects equal the CPU path's: {out}")
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


def _ssm_train_cfg():
    """Phase 3e's training configuration: Mamba2-370m at full width and
    SSM_TRAIN_LAYERS layers."""
    from repro_torch.configs import get_config

    return get_config(SSM_ARCH, reduced=REDUCED).replace(
        num_layers=SSM_TRAIN_LAYERS)


def phase_3e_train(torch, dev, store: Path, out: dict) -> None:
    """Mamba2-370m at full width and SSM_TRAIN_LAYERS (4) of its 48
    layers, batch SSM_BATCH x SSM_SEQ: an uninterrupted reference run of SSM_STEPS steps without
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
    from repro_torch.launch.train import SimulatedFailure, train
    from repro_torch.models import build_model

    kw = dict(arch=SSM_ARCH, reduced=REDUCED, num_layers=SSM_TRAIN_LAYERS,
              batch=SSM_BATCH,
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
        REMOVER.discard(root)
        _release(torch)
        return events, sigs, res

    _release(torch)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    ref = train(ckpt_dir=str(store / "ref"), **{**kw, **no_saves})
    peak_ref = torch.cuda.max_memory_allocated(dev)
    REMOVER.discard(store / "ref")
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
    cfg = _ssm_train_cfg()
    ref_loss = dict(ref["losses"])
    out.update({
        "config": f"{SSM_ARCH} full width, {cfg.num_layers} layers, batch "
                  f"{SSM_BATCH}, seq {SSM_SEQ}, topk_delta, "
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
                     decode_tol, new_tokens: int = SERVE_NEW,
                     num_layers=None) -> None:
    """A published model at full width and depth (``num_layers`` cuts
    it) on random bf16 weights through ``repro_torch.launch.serve.serve``:
    batch 8, 1024-token prompts, ``new_tokens`` greedy tokens.  Each
    kernel must launch as often as ``want`` says; then (unless
    ``decode_tol`` is None: the caller checks) one decode step against the
    prefilled cache must give the logits of prefilling the longer prompt
    within ``decode_tol``, all finite."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model
    from repro_torch.optim import tree_leaves

    cfg = get_config(arch, reduced=REDUCED)
    if num_layers is not None:
        cfg = cfg.replace(num_layers=num_layers)
    _release(torch)
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    _zero_counts()
    t0 = time.perf_counter()
    res = serve(arch=arch, reduced=REDUCED, batch=SERVE_BATCH,
                prompt_len=SERVE_PROMPT, new_tokens=new_tokens, seed=SEED,
                device=str(dev), num_layers=num_layers)
    torch.cuda.synchronize()
    launches = _read_counts()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    n_params = sum(math.prod(s.shape) for s in tree_leaves(
        build_model(cfg).param_specs()))
    out.update({
        "config": f"{arch} full width, {cfg.num_layers} layers "
                  f"({n_params} params, random bf16), batch {SERVE_BATCH}, "
                  f"prompt {SERVE_PROMPT}, {new_tokens} new tokens",
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
    if decode_tol is not None:
        out["decode_vs_prefill"], out["decode_profile"] = _decode_checks(
            torch, dev, cfg, res["decode_seconds"] / new_tokens, decode_tol)


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


def _decode_gap_float32(torch, dev, cfg, num_layers=None) -> float:
    """The decode-vs-prefill comparison of ``_decode_checks`` with the
    model computing in float32 (float32 weights and activations, the
    kernels' float32 routes, a float32 conv window), which takes bf16
    rounding out of it: a decode step that does not continue the
    prefill's state and conv window shows here, rounding does not.  Held
    to DECODE_F32_TOL.  ``num_layers`` cuts the depth (a full-depth
    float32 model that does not fit the card)."""
    import numpy as np

    from repro_torch.models import build_model

    if num_layers is not None:
        cfg = cfg.replace(num_layers=num_layers)
    model = build_model(cfg, compute_dtype=torch.float32)
    params = model.init(SEED, dev)
    rng = np.random.RandomState(SEED)
    toks = torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT + 1)).astype(
            np.int32)).to(dev)
    _, cache = model.prefill(params, {"tokens": toks[:, :-1]},
                             cache_len=SERVE_PROMPT + 1)
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
    # device activity alone: at full depth the host's events took 7.8 s
    # of processing for 4 steps, the device's 2.2 s, for the same busy
    # time (Yi-9B on an H100: scripts/trace_cost.py; PERF.md, section 6)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    """Device time of one Mamba2-370m train step (phase 3e's training
    shape, SSM_TRAIN_LAYERS layers, a fresh state, after one warm step) traced by torch.profiler: every
    kernel, copy and fill on the card, summed; the number of device events
    and of host kernel launches; the busy share of ``step_seconds``, the
    reference run's unprofiled median step.  None where the profiler shows
    no device events."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import steps
    from repro_torch.models import build_model

    model = build_model(_ssm_train_cfg())
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
    # the device's activity alone (its runtime API records hold the launch
    # calls): the host's events cost seconds of the trace's processing
    # (scripts/trace_cost.py)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    """Mamba2-370m at full width: train, save, fail and resume
    (``phase_3e_train``) and serve from that store (weights-only cold load,
    hot-swap to LATEST, hot vs cold tokens) before it is removed, at
    SSM_TRAIN_LAYERS layers; then serve on random weights at
    SSM_SERVE_LAYERS (24) of its 48 layers: ``ssd_scan`` once per layer in
    the prefill
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
                   out["store"], model=build_model(_ssm_train_cfg()),
                   serve_kw=dict(arch=SSM_ARCH, reduced=REDUCED,
                                 num_layers=SSM_TRAIN_LAYERS), drift=False)
    REMOVER.discard(store)
    cfg = cfg.replace(num_layers=SSM_SERVE_LAYERS)
    serve_full_depth(torch, dev, out["serve"], SSM_ARCH,
                     {"flash_attention": 0, "ssd_scan": cfg.num_layers},
                     DECODE_SSM_TOL, num_layers=cfg.num_layers)
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


# ---------------------------------------------------------------- phase 3o
HYBRID_BUDGET_S = 60.0
HYBRID_TRAIN_LAYERS = 6   # one group of shared_period: the least depth
HYBRID_STEPS = 6
HYBRID_NEW = 8            # new tokens of the serve (decode is host-bound)


def phase_3o(torch, dev, store: Path, out: dict) -> None:
    """The hybrid family (Zamba2-2.7B) at full width.  Budget: 60 s.
    Fills ``out`` before its checks.

    (a) Training at HYBRID_TRAIN_LAYERS (6) layers, one group (six Mamba2
    layers and the shared block), batch BATCH x SEQ, the ``full`` policy:
    an uninterrupted reference of HYBRID_STEPS steps; a run with
    synchronous saves every CKPT_INTERVAL steps that fails at FAIL_AT, and
    its resume from the step-4 manifest (no further saves), whose losses
    equal the reference's within MODE_TOL.  Step 2's manifest names
    ``shared_attn`` with its weights and its optimizer object; ``block_fp``
    launches once per saved (unit, kind) in the failing run; ``fused_adamw``
    as often on every step of each run.
    (b) Serving at HYBRID_SERVE_LAYERS (18) of its 54 layers on random
    bf16 weights through ``serve_full_depth``, HYBRID_NEW new tokens:
    ``ssd_scan`` once per Mamba2 layer in the prefill,
    ``flash_attention`` once per shared invocation (3) in the prefill and
    in every decode step; decode vs
    prefill of the longer prompt within DECODE_HYBRID_TOL in bf16 and
    DECODE_F32_TOL in float32 (the kernels' float32 routes, D 80)."""
    from repro_torch.configs import get_config
    from repro_torch.core.manifest import ManifestStore
    from repro_torch.launch.train import SimulatedFailure, train

    t0 = time.perf_counter()
    cfg = get_config(HYBRID_ARCH, reduced=REDUCED)
    kw = dict(arch=HYBRID_ARCH, reduced=REDUCED,
              num_layers=HYBRID_TRAIN_LAYERS, batch=BATCH, seq_len=SEQ,
              policy_name="full", seed=SEED, device=str(dev),
              ckpt_async=False, total_steps=HYBRID_STEPS)
    no_saves = {"ckpt_interval": HYBRID_STEPS + 1}
    run = store / "run"
    tr = out["train"]
    launches = tr["launches"] = {}
    _release(torch)
    _zero_counts()
    ref = train(ckpt_dir=str(store / "ref"), **kw, **no_saves)
    torch.cuda.synchronize()
    launches["ref"] = _read_counts()
    REMOVER.discard(store / "ref")
    _release(torch)
    _zero_counts()
    try:
        # the objects on CANON_WRITER_THREADS writer threads (the events
        # stay synchronous: the commit drains them)
        train(ckpt_dir=str(run), ckpt_interval=CKPT_INTERVAL,
              fail_at=FAIL_AT, **{**kw, "ckpt_async": True,
                                  "writer_threads": CANON_WRITER_THREADS})
        raise AssertionError("3o: the checkpointed run did not fail")
    except SimulatedFailure as e:
        failed = e
    torch.cuda.synchronize()
    launches["failed"] = _read_counts()
    events = failed.save_events
    m2 = ManifestStore(run).load(CKPT_INTERVAL)
    shared2 = sorted(m2.entries.get("shared_attn", {}))
    _release(torch)
    _zero_counts()
    res = train(ckpt_dir=str(run), resume=True, **kw, **no_saves)
    torch.cuda.synchronize()
    launches["resumed"] = _read_counts()
    REMOVER.discard(store)
    saved = sum(2 * e["selected_units"] for e in events)
    tr.update({
        "config": f"{HYBRID_ARCH} full width, {HYBRID_TRAIN_LAYERS} layers "
                  f"(one group), batch {BATCH}, seq {SEQ}, full, ckpt "
                  f"every {CKPT_INTERVAL}, sync saves",
        "step_seconds_median": statistics.median(ref["step_seconds"][1:]),
        "step_seconds_ref": ref["step_seconds"],
        "losses_ref": ref["losses"], "losses_failed_run": failed.losses,
        "losses_resumed": res["losses"],
        "save_events": [{k: e.get(k) for k in _EVENT_KEYS} for e in events],
        "saved_unit_kinds": saved,
        "step2_shared_attn": shared2,
        "restore_on_resume": res["restore_stats"],
        "peak_device_bytes": {"reference_run": ref["peak_device_bytes"],
                              "resumed_run": res["peak_device_bytes"]},
        "seconds": time.perf_counter() - t0})
    log(f"3o (a) in {tr['seconds']:.1f} s: events "
        f"{[(e['step'], round(e['stall_seconds'], 3)) for e in events]}, "
        f"restore {res['restore_stats']['seconds']:.2f} s; launches "
        f"{launches}")
    del failed
    tr["loss_diffs"] = _check_losses(ref, res, lambda s: MODE_TOL,
                                     "phase 3o (a): the full resume")
    if [e["step"] for e in events] != [2, 4] \
            or res["restore_stats"]["step"] != 4:
        raise AssertionError(f"3o (a): events {[e['step'] for e in events]}"
                             f", resumed from {res['restore_stats']['step']}")
    if shared2 != ["opt", "weights"]:
        raise AssertionError(f"3o (a): step 2's manifest holds shared_attn "
                             f"as {shared2}")
    if launches["failed"]["block_fp"] != saved:
        raise AssertionError(f"3o (a): block_fp launched "
                             f"{launches['failed']['block_fp']} times for "
                             f"{saved} saved (unit, kind)")
    per_step = launches["ref"]["fused_adamw"] / HYBRID_STEPS
    resumed_steps = len(res["losses"])
    if not (per_step >= 1 and per_step == int(per_step)
            and launches["resumed"]["fused_adamw"]
            == per_step * resumed_steps):
        raise AssertionError(f"3o (a): fused_adamw not launched alike on "
                             f"every step: {launches}")
    _release(torch)

    # (b) serving at HYBRID_SERVE_LAYERS
    ts = time.perf_counter()
    cfg = cfg.replace(num_layers=HYBRID_SERVE_LAYERS)
    groups = cfg.num_layers // cfg.hybrid.shared_period
    serve_full_depth(torch, dev, out["serve"], HYBRID_ARCH,
                     {"ssd_scan": cfg.num_layers,
                      "flash_attention": groups * (1 + HYBRID_NEW)},
                     DECODE_HYBRID_TOL, new_tokens=HYBRID_NEW,
                     num_layers=cfg.num_layers)
    out["serve"]["decode_vs_prefill_float32"] = _decode_gap_float32(
        torch, dev, cfg)
    out["serve"]["seconds_with_checks"] = time.perf_counter() - ts
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 3o in {out['seconds']:.1f} s of its "
        f"{HYBRID_BUDGET_S:.0f}-s budget")


MOE_BUDGET_S = 75.0
MOE_TRAIN_LAYERS = 2      # block_000 (the first, dense layer) and block_001
                          # (MoE): the least depth holding both block kinds
MOE_STEPS = 6
MOE_NEW = 8               # new tokens of the serve (decode is host-bound)
MOE_PARTICIPANTS = 4      # a MoE block's optimizer object is 7.02 GB,
                          # past msgpack's bin (ROADMAP C1): 4 x 1.75 GB
MOE_F32_LAYERS = 4        # the float32 decode check (63 GB at full depth)
MSGPACK_BIN_MAX = 2 ** 32 - 1
# A decode step's first expert choice that differs from the longer
# prefill's must be a near tie: its k-th and (k + 1)-th probabilities
# within this (H100: 0 to 0.0019 over the 8 rows, PERF.md section 6;
# bf16 rounding moves a probability by ~1e-4 here)
MOE_FLIP_GAP = 0.01


def _route_flips(torch, dec, pre, k: int) -> list:
    """Per row of a batch: the first MoE layer where the decode step's
    experts for its token differ from the longer prefill's for its last
    position, and the decode's probability gap between its k-th and
    (k+1)-th expert there (None: the same experts in every layer)."""
    rows = []
    for r in range(dec[0][1].shape[0]):
        first = None
        for layer, ((dp, di), (_, pi)) in enumerate(zip(dec, pre)):
            if not torch.equal(di[r].sort().values, pi[r].sort().values):
                top = dp[r].sort(descending=True).values
                first = {"layer": layer,
                         "gap": (top[k - 1] - top[k]).item()}
                break
        rows.append(first)
    return rows


def _moe_decode_gaps(torch, dev, cfg, step_seconds: float) -> dict:
    """One decode step against the prefilled cache vs the prefill of the
    longer prompt at full depth in bf16, on one set of weights and tokens,
    under two capacity factors: a copy of the config with num_experts /
    top_k, where no token can be dropped, held to DECODE_MOE_TOL; and the
    published one, recorded unchecked (the prompt's last token takes the
    last capacity slots of the longer prefill, so it is the first dropped
    there, while a decode step runs every expert).  The device's busy
    time over PROFILE_STEPS more decode steps of the no-drop model."""
    import dataclasses

    import numpy as np

    from repro_torch.models import build_model

    from repro_torch.models import moe as moe_mod

    m = cfg.moe
    nodrop = cfg.replace(moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))
    plain_route = moe_mod.route
    choices = []

    def route(logits, k):
        got = plain_route(logits, k)
        choices.append((got[0][..., -1, :] if got[0].dim() == 3
                        else got[0], got[2][..., -1, :]
                        if got[2].dim() == 3 else got[2]))
        return got
    params = build_model(cfg).init(SEED, dev, dtype=torch.bfloat16)
    rng = np.random.RandomState(SEED)
    toks = torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT + 1)).astype(
            np.int32)).to(dev)
    out = {}
    for label, c in (("nodrop", nodrop), ("published", cfg)):
        model = build_model(c)
        _, cache = model.prefill(params, {"tokens": toks[:, :-1]},
                                 cache_len=SERVE_PROMPT + 1 + PROFILE_STEPS)
        choices.clear()
        moe_mod.route = route
        try:
            ld, _ = model.decode_step(params, cache, {
                "tokens": toks[:, -1:], "pos": SERVE_PROMPT})
            n_dec = len(choices)
            if label == "nodrop":
                moe_mod.route = plain_route
                out["decode_profile"] = _decode_profile(
                    torch, model, params, cache, toks[:, -1:], step_seconds)
            del cache
            moe_mod.route = route
            lf, _ = model.prefill(params, {"tokens": toks})
        finally:
            moe_mod.route = plain_route
        if not (torch.isfinite(ld).all() and torch.isfinite(lf).all()):
            raise AssertionError(f"3p: non-finite logits ({label})")
        out[label] = {"capacity_factor": c.moe.capacity_factor,
                      "gap": (ld - lf).abs().max().item(),
                      "gap_by_row": (ld - lf).abs().amax(-1).tolist(),
                      "route_flips": _route_flips(
                          torch, choices[:n_dec], choices[n_dec:], m.top_k)}
    del params
    torch.cuda.empty_cache()
    log(f"3p decode vs prefill of the longer prompt in bf16: {out}")
    if not out["nodrop"]["gap"] < DECODE_MOE_TOL:
        raise AssertionError(f"3p (c): decode step off the prefill of T + 1 "
                             f"tokens at the no-drop factor: {out}")
    flips = [f for f in out["nodrop"]["route_flips"] if f is not None]
    if not all(f["gap"] < MOE_FLIP_GAP for f in flips):
        raise AssertionError(f"3p (c): a decode step chose other experts "
                             f"than the prefill where no near tie explains "
                             f"it: {flips}")
    out["float32_nodrop"] = _decode_gap_float32(torch, dev, nodrop,
                                                MOE_F32_LAYERS)
    return out


def phase_3p(torch, dev, store: Path, out: dict) -> None:
    """DeepSeek-V2-Lite at full width: MoE (64 routed experts, top 6, 2
    shared) with MLA, its first layer dense (ROADMAP A5).  Budget:
    MOE_BUDGET_S.  Fills ``out`` before its checks.

    (a) Training at MOE_TRAIN_LAYERS (2) layers, ``block_000`` (the dense
    first layer, an unstacked unit) and ``block_001`` (MoE), batch BATCH x
    SEQ, the ``full`` policy: an uninterrupted reference of MOE_STEPS
    steps; a run with synchronous saves every CKPT_INTERVAL steps through
    MOE_PARTICIPANTS virtual participants that fails at FAIL_AT; its
    resume from the step-4 manifest (no further saves), whose losses
    equal the reference's within MODE_TOL.  Step 2's manifest holds both
    block units' weights and optimizer objects as shard sets; every object
    of the store is under msgpack's 2**32 - 1-byte bin (the largest
    recorded); ``block_fp`` launches once per shard object of each event;
    ``fused_adamw`` as often on every step of each run; the aux loss of
    every reference step finite and positive.
    (b) Serving at all 27 layers on random bf16 weights through
    ``serve_full_depth``, batch 8 x 1024 + MOE_NEW tokens at the
    published capacity factor: ``flash_attention`` exactly once per layer
    in the prefill (the latent-expanded MLA, Dqk 192 / Dv 128) and in
    every decode step (the absorbed MLA, 576 / 512).
    (c) ``_moe_decode_gaps``: decode vs the prefill of the longer prompt
    at 27 layers in bf16 within DECODE_MOE_TOL at the no-drop factor (the
    published one recorded), and in float32 at MOE_F32_LAYERS within
    DECODE_F32_TOL."""
    from repro_torch.configs import get_config
    from repro_torch.core.manifest import ManifestStore, is_sharded
    from repro_torch.launch.train import SimulatedFailure, train

    t0 = time.perf_counter()
    log(f"phase 3p: budget {MOE_BUDGET_S:.0f} s")
    cfg = get_config(MOE_ARCH, reduced=REDUCED)
    kw = dict(arch=MOE_ARCH, reduced=REDUCED, num_layers=MOE_TRAIN_LAYERS,
              batch=BATCH, seq_len=SEQ, policy_name="full", seed=SEED,
              device=str(dev), ckpt_async=False, total_steps=MOE_STEPS)
    no_saves = {"ckpt_interval": MOE_STEPS + 1}
    run = store / "run"
    tr = out["train"]
    launches = tr["launches"] = {}
    _release(torch)
    _zero_counts()
    ref = train(ckpt_dir=str(store / "ref"), **kw, **no_saves)
    torch.cuda.synchronize()
    launches["ref"] = _read_counts()
    REMOVER.discard(store / "ref")
    _release(torch)
    _zero_counts()
    events = []
    with _sharded_events(events):
        try:
            train(ckpt_dir=str(run), ckpt_interval=CKPT_INTERVAL,
                  fail_at=FAIL_AT, shard_participants=MOE_PARTICIPANTS, **kw)
            raise AssertionError("3p: the checkpointed run did not fail")
        except SimulatedFailure as e:
            losses_failed = list(e.losses)
    torch.cuda.synchronize()
    launches["failed"] = _read_counts()
    m2 = ManifestStore(run).load(CKPT_INTERVAL)
    step2 = {u: {k: (is_sharded(e), len(e) if is_sharded(e) else 1)
                 for k, e in sorted(m2.entries.get(u, {}).items())}
             for u in ("block_000", "block_001")}
    objects = [f.stat().st_size for f in run.rglob("*.chunk")]
    _release(torch)
    _zero_counts()
    res = train(ckpt_dir=str(run), resume=True, **kw, **no_saves)
    torch.cuda.synchronize()
    launches["resumed"] = _read_counts()
    REMOVER.discard(store)
    tr.update({
        "config": f"{MOE_ARCH} full width, {MOE_TRAIN_LAYERS} layers "
                  f"(block_000 dense, block_001 MoE), batch {BATCH}, seq "
                  f"{SEQ}, full, ckpt every {CKPT_INTERVAL}, sync saves by "
                  f"{MOE_PARTICIPANTS} participants",
        "step_seconds_median": statistics.median(ref["step_seconds"][1:]),
        "step_seconds_ref": ref["step_seconds"],
        "losses_ref": ref["losses"], "aux_losses_ref": ref["aux_losses"],
        "losses_failed_run": losses_failed,
        "losses_resumed": res["losses"], "events": events,
        "step2_blocks": step2, "objects": len(objects),
        "largest_object_bytes": max(objects, default=0),
        "restore_on_resume": res["restore_stats"],
        "peak_device_bytes": {"reference_run": ref["peak_device_bytes"],
                              "resumed_run": res["peak_device_bytes"]},
        "seconds": time.perf_counter() - t0})
    log(f"3p (a) in {tr['seconds']:.1f} s: events "
        f"{[(e['step'], e['shard_objects'], round(e['stall_seconds'], 3)) for e in events]}, "  # noqa: E501
        f"largest object {tr['largest_object_bytes']} B, restore "
        f"{res['restore_stats']['seconds']:.2f} s; aux "
        f"{ref['aux_losses']}; launches {launches}")
    tr["loss_diffs"] = _check_losses(ref, res, lambda s: MODE_TOL,
                                     "phase 3p (a): the full resume")
    if [e["step"] for e in events] != [2, 4] \
            or res["restore_stats"]["step"] != 4:
        raise AssertionError(f"3p (a): events {[e['step'] for e in events]}"
                             f", resumed from {res['restore_stats']['step']}")
    if step2 != {u: {"opt": (True, MOE_PARTICIPANTS),
                     "weights": (True, MOE_PARTICIPANTS)}
                 for u in ("block_000", "block_001")}:
        raise AssertionError(f"3p (a): step 2 holds the blocks as {step2}")
    if not objects or max(objects) >= MSGPACK_BIN_MAX:
        raise AssertionError(f"3p (a): an object of {max(objects)} B")
    if not all(e["shard_objects"] == e["block_fp_launches"] > 0
               for e in events) or launches["failed"]["block_fp"] != sum(
                   e["block_fp_launches"] for e in events):
        raise AssertionError(f"3p (a): block_fp launches {events}, "
                             f"{launches['failed']}")
    per_step = launches["ref"]["fused_adamw"] / MOE_STEPS
    if not (per_step >= 1 and per_step == int(per_step)
            and launches["resumed"]["fused_adamw"]
            == per_step * len(res["losses"])
            and launches["failed"]["fused_adamw"]
            == per_step * len(losses_failed)):
        raise AssertionError(f"3p (a): fused_adamw not launched alike on "
                             f"every step: {launches}")
    if not all(math.isfinite(a) and a > 0 for _, a in ref["aux_losses"]):
        raise AssertionError(f"3p (a): aux losses {ref['aux_losses']}")
    _release(torch)

    # (b) serving at full depth
    ts = time.perf_counter()
    serve_full_depth(torch, dev, out["serve"], MOE_ARCH,
                     {"flash_attention": cfg.num_layers * (1 + MOE_NEW),
                      "ssd_scan": 0}, None, new_tokens=MOE_NEW)
    out["serve"]["seconds_with_checks"] = time.perf_counter() - ts

    # (c) decode vs prefill
    tc = time.perf_counter()
    out["decode"] = _moe_decode_gaps(
        torch, dev, cfg, out["serve"]["decode_seconds"] / MOE_NEW)
    out["decode"]["seconds"] = time.perf_counter() - tc
    out["seconds"] = time.perf_counter() - t0
    out["within_budget"] = out["seconds"] <= MOE_BUDGET_S
    log(f"phase 3p in {out['seconds']:.1f} s of its "
        f"{MOE_BUDGET_S:.0f}-s budget")


def moe_summary(mp_p: dict, card: dict) -> dict:
    """3p's line."""
    pt, ps, pd = mp_p["train"], mp_p["serve"], mp_p["decode"]
    return {
        "seconds": mp_p["seconds"], "budget_seconds": MOE_BUDGET_S,
        "train": {k: pt[k] for k in (
            "config", "step_seconds_median", "loss_diffs", "aux_losses_ref",
            "launches", "step2_blocks", "objects", "largest_object_bytes",
            "peak_device_bytes")}
        | {"events": [{k: e[k] for k in (
            "step", "participants", "shard_objects", "block_fp_launches",
            "stall_seconds", "d2h_bytes", "written_bytes")}
            for e in pt["events"]],
           "restore_seconds": pt["restore_on_resume"]["seconds"]},
        "serve": {k: ps[k] for k in (
            "config", "prefill_seconds", "decode_tokens_per_s",
            "peak_device_bytes", "launches")},
        "decode_vs_prefill": {k: pd[k] for k in (
            "nodrop", "published", "float32_nodrop")}
        | {"tol": DECODE_MOE_TOL, "profile": pd["decode_profile"]}} | card


def write_record(record: dict, path) -> None:
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(record, indent=1))


def supervisor_summary(mp_m: dict) -> dict:
    """3m's line: per interruption its losses and MTTR with MTTR's parts
    (the scrub and the probe here, then the next attempt's start: its
    interpreter and imports, the card's context, the model, the restore),
    per attempt its steps and seconds, both goodputs and the phase's
    seconds against its budget."""
    rep = mp_m["report"]
    attempts = rep["attempts"]
    inter = []
    for i in rep["interruptions"]:
        nxt = attempts[i["attempt"] + 1]
        inter.append({
            **{k: i[k] for k in ("kind", "exit_code", "reached_step",
                                 "committed_step", "lost_steps",
                                 "lost_seconds", "mttr_seconds")},
            "mttr_parts": {
                "scrub_seconds": i["scrub"]["seconds"],
                "probe_seconds": i["restore_probe"]["seconds"],
                "launch_to_first_progress": nxt["launch_to_first_progress"],
                "next_startup": nxt["startup"]}})
    return {
        "interruptions": inter,
        "attempts": [{k: a[k] for k in ("exit_code", "steps_executed",
                                        "reached_step", "seconds")}
                     | {k: (a["result"] or {}).get(k) for k in (
                         "peak_device_bytes", "kernels_compiled",
                         "exit_seconds")}
                     | {"first_step_seconds": ((a["result"] or {}).get(
                         "step_seconds") or [None])[0]}
                     for a in attempts],
        "goodput_steps": rep["goodput_steps"],
        "goodput_wall": rep["goodput_wall"],
        "scrubs": mp_m["scrubs"], "final_probe": mp_m["final_probe"],
        "loss_diffs_vs_3a_reference": mp_m["loss_diffs_vs_3a_reference"],
        "launches": mp_m["launches"], "seconds": mp_m["seconds"],
        "within_budget": mp_m["within_budget"],
        "budget_seconds": SUPERVISOR_BUDGET_S}


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
        # the merge path (3g); its CLI's block_fp launches are the child's
        k["launches_merge_path"] = mp["3g"]["launches"][k["name"]] + (
            mp["3g"]["a"]["merge_block_fp_launches"]
            if k["name"] == "block_fp" else 0)
        # the canonical path (3h), summed over its parts (its merge runs
        # in this process)
        k["launches_canonical_path"] = sum(
            c[k["name"]] for c in mp["3h"]["launches"].values())
        # the storage tiers (3i), by part
        k["launches_tiers_path"] = {
            part: c[k["name"]] for part, c in mp["3i"]["launches"].items()}
        # the streaming restore and the process IO workers (3j), by part
        # ((a) by restore arm)
        la = mp["3j"]["launches"]
        k["launches_io_path"] = {
            "a": {arm: c[k["name"]] for arm, c in la["a"].items()},
            "b": la["b"][k["name"]], "c": la["c"][k["name"]]}
        # the block cache (3k), by arm
        k["launches_cache_path"] = {
            arm: c[k["name"]] for arm, c in mp["3k"]["launches"].items()}
        # the scrub (3l), by part
        k["launches_scrub_path"] = {
            part: c[k["name"]] for part, c in mp["3l"]["launches"].items()}
        # the supervised drill (3m): the scrubs and probes in this process,
        # and each child that reported its counts (a killed one cannot)
        k["launches_supervisor_path"] = {
            "supervisor": mp["3m"]["launches"][k["name"]],
            "children": {a: (c or {}).get(k["name"]) for a, c in
                         mp["3m"]["child_launches"].items()}}
        # the sharded saves (3n): its two runs
        k["launches_sharded_path"] = mp["3n"]["launches"][k["name"]]
        # the hybrid (3o): its three training runs and its serve
        k["launches_hybrid_path"] = {
            **{run: c[k["name"]] for run, c in
               mp["3o"]["train"]["launches"].items()},
            "serve": mp["3o"]["serve"]["launches"][k["name"]]}
        # the MoE with MLA (3p): its three training runs and its serve
        k["launches_moe_path"] = {
            **{run: c[k["name"]] for run, c in
               mp["3p"]["train"]["launches"].items()},
            "serve": mp["3p"]["serve"]["launches"][k["name"]]}
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
        "3i": {"seconds": mp["3i"]["seconds"],
               "a_events": mp["3i"]["a"]["events"],
               "a_loss_diffs": mp["3i"]["a"]["loss_diffs"],
               "b_outage_event_storage":
                   mp["3i"]["b"]["outage_event_storage"],
               "b_loss_diffs": mp["3i"]["b"]["loss_diffs"],
               "c_tokens_digest": mp["3i"]["c"]["tokens_digest"],
               "d_unit_equal": mp["3i"]["d"]["unit_equal"]},
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
    mp_g = mp["3g"]
    print(json.dumps({"merge": {
        "a_implicit_step4": {k: mp_g["a"][k] for k in (
            "merge", "merge_block_fp_launches", "objects",
            "losses_vs_3a_resumed", "seconds")}
        | {"resume_restore_seconds": mp_g["a"]["resume_restore"]["seconds"]},
        "b_frankenstein": {k: mp_g["b"][k] for k in (
            "merge", "merge_block_fp_launches", "tokens_digest",
            "variant_set", "seconds")},
        "c_corruption": mp_g["c"], "launches": mp_g["launches"],
        "seconds": mp_g["seconds"]} | card}))
    mp_h = mp["3h"]
    print(json.dumps({"legacy": {
        "c_fp_to_canonical": {k: mp_h["c"][k] for k in (
            "loss_diffs_vs_3a_reference", "event", "event8_xd01",
            "event8_xd01_over_fp_bases",
            "launches_when_the_resume_restore_ended", "swap_6_to_8", "tokens_digest", "seconds")},
        "a_canonical_run": {k: mp_h["a"][k] for k in (
            "loss_diffs_vs_3a_resumed", "events", "writes", "events_3a",
            "writes_3a", "event4_xd01", "step4_equal_3a", "seconds")}
        | {"restore_seconds": mp_h["a"]["restore_on_resume"]["seconds"]},
        "b_resave": mp_h["b"], "d_merge": mp_h["d"],
        "e_int8": {k: mp_h["e"][k] for k in (
            "event", "restored_vs_records", "cpu_path_objects", "seconds")}
        | {"restore_seconds": mp_h["e"]["restore"]["seconds"]},
        "launches": mp_h["launches"], "seconds": mp_h["seconds"]} | card}))
    mp_i = mp["3i"]
    print(json.dumps({"tiers": {
        "a_tiered": {k: mp_i["a"][k] for k in (
            "events", "spill_drain_seconds", "tier_stats", "restore",
            "host_peak_rss_bytes", "loss_diffs", "objects_named",
            "seconds")},
        "b_remote3": {k: mp_i["b"][k] for k in (
            "outage_event_storage", "events", "spill_drain_seconds",
            "disk_objects", "bucket_objects", "lost_disk_copy",
            "lost_read_from", "rewarmed_on_disk", "restore",
            "resume_spill_drain_seconds", "remote_counters", "loss_diffs",
            "seconds")},
        "c_serve": {k: mp_i["c"][k] for k in (
            "reads", "params_equal", "tokens_digest", "seconds")},
        "d_merge": {k: mp_i["d"][k] for k in (
            "merge", "storage", "unit_equal", "seconds")},
        "launches": mp_i["launches"], "seconds": mp_i["seconds"]} | card}))
    mp_j = mp["3j"]
    print(json.dumps({"io": {
        "a_restores": {name: {k: arm[k] for k in (
            "seconds", "read_seconds", "wait_seconds", "read_io_seconds",
            "decode_seconds", "h2d_seconds", "verify_seconds",
            "objects_read", "planned_object_reads", "bytes_read",
            "block_fp_launches", "workers", "host_peak_rss_bytes",
            "workers_rss_bytes_at_end")}
            for name, arm in mp_j["a"]["arms"].items()},
        "b_process_events": mp_j["b"]["events"],
        "b_digests_equal": mp_j["b"]["digests_equal"],
        "b_objects_named": mp_j["b"]["objects_named"],
        "c_load": mp_j["c"]["load"],
        "c_params_equal": mp_j["c"]["params_equal"],
        "launches": mp_j["launches"], "seconds": mp_j["seconds"],
        "budget_seconds": IO_BUDGET_S} | card}))
    mp_k = mp["3k"]
    print(json.dumps({"cache": {
        **{k: mp_k[k] for k in ("variants", "units", "distinct_digests",
                                "distinct_bytes",
                                "reads_summed_over_variants")},
        "a": {arm: {k: mp_k["a"][arm][k] for k in (
            "seconds", "backend_reads", "cache", "host_peak_rss_bytes",
            "block_fp_launches", "loads")}
            for arm in ("cached", "uncached")}
        | {"params_equal": mp_k["a"]["params_equal"]},
        "b_shm": {k: mp_k["b"][k] for k in (
            "seconds", "backend_reads", "cache", "params_equal",
            "segments_before_close", "segments_after_close")},
        "c": {label: {k: mp_k["c"][label][k] for k in (
            "budget_bytes", "backend_reads", "cache", "params_equal")}
            for label in ("below_one_object", "below_working_set")},
        "d_process": {k: mp_k["d"][k] for k in (
            "seconds", "backend_reads", "cache", "params_equal",
            "worker_restarts")},
        "e_serve": mp_k["e"], "launches": mp_k["launches"],
        "seconds": mp_k["seconds"], "budget_seconds": CACHE_BUDGET_S}
        | card}))
    mp_l = mp["3l"]
    print(json.dumps({"scrub": {
        "objects": mp_l["objects"], "gb": mp_l["bytes"] / 1e9,
        "table_checked": mp_l["table_checked"],
        "a_audit": {"seconds": mp_l["a"]["seconds"],
                    "block_fp_launches": mp_l["launches"]["a"]["block_fp"],
                    **{k: mp_l["a"]["report"][k] for k in (
                        "checked_objects", "healthy", "checked_tiers",
                        "elapsed_s")}},
        "b_scrub_on_start": {
            "victim": mp_l["b"]["victim"],
            "unrecoverable": len(mp_l["b"]["report"]["unrecoverable"]),
            **{k: mp_l["b"]["report"][k] for k in (
                "checked_objects", "healthy", "demoted_manifests",
                "quarantined", "elapsed_s")},
            "restore": mp_l["b"]["restore"],
            "victim_read": mp_l["b"]["victim_read"],
            "unit_equals_older_table": mp_l["b"]["unit_equals_older_table"],
            "block_fp_launches": mp_l["launches"]["b_train"]["block_fp"]},
        "b_release": mp_l["b"]["release"]
        | {"block_fp_launches": mp_l["launches"]["b_release"]["block_fp"]},
        "b_seconds": mp_l["b"]["seconds"], "seconds": mp_l["seconds"],
        "budget_seconds": SCRUB_BUDGET_S} | card}))
    print(json.dumps({"supervisor": supervisor_summary(mp["3m"]) | card}))
    print(json.dumps({"sharded": sharded_summary(mp["3n"]) | card}))
    ot, osv = mp["3o"]["train"], mp["3o"]["serve"]
    print(json.dumps({"hybrid": {
        "seconds": mp["3o"]["seconds"],
        "train": {k: ot[k] for k in (
            "config", "step_seconds_median", "loss_diffs", "launches",
            "saved_unit_kinds", "step2_shared_attn", "peak_device_bytes")}
        | {"event_stall_seconds": {e["step"]: e["stall_seconds"]
                                   for e in ot["save_events"]},
           "restore_seconds": ot["restore_on_resume"]["seconds"]},
        "serve": {k: osv[k] for k in (
            "config", "prefill_seconds", "decode_tokens_per_s",
            "peak_device_bytes", "launches", "decode_vs_prefill",
            "decode_vs_prefill_float32", "decode_profile")}} | card}))
    print(json.dumps({"moe": moe_summary(mp["3p"], card)}))
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
    log(f"bytecode: {cache_bytecode()}")
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
    shutil.rmtree(TRASH, ignore_errors=True)
    store.mkdir(parents=True)
    free = shutil.disk_usage(store).free
    log(f"{free / 1e9:.1f} GB free under {store}")
    if free < STORE_BYTES_NEEDED:
        raise RuntimeError(f"only {free / 1e9:.1f} GB free under {store}; "
                           "the main paths hold up to "
                           f"{STORE_BYTES_NEEDED / 1e9:.0f} GB at a time")
    record = {"card": card, "kernels": kernels,
              "main_path": {"3a": {}, "3b": {}, "3c": {},
                            "3d": {"serve": {}, "store": {}},
                            "3e": {"train": {}, "store": {}, "serve": {}},
                            "3f": {}, "3g": {}, "3h": {}, "3i": {},
                            "3j": {}, "3k": {}, "3l": {}, "3m": {},
                            "3n": {}, "3o": {"train": {}, "serve": {}},
                            "3p": {"train": {}, "serve": {}}}}
    mp = record["main_path"]
    try:
        ref = phase_3a(torch, dev, store / "3a", mp["3a"])
        # 3h resumes and then removes 3a's store: 3i holds its runs
        # against these
        mp["3a"]["entry_digests"] = {
            str(s): {f"{u}/{k}": d for (u, k), d in
                     _entry_digests(store / "3a" / "run", s).items()}
            for s in (2, 4)}
        log(f"phase 3a done at {time.perf_counter() - t_start:.1f} s")
        phase_3j(torch, dev, store, mp["3a"], mp["3j"])
        log(f"phase 3j done at {time.perf_counter() - t_start:.1f} s")
        phase_3g(torch, dev, store / "3a", mp["3a"]["losses_resumed"],
                 mp["3g"])
        log(f"phase 3g done at {time.perf_counter() - t_start:.1f} s")
        phase_3k(torch, dev, store, mp["3k"])
        log(f"phase 3k done at {time.perf_counter() - t_start:.1f} s")
        phase_3l(torch, dev, store, mp["3l"])
        log(f"phase 3l done at {time.perf_counter() - t_start:.1f} s")
        phase_3h(torch, dev, store, ref, mp["3a"], mp["3h"])
        REMOVER.discard(store / "3a")
        torch.cuda.empty_cache()
        log(f"phase 3h done at {time.perf_counter() - t_start:.1f} s")
        phase_3m(torch, dev, store, ref, mp["3m"])
        log(f"phase 3m done at {time.perf_counter() - t_start:.1f} s")
        phase_3i(torch, dev, store, mp["3a"], mp["3i"])
        log(f"phase 3i done at {time.perf_counter() - t_start:.1f} s")
        phase_3b(torch, dev, store / "3b", ref, mp["3b"])
        kernels.append(block_gather_at_main_shape(torch, dev,
                                                  store / "3b" / "run"))
        log(f"phase 3b done at {time.perf_counter() - t_start:.1f} s")
        phase_3d_store(torch, dev, store / "3b" / "run",
                       mp["3b"]["restore_on_resume"]["bytes_read"],
                       mp["3d"]["store"])
        log(f"phase 3d (store) done at {time.perf_counter() - t_start:.1f} s")
        REMOVER.discard(store / "3b")
        phase_3f(torch, dev, store / "3f", ref, mp["3f"],
                 {"3a_events": mp["3a"]["save_events"],
                  "3d_store": mp["3d"]["store"]})
        REMOVER.discard(store / "3f")
        log(f"phase 3f done at {time.perf_counter() - t_start:.1f} s")
        mp["3c"].update(phase_3c(torch, dev, store / "3c"))
        log(f"phase 3c done at {time.perf_counter() - t_start:.1f} s")
        phase_3d_serve(torch, dev, mp["3d"]["serve"])
        log(f"phase 3d (serve) done at {time.perf_counter() - t_start:.1f} s")
        phase_3e(torch, dev, store / "3e", mp["3e"])
        log(f"phase 3e done at {time.perf_counter() - t_start:.1f} s")
        phase_3n(torch, dev, store, mp["3a"], mp["3n"])
        log(f"phase 3n done at {time.perf_counter() - t_start:.1f} s")
        phase_3o(torch, dev, store / "3o", mp["3o"])
        log(f"phase 3o done at {time.perf_counter() - t_start:.1f} s")
        phase_3p(torch, dev, store / "3p", mp["3p"])
        log(f"phase 3p done at {time.perf_counter() - t_start:.1f} s")
    finally:
        REMOVER.drain()
        record["removal_seconds"] = REMOVER.seconds
        log(f"trees deleted behind the phases in {REMOVER.seconds:.1f} s")
        shutil.rmtree(store, ignore_errors=True)
        shutil.rmtree(TRASH, ignore_errors=True)
        write_record(record, args.record)
    report(record, args.record)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
