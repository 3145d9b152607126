#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--record PATH]

Needs one CUDA card (an H100: the kernels build for sm_90a) and the CUDA
toolkit's ``nvcc``; exits non-zero without them.  Phases, any failure of
which exits non-zero:

1. print the card's name and power limit; build the three CUDA kernels
   from the sources in this checkout (one ``nvcc`` each, concurrently);
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
      the same manifests and objects;
4. print the main paths' step/save/restore times, the kernels line, the
   card line, and last the ``{"ok": true, "device": ...}`` line; with
   ``--record PATH``, the full record of every phase also goes to PATH
   (written even when a check fails).

The stores live under ``build/`` in this checkout and are removed at the
end.
"""
from __future__ import annotations

import argparse
import json
import math
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
STORE_BYTES_NEEDED = 26e9
CHAIN_ARCH = "llama3.2-3b"   # phase 3c, reduced config

# Published H100 SXM peaks (NVIDIA data sheet) for the bound_ms column.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

SUMSQ_RTOL = 1e-4   # float sums of 16K terms in another order
ADAM_RTOL = 1e-5    # float32 update, FMA contraction vs separate ops
ADAM_ATOL = 1e-7


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
    from repro_torch.kernels import fused_adamw as fadam

    return {"block_fp": bfp.KERNEL, "fused_adamw": fadam.KERNEL,
            "block_gather": bg.KERNEL}


def _zero_counts() -> None:
    for k in _launch_counts().values():
        k.launches = 0


def _read_counts() -> dict:
    return {n: k.launches for n, k in _launch_counts().items()}


def check_store(torch, dev, root: Path, policy: str, merged_step: int,
                ) -> dict:
    """A store's step-``merged_step`` manifest merges units of two events;
    after a restore of LATEST every unit's device fingerprints equal its
    stored table; an unchanged re-save moves nothing."""
    from repro_torch.checkpoint import fingerprint as fputil
    from repro_torch.checkpoint.saver import CheckpointManager
    from repro_torch.core.layer_registry import LayerRegistry
    from repro_torch.core.policies import make_policy
    from repro_torch.kernels import block_fp as bfp
    from repro_torch.launch import steps

    model = _model()
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

    def mgr_at(root):
        return CheckpointManager(root, registry,
                                 make_policy("full", model.layer_units()),
                                 fp_block_bytes=bb)

    def signature(mgr):
        sig = {}
        for step, _ in events:
            m = mgr.manifests.load(step)
            sig[step] = {(u, k): (e.digest, e.stored, e.delta_base)
                         for u, kinds in m.entries.items()
                         for k, e in kinds.items()}
        return sig, sorted(mgr.store.iter_digests())

    mgr = mgr_at(store / "sync")
    for step, si in events:
        mgr.save(states[si], step=step)
    want = signature(mgr)
    mgr.close()
    out = {}
    for guess in (1, 1 << 20):
        mgr = mgr_at(store / f"ov-{guess}")
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
        if got != want:
            raise AssertionError(f"phase 3c: overlapped saves (predictor "
                                 f"{guess}) differ from the sync saves")
        if (overflows > 0) != (guess == 1):
            raise AssertionError(f"phase 3c: predictor {guess} gave "
                                 f"{overflows} overflow re-dispatches")
        out[f"predictor_{guess}"] = {"overflow_redispatches": overflows}
    torch.cuda.synchronize()
    log(f"phase 3c: sync and overlapped chains identical ({out})")
    return {"events": len(events), "objects": len(want[1]), **out}


def write_record(record: dict, path) -> None:
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(record, indent=1))


def report(record: dict, path) -> None:
    """Fill the kernels' launch counts from the main paths, rewrite the
    record, log the per-event split and print the summary lines."""
    kernels, mp = record["kernels"], record["main_path"]
    mp_a, mp_b, mp_c = mp["3a"], mp["3b"], mp["3c"]
    for k in kernels:
        k["launches"] = mp_b["launches"][k["name"]]
        k["launches_sync_path"] = mp_a["launches"][k["name"]]
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
        "3c": mp_c}
    print(json.dumps({"main_path": summary}))
    print(json.dumps({"kernels": kernels}))


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
    t = time.perf_counter()
    BUILDER.build(["block_fp", "fused_adamw", "block_gather"])
    for name, text in BUILDER.logs.items():
        log(f"--- nvcc {name}.cu ---\n{text.strip()}")
    log(f"kernels built in {time.perf_counter() - t:.1f} s")

    check_block_fp_dtypes(torch, dev)
    check_block_gather_cases(torch, dev)
    kernels = [block_fp_at_main_shapes(torch, dev)]
    torch.cuda.empty_cache()
    kernels.append(fused_adamw_at_main_shapes(torch, dev))
    torch.cuda.empty_cache()

    store = ROOT / "build" / "chip_smoke_store"
    shutil.rmtree(store, ignore_errors=True)
    store.mkdir(parents=True)
    free = shutil.disk_usage(store).free
    log(f"{free / 1e9:.1f} GB free under {store}")
    if free < STORE_BYTES_NEEDED:
        raise RuntimeError(f"only {free / 1e9:.1f} GB free under {store}; "
                           f"the main paths write about 25 GB at a time")
    record = {"card": card, "kernels": kernels,
              "main_path": {"3a": {}, "3b": {}, "3c": {}}}
    mp = record["main_path"]
    try:
        ref = phase_3a(torch, dev, store / "3a", mp["3a"])
        shutil.rmtree(store / "3a", ignore_errors=True)
        torch.cuda.empty_cache()
        phase_3b(torch, dev, store / "3b", ref, mp["3b"])
        kernels.append(block_gather_at_main_shape(torch, dev,
                                                  store / "3b" / "run"))
        shutil.rmtree(store / "3b", ignore_errors=True)
        mp["3c"].update(phase_3c(torch, dev, store / "3c"))
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
