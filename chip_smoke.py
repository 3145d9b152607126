#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels build for sm_90a) and the CUDA
toolkit's ``nvcc``; exits non-zero without them.  Phases, any failure of
which exits non-zero:

1. print the card's name and power limit; build both CUDA kernels from the
   sources in this checkout (one ``nvcc`` each, concurrently);
2. hold each kernel against its plain PyTorch version on the card:
   ``block_fp`` over every dtype it takes with ragged tails and a
   misaligned leaf (fingerprint pairs bit-exact, also against the host
   oracle; two launches give bitwise-equal sums of squares within rtol of
   the plain version), then both kernels at the main path's shapes: a
   full-width Yi-9B block's optimizer unit (block_fp) and its leaves
   (fused_adamw); time kernel and plain version with CUDA events;
3. main path: Yi-9B at full width cut to 2 layers, batch 2, seq 1024,
   policy parity, checkpoint every 2 steps, through ``repro_torch.launch.
   train.train``: a 6-step reference run without saves, a checkpointed run
   that fails at step 5, and its resume to step 6.  Checks: finite losses;
   resumed losses at steps 5-6 within LOSS_TOL of the reference; the
   resumed manifest merges units of both events; after a restore, every
   unit's device fingerprints equal the tables stored in its objects; an
   unchanged re-save moves 0 bytes device->host; both kernels were launched
   by the main path (launch counts set to 0 just before it);
4. print the main path's step/save/restore times, the kernels line, the
   card line, and last the ``{"ok": true, "device": ...}`` line.

The store lives under ``build/`` in this checkout and is removed at the end.
"""
from __future__ import annotations

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
STEPS = 6
FAIL_AT = 5
CKPT_INTERVAL = 2
SEED = 0
# Resumed losses vs the uninterrupted run: the resume restores a
# Frankenstein merge (block_000 and lm_head two steps stale), so the
# losses differ by the drift of two warmup steps (lr <= 1.5e-4); 0.02 nat
# is ~0.2% of the ~11.5 nat loss of a random Yi-9B.
LOSS_TOL = 0.02
STORE_BYTES_NEEDED = 26e9

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


# ------------------------------------------------------------------ phase 3
def main_path(torch, dev, store: Path) -> dict:
    from repro_torch.checkpoint.saver import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core.layer_registry import LayerRegistry
    from repro_torch.core.policies import make_policy
    from repro_torch.kernels import block_fp as bfp
    from repro_torch.kernels import fused_adamw as fadam
    from repro_torch.checkpoint import fingerprint as fputil
    from repro_torch.launch import steps
    from repro_torch.launch.train import SimulatedFailure, train
    from repro_torch.models import build_model

    kw = dict(arch=ARCH, reduced=REDUCED, num_layers=NUM_LAYERS,
              total_steps=STEPS, batch=BATCH, seq_len=SEQ,
              policy_name="parity", seed=SEED, device=str(dev))
    bfp.KERNEL.launches = 0
    fadam.KERNEL.launches = 0
    t0 = time.perf_counter()
    ref = train(ckpt_dir=str(store / "ref"), ckpt_interval=STEPS + 1, **kw)
    try:
        train(ckpt_dir=str(store / "run"), ckpt_interval=CKPT_INTERVAL,
              fail_at=FAIL_AT, **kw)
        raise AssertionError("the checkpointed run did not fail")
    except SimulatedFailure as e:
        failed = e
    res = train(ckpt_dir=str(store / "run"), ckpt_interval=CKPT_INTERVAL,
                resume=True, **kw)
    torch.cuda.synchronize()
    launches = {"block_fp": bfp.KERNEL.launches,
                "fused_adamw": fadam.KERNEL.launches}
    wall = time.perf_counter() - t0
    log(f"main path done in {wall:.1f} s; launches {launches}")

    # -- checks
    for _, loss in ref["losses"] + res["losses"]:
        if not math.isfinite(loss):
            raise AssertionError(f"non-finite loss {loss}")
    ref_loss = dict(ref["losses"])
    diffs = {s + 1: abs(l - ref_loss[s]) for s, l in res["losses"]}
    if sorted(diffs) != [5, 6] or max(diffs.values()) > LOSS_TOL:
        raise AssertionError(f"resumed losses off the reference: {diffs}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched by the main path")

    cfg = get_config(ARCH, reduced=REDUCED).replace(num_layers=NUM_LAYERS)
    model = build_model(cfg)
    registry = LayerRegistry(model)
    mgr = CheckpointManager(store / "run", registry,
                            make_policy("parity", model.layer_units()))
    merged = mgr.manifests.load(STEPS - 2)
    steps_of = {r.step for kinds in merged.entries.values()
                for r in kinds.values()}
    if steps_of != {2, 4}:
        raise AssertionError(f"step-4 manifest is not a merge: {steps_of}")
    state = mgr.restore(steps.state_specs(model), device=dev)
    restore2 = dict(mgr.last_restore_stats)
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
                raise AssertionError(f"{name}/{kind}: device fingerprints "
                                     "differ from the stored table")
    mgr.save(state, step=int(state["step"]), units=registry.unit_names())
    resave = dict(mgr.last_save_stats)
    if resave["d2h_bytes"] != 0 or resave["written_bytes"] != 0:
        raise AssertionError(f"unchanged re-save moved bytes: {resave}")
    mgr.close()
    del state
    steady = statistics.median(ref["step_seconds"][1:])
    return {
        "config": f"{ARCH} full width, {NUM_LAYERS} layers, batch {BATCH}, "
                  f"seq {SEQ}, parity, ckpt every {CKPT_INTERVAL}",
        "launches": launches,
        "step_seconds_median": steady,
        "step_seconds_ref": ref["step_seconds"],
        "losses_ref": ref["losses"], "losses_failed_run": failed.losses,
        "losses_resumed": res["losses"],
        "loss_diffs": diffs,
        "save_events": failed.save_events + res["save_events"],
        "restore_on_resume": res["restore_stats"],
        "restore_check": restore2,
        "resave": {k: resave[k] for k in ("seconds", "d2h_bytes",
                                          "written_bytes", "dedup_hits")},
        "main_path_seconds": wall,
    }


def main() -> int:
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
    BUILDER.build(["block_fp", "fused_adamw"])
    for name, text in BUILDER.logs.items():
        log(f"--- nvcc {name}.cu ---\n{text.strip()}")
    log(f"kernels built in {time.perf_counter() - t:.1f} s")

    check_block_fp_dtypes(torch, dev)
    kernels = [block_fp_at_main_shapes(torch, dev)]
    torch.cuda.empty_cache()
    kernels.append(fused_adamw_at_main_shapes(torch, dev))
    torch.cuda.empty_cache()

    store = ROOT / "build" / "chip_smoke_store"
    shutil.rmtree(store, ignore_errors=True)
    store.mkdir(parents=True)
    free = shutil.disk_usage(store).free
    if free < STORE_BYTES_NEEDED:
        raise RuntimeError(f"only {free / 1e9:.1f} GB free under {store}; "
                           f"the main path writes about 25 GB")
    try:
        mp = main_path(torch, dev, store)
    finally:
        shutil.rmtree(store, ignore_errors=True)
    for k in kernels:
        k["launches"] = mp["launches"][k["name"]]
    print(json.dumps({"main_path": mp}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
