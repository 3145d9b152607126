"""Trainer of the port: dense training with LLMTailor selective
checkpointing and Frankenstein resume, on the card by default.

    python -m repro_torch.launch.train --arch yi-9b --full --num-layers 2 \\
        --batch 2 --seq-len 1024 --steps 8 --policy topk_delta \\
        --ckpt-interval 2 --ckpt-spread-steps 2 --ckpt-dir /path/to/run \\
        [--fail-at 7 | --fail-at 7@spread_slice] [--resume]

- selective checkpoints every ``ckpt_interval`` steps (policy-driven, on
  the fingerprint path, local store); the object writes run on
  ``--writer-threads`` writer threads unless ``--sync-save`` asks for
  inline writes;
- ``--codec int8`` (``auto`` and ``none`` store raw bytes) composes
  selectivity with compression: the selected units' float leaves of at
  least 256 elements, weights and optimizer state alike, are quantized on
  the device and stored as int8 values and one float32 scale per 256
  elements; the resume dequantizes them on the device (lossy);
- ``--ckpt-spread-steps N`` (N > 0) runs each event through the
  overlapped saver (``checkpoint/overlap.py``): the device work and the
  decisions at the step boundary, the device->host copies, encoding and
  writes across the next N steps, the commit after them;
- ``--policy topk_delta`` selects the most-drifted blocks by the
  ``DeltaTracker`` scores (``core/delta.py``);
- ``--fail-at N`` raises a simulated failure at the step-N boundary;
  ``--fail-at N@point[:hit]`` arms the named crash point at that boundary
  (``checkpoint/faults.py``), so the failure fires inside the save
  pipeline; an armed point that is never reached fails the run;
- ``--resume`` restores the implicit Frankenstein merge of the newest
  manifest and continues with byte-identical data (the data state rides in
  the manifest meta),
- ``--device cpu`` is the only way onto the CPU; ``--num-layers`` cuts the
  depth of a config (a full-width state that does not fit the card).
"""
from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.checkpoint import faults
from repro_torch.checkpoint.overlap import OverlappedSaver
from repro_torch.checkpoint.saver import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core.delta import DeltaTracker
from repro_torch.core.layer_registry import LayerRegistry
from repro_torch.core.policies import make_policy
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.devices import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models import build_model

log = logging.getLogger("repro_torch.train")

POLICIES = ("full", "parity", "filtered", "interval", "topk_delta")
_SPLIT = ("snapshot_seconds", "stage_seconds", "writeback_seconds",
          "stall_seconds")


class SimulatedFailure(RuntimeError):
    """The injected failure; carries the losses and save-event stats the
    run recorded before it died."""

    def __init__(self, msg: str, losses=(), save_events=()):
        super().__init__(msg)
        self.losses = list(losses)
        self.save_events = list(save_events)


def _close_quietly(ov: Optional[OverlappedSaver],
                   mgr: CheckpointManager) -> None:
    """Failure path: drop the in-flight event and shut the writer down
    without masking the error being raised."""
    for close in ((ov.close if ov is not None else None), mgr.close):
        if close is None:
            continue
        try:
            close()
        except Exception as e:  # noqa: BLE001
            log.warning("close after failure: %r", e)


def train(
    *,
    arch: str,
    reduced: bool = True,
    total_steps: int = 200,
    batch: int = 8,
    seq_len: int = 64,
    policy_name: str = "full",
    ckpt_interval: int = 50,
    ckpt_dir: str = "/tmp/repro_train",
    ckpt_async: bool = True,
    ckpt_spread_steps: int = 0,
    codec: str = "auto",
    writer_threads: int = 2,
    resume: bool = False,
    fail_at: Optional[Union[int, str]] = None,
    seed: int = 0,
    log_csv: Optional[str] = None,
    lr: float = 1e-3,
    device=None,
    num_layers: Optional[int] = None,
) -> Dict:
    dev = resolve_device(device)
    fail_step, fail_point, fail_hit = (None, None, 1)
    if fail_at is not None:
        fail_step, fail_point, fail_hit = faults.parse_fail_at(fail_at)
    cfg = get_config(arch, reduced=reduced)
    if num_layers is not None:
        cfg = cfg.replace(num_layers=int(num_layers))
    model = build_model(cfg)
    tcfg = TrainConfig(learning_rate=lr, warmup_steps=20,
                       total_steps=total_steps, ckpt_interval=ckpt_interval,
                       seed=seed)
    registry = LayerRegistry(model, weight_decay=tcfg.weight_decay)
    policy = make_policy(policy_name, model.layer_units())
    mgr = CheckpointManager(Path(ckpt_dir), registry, policy,
                            async_save=ckpt_async,
                            writer_threads=writer_threads, codec=codec)
    tracker = DeltaTracker(registry) if policy_name == "topk_delta" else None
    # Zero-stall pipeline: events begin at the step boundary and run their
    # host-side copy/encode/write across the next ``ckpt_spread_steps``.
    ov = (OverlappedSaver(mgr, spread_steps=ckpt_spread_steps)
          if ckpt_spread_steps > 0 else None)
    data = SyntheticTokens(vocab_size=cfg.vocab_size, batch=batch,
                           seq_len=seq_len, seed=seed)
    train_step = steps_lib.make_train_step(model, tcfg, registry)

    restore_stats = None
    if resume:
        state = mgr.restore(steps_lib.state_specs(model), device=dev)
        restore_stats = mgr.last_restore_stats
        meta = mgr.restore_meta()
        if "data_state" in meta:
            data.load_state(meta["data_state"])
        start = int(state["step"])
        log.info("resumed at step %d (policy=%s)", start, policy.name)
    else:
        state = steps_lib.init_state(model, seed, dev)
        start = 0
        if tracker:
            tracker.reset(state["params"])

    def event_meta():
        return {"data_state": data.state_dict(), "arch": arch,
                "reduced": reduced, "tcfg": tcfg.to_json()}

    losses, step_seconds, save_events = [], [], []
    # event step -> seconds of the steps whose tick served that event
    tick_seconds: Dict[int, List[float]] = {}

    def absorb_event(manifest) -> None:
        """Account one committed event (either mode) and, for an
        overlapped one, advance the tracker to its snapshot fingerprints."""
        ev = dict(mgr.last_save_stats)
        # the same list the loop appends to: a commit may precede the
        # seconds of the step whose tick made it
        ev["tick_step_seconds"] = tick_seconds.setdefault(ev["step"], [])
        save_events.append(ev)
        if ov is not None and tracker:
            for u in manifest.saved_units:
                if u in ov.last_snapshot_fps:
                    tracker.set_reference(u, ov.last_snapshot_fps[u])

    t0 = time.perf_counter()
    try:
        for step in range(start, total_steps):
            t_step = time.perf_counter()
            raw = data.peek(step)
            data.state.step = step + 1
            tokens = torch.from_numpy(raw["tokens"]).to(dev)
            state, metrics = train_step(state, {"tokens": tokens})
            ticked = ov.event_step if ov is not None else None
            if ticked is not None:
                # One spread slice per step, between dispatching the step
                # and reading its loss: the host stages and writes while
                # the card computes.
                done = ov.tick()
                if done is not None:
                    absorb_event(done)
            loss = float(metrics["loss"])
            step_seconds.append(time.perf_counter() - t_step)
            if ticked is not None:
                tick_seconds.setdefault(ticked, []).append(step_seconds[-1])
            losses.append((step, loss))
            if fail_step is not None and step + 1 == fail_step:
                if fail_point is None:
                    raise SimulatedFailure(
                        f"injected failure at step {fail_step}", losses,
                        save_events)
                # The death happens inside the save machinery (possibly on
                # a writer thread, surfacing on a drain), not here.
                faults.arm(fail_point, hit=fail_hit)
                log.info("armed crash point %r (hit=%d) at step %d",
                         fail_point, fail_hit, fail_step)
            if (step + 1) % ckpt_interval == 0:
                if ov is not None and ov.active:
                    # Events are FIFO: the one still in flight commits
                    # first (begin would force it as well), so its snapshot
                    # fingerprints are the tracker's references below.
                    absorb_event(ov.finish())
                scores = tracker.scores(state["params"]) if tracker else None
                if ov is not None:
                    # Device reads and decisions now, while the state still
                    # holds this step's values; the rest rides the ticks.
                    ov.begin(state, step + 1, meta=event_meta(),
                             drift_scores=scores)
                else:
                    manifest = mgr.save(state, step=step + 1,
                                        meta=event_meta(),
                                        drift_scores=scores)
                    if tracker:
                        tracker.mark_saved(state["params"],
                                           manifest.saved_units)
                    absorb_event(manifest)
        if ov is not None and ov.active:
            # Run end: the last event may still be mid-spread.
            absorb_event(ov.finish())
        if fail_point is not None and fail_point in faults.pending():
            faults.disarm(fail_point)
            raise SimulatedFailure(
                f"crash point {fail_point!r} armed at step {fail_step} was "
                "never reached before the run ended", losses, save_events)
    except BaseException:
        _close_quietly(ov, mgr)
        raise
    total = time.perf_counter() - t0

    if log_csv:
        Path(log_csv).parent.mkdir(parents=True, exist_ok=True)
        with open(log_csv, "w") as f:
            f.write("step,loss\n")
            for s, l in losses:
                f.write(f"{s},{l}\n")
    if ov is not None:
        ov.close()
    mgr.close()
    usage = mgr.disk_usage()
    # The loop only ever blocked for the stall portion of an event: that is
    # what save_seconds means in both modes.
    save_seconds = sum(e["stall_seconds"] for e in save_events)
    return {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "final_loss": losses[-1][1] if losses else float("nan"),
        "losses": losses,
        "step_seconds": step_seconds,
        "train_seconds": total,
        "save_seconds": save_seconds,
        "ckpt_time_fraction": save_seconds / total if total else 0.0,
        **{k: sum(e[k] for e in save_events) for k in _SPLIT},
        "save_mode": "overlapped" if ov is not None else "sync",
        "codec": mgr.store.codec,
        "ckpt_spread_steps": ckpt_spread_steps,
        "overlap_slices": sum(e.get("spread_slices", 0)
                              for e in save_events),
        "overflow_redispatches": sum(e.get("overflow_redispatches", 0)
                                     for e in save_events),
        "save_events": save_events,
        "restore_stats": restore_stats,
        "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
        "ckpt_bytes": usage["total"],
        "d2h_bytes": sum(e["d2h_bytes"] for e in save_events),
        "hashed_bytes": sum(e["hashed_bytes"] for e in save_events),
        "dirty_block_frac": (float(np.mean([e["dirty_block_frac"]
                                            for e in save_events]))
                             if save_events else 0.0),
        "steps": total_steps - start,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_IDS, default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--num-layers", type=int,
                    help="cut the config's depth (widths unchanged)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--policy", default="full", choices=POLICIES)
    ap.add_argument("--ckpt-interval", type=int, default=50)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_train")
    ap.add_argument("--ckpt-spread-steps", type=int, default=0,
                    help="N > 0: overlapped saves, each event's host work "
                         "spread over the next N steps")
    ap.add_argument("--codec", default="auto",
                    choices=["auto", "none", "int8"],
                    help="object codec: auto/none store raw bytes, int8 "
                         "quantizes float leaves on the device (lossy)")
    ap.add_argument("--writer-threads", type=int, default=2,
                    help="threads that encode and write objects")
    ap.add_argument("--sync-save", action="store_true",
                    help="write objects inline on the training thread "
                         "instead of on the writer threads")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at",
                    help="N: simulated failure at the step-N boundary; "
                         "N@point[:hit]: arm that crash point at step N")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--log-csv")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO)
    out = train(arch=args.arch, reduced=args.smoke, total_steps=args.steps,
                batch=args.batch, seq_len=args.seq_len,
                policy_name=args.policy, ckpt_interval=args.ckpt_interval,
                ckpt_dir=args.ckpt_dir, ckpt_async=not args.sync_save,
                ckpt_spread_steps=args.ckpt_spread_steps,
                codec=args.codec,
                writer_threads=args.writer_threads, resume=args.resume,
                fail_at=args.fail_at, seed=args.seed, log_csv=args.log_csv,
                lr=args.lr, device=args.device, num_layers=args.num_layers)
    out.pop("losses")
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
