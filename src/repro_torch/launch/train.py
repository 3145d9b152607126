"""Trainer of the port: dense training with LLMTailor selective
checkpointing and Frankenstein resume, on the card by default.

    python -m repro_torch.launch.train --arch yi-9b --full --num-layers 2 \\
        --batch 2 --seq-len 1024 --steps 6 --policy parity \\
        --ckpt-interval 2 --ckpt-dir /path/to/run [--fail-at 5] [--resume]

- selective checkpoints every ``ckpt_interval`` steps (policy-driven,
  synchronous saves on the fingerprint path, local store, codec none),
- ``--fail-at N`` raises a simulated failure at the step-N boundary,
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
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint.saver import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core.layer_registry import LayerRegistry
from repro_torch.core.policies import make_policy
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.devices import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models import build_model

log = logging.getLogger("repro_torch.train")


class SimulatedFailure(RuntimeError):
    """The injected failure; carries the losses and save-event stats the
    run recorded before it died."""

    def __init__(self, msg: str, losses=(), save_events=()):
        super().__init__(msg)
        self.losses = list(losses)
        self.save_events = list(save_events)


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
    resume: bool = False,
    fail_at: Optional[int] = None,
    seed: int = 0,
    log_csv: Optional[str] = None,
    lr: float = 1e-3,
    device=None,
    num_layers: Optional[int] = None,
) -> Dict:
    dev = resolve_device(device)
    if fail_at is not None and not str(fail_at).isdigit():
        raise NotImplementedError("named crash points (--fail-at N@point) "
                                  "are not ported to repro_torch yet")
    fail_step = int(fail_at) if fail_at is not None else None
    cfg = get_config(arch, reduced=reduced)
    if num_layers is not None:
        cfg = cfg.replace(num_layers=int(num_layers))
    model = build_model(cfg)
    tcfg = TrainConfig(learning_rate=lr, warmup_steps=20,
                       total_steps=total_steps, ckpt_interval=ckpt_interval,
                       seed=seed)
    registry = LayerRegistry(model, weight_decay=tcfg.weight_decay)
    policy = make_policy(policy_name, model.layer_units())
    mgr = CheckpointManager(Path(ckpt_dir), registry, policy)
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

    def event_meta():
        return {"data_state": data.state_dict(), "arch": arch,
                "reduced": reduced, "tcfg": tcfg.to_json()}

    losses, step_seconds, save_events = [], [], []
    t0 = time.perf_counter()
    for step in range(start, total_steps):
        t_step = time.perf_counter()
        raw = data.peek(step)
        data.state.step = step + 1
        tokens = torch.from_numpy(raw["tokens"]).to(dev)
        state, metrics = train_step(state, {"tokens": tokens})
        loss = float(metrics["loss"])
        step_seconds.append(time.perf_counter() - t_step)
        losses.append((step, loss))
        if fail_step is not None and step + 1 == fail_step:
            mgr.close()
            raise SimulatedFailure(f"injected failure at step {fail_step}",
                                   losses, save_events)
        if (step + 1) % ckpt_interval == 0:
            mgr.save(state, step=step + 1, meta=event_meta())
            save_events.append(dict(mgr.last_save_stats))
    total = time.perf_counter() - t0

    if log_csv:
        Path(log_csv).parent.mkdir(parents=True, exist_ok=True)
        with open(log_csv, "w") as f:
            f.write("step,loss\n")
            for s, l in losses:
                f.write(f"{s},{l}\n")
    mgr.close()
    usage = mgr.disk_usage()
    save_seconds = sum(e["seconds"] for e in save_events)
    return {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "final_loss": losses[-1][1] if losses else float("nan"),
        "losses": losses,
        "step_seconds": step_seconds,
        "train_seconds": total,
        "save_seconds": save_seconds,
        "ckpt_time_fraction": save_seconds / total if total else 0.0,
        "save_events": save_events,
        "restore_stats": restore_stats,
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
    ap.add_argument("--policy", default="full",
                    choices=["full", "parity", "filtered", "interval"])
    ap.add_argument("--ckpt-interval", type=int, default=50)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_train")
    ap.add_argument("--sync-save", action="store_true",
                    help="accepted for the JAX trainer's CLI; saves are "
                         "always synchronous here")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int,
                    help="simulated failure at the step-N boundary")
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
                ckpt_dir=args.ckpt_dir, resume=args.resume,
                fail_at=args.fail_at, seed=args.seed, log_csv=args.log_csv,
                lr=args.lr, device=args.device, num_layers=args.num_layers)
    out.pop("losses")
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
