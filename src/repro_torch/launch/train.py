"""Trainer of the port: training of every ported family (dense, MoE,
SSM, hybrid) with LLMTailor selective checkpointing and Frankenstein
resume, on the card by default.

    python -m repro_torch.launch.train --arch yi-9b --full --num-layers 2 \\
        --batch 2 --seq-len 1024 --steps 8 --policy topk_delta \\
        --ckpt-interval 2 --ckpt-spread-steps 2 --ckpt-dir /path/to/run \\
        [--fail-at 7 | --fail-at 7@spread_slice] [--resume]

- selective checkpoints every ``ckpt_interval`` steps (policy-driven),
  on the fingerprint path, or with ``--no-fingerprint``
  (``ckpt_fingerprint=False``) on the canonical path: each selected unit
  crosses to the host whole and is addressed by the blake2b of its
  canonical payload, written full or as an XOR delta; the object writes
  run on ``--writer-threads`` writer threads unless ``--sync-save`` asks
  for inline writes;
- ``--codec int8`` (``auto`` and ``none`` store raw bytes) composes
  selectivity with compression: the selected units' float leaves of at
  least 256 elements, weights and optimizer state alike, are quantized on
  the device and stored as int8 values and one float32 scale per 256
  elements; the resume dequantizes them on the device (lossy);
- ``--ckpt-spread-steps N`` (N > 0) runs each event through the
  overlapped saver (``checkpoint/overlap.py``): the device work and the
  decisions at the step boundary, the device->host copies, encoding and
  writes across the next N steps, the commit after them (fingerprint path
  only: with ``--no-fingerprint`` it raises ``ValueError``);
- ``--store-backend`` picks the object tier (``local`` POSIX tree,
  volatile ``memory``, ``tiered`` RAM hot tier spilling to disk on
  ``--spill-threads`` threads, the simulated ``remote`` bucket, or
  ``remote3``, RAM -> disk -> remote, with ``--remote-latency``,
  ``--remote-error-rate`` and ``--remote-seed``); ``--hot-budget-mb``
  bounds the RAM tier (spilled objects are evicted past it) and
  ``--spill-barrier`` makes every commit wait for the durable tier.  The
  run ends with a spill drain (``spill_drain_seconds``) and reports
  ``tier_stats``;
- ``--io-backend process`` runs the object writes' byte work (framing and
  crc32s, block and XOR deltas, file writes) and the resume's decodes in
  ``--io-workers`` subprocess workers over shared memory
  (``checkpoint/async_io.py``); ``thread`` (the default) keeps it in this
  process;
- ``--policy topk_delta`` selects the most-drifted blocks by the
  ``DeltaTracker`` scores (``core/delta.py``);
- ``--fail-at N`` raises a simulated failure at the step-N boundary;
  ``--fail-at N@point[:hit]`` arms the named crash point at that boundary
  (``checkpoint/faults.py``), so the failure fires inside the save
  pipeline; an armed point that is never reached fails the run;
- ``--resume`` restores the implicit Frankenstein merge of the newest
  manifest and continues with byte-identical data (the data state rides in
  the manifest meta),
- ``--scrub-on-start`` runs the store's scrub (``checkpoint/scrub.py``)
  first, tables checked on ``--device``: corrupt tier copies repaired from
  a good one, the unrecoverable quarantined so the resume's plan skips
  them; the result carries its report (``scrub_report``),
- ``--fail-mode exit`` makes an armed crash point end the process at once
  (``os._exit`` with ``faults.EXIT_CRASHED``, 43: no unwinding, no
  flushing) instead of raising: the supervisor's crash drills,
- ``--handle-sigterm`` turns SIGTERM into a preemption: the handler only
  sets a flag, and at the next step boundary the trainer commits a save of
  every unit with the durability barrier waived, drains the spill backlog
  and exits with ``EXIT_PREEMPTED`` (17): nothing committed is lost and no
  queued write is abandoned,
- ``--progress-file`` appends ``kind,step,unix-time`` lines (``start``,
  ``step``, ``ckpt``, ``preempt``, ``preempt_durable``, ``done``), the
  feed the supervisor (``launch/supervisor.py``) tails,
- ``--log-csv`` gets a ``step,loss`` line as each step ends (flushed, so
  a process killed mid-run leaves the steps it ran; the JAX package
  writes the file at the run's end),
- ``--shard-participants N`` (N > 1) saves shard-native
  (``checkpoint/sharded.py``): N participants on threads each fingerprint
  and write only their axis-0 blocks of every selected unit, and the
  manifest commits through the two-phase barrier; a resume reads any N's
  store (the next event's shards then start fresh bases).  With
  ``--ckpt-spread-steps`` it raises ``ValueError``, as in the JAX package,
- ``--device cpu`` is the only way onto the CPU; ``--num-layers`` cuts the
  depth of a config (a full-width state that does not fit the card).

Exit codes of the CLI: 0 the run completed, ``EXIT_PREEMPTED`` (17) a
preemption save committed, ``faults.EXIT_CRASHED`` (43) an armed crash
point in ``--fail-mode exit``, anything else a failure.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import logging
import signal
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.checkpoint import faults
from repro_torch.checkpoint.overlap import OverlappedSaver
from repro_torch.checkpoint.saver import CheckpointManager
from repro_torch.checkpoint.sharded import ShardedCheckpointer
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core.delta import DeltaTracker
from repro_torch.core.layer_registry import LayerRegistry
from repro_torch.core.policies import make_policy
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.devices import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels import block_fp as bfp
from repro_torch.kernels import block_gather as bg
from repro_torch.kernels import fused_adamw as fadam
from repro_torch.kernels import quantize as qz
from repro_torch.launch import steps as steps_lib
from repro_torch.models import build_model

log = logging.getLogger("repro_torch.train")

#: Exit code of a clean preemption (SIGTERM handled, the save committed):
#: the supervisor restarts the run but does not count it as a crash.
EXIT_PREEMPTED = 17

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


class _Lines:
    """Lines written to ``path`` (nothing when it is None), each flushed
    as it is written: the reader may be another process, and the writer
    may die at any moment."""

    def __init__(self, path: Optional[str], mode: str = "a"):
        self._f = None
        if path:
            Path(path).parent.mkdir(parents=True, exist_ok=True)
            self._f = open(path, mode, buffering=1)

    def write(self, line: str) -> None:
        if self._f is not None:
            self._f.write(line + "\n")
            self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()


class _Progress(_Lines):
    """The supervisor's feed: one ``kind,step,unix-time`` line per
    event."""

    def emit(self, kind: str, step: int) -> None:
        self.write(f"{kind},{step},{time.time():.6f}")


def _kernel_launches() -> Dict[str, int]:
    """This process's launch counts of the training path's kernels."""
    return {"block_fp": bfp.KERNEL.launches,
            "fused_adamw": fadam.KERNEL.launches,
            "block_gather": bg.KERNEL.launches,
            "quantize": qz.QUANTIZE.launches,
            "dequantize": qz.DEQUANTIZE.launches}


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


@contextlib.contextmanager
def _preemption_flag(handle_sigterm: bool):
    """A flag that SIGTERM sets while the block runs (``handle_sigterm``);
    the handler it replaced comes back on the way out.  Only the flag is
    set: the save happens on the training thread at the next step
    boundary, where the state is whole."""
    flag = threading.Event()
    installed = False
    if handle_sigterm:
        try:
            prev = signal.signal(signal.SIGTERM,
                                 lambda signum, frame: flag.set())
            installed = True
        except ValueError:
            log.warning("cannot install SIGTERM handler off the main "
                        "thread; preemption handling disabled")
    try:
        yield flag
    finally:
        if installed:
            signal.signal(signal.SIGTERM,
                          signal.SIG_DFL if prev is None else prev)


def _import_in_background(name: str) -> Optional[threading.Thread]:
    """Start importing module ``name`` on a daemon thread, unless it is
    imported already; returns the thread to join."""
    if name in sys.modules:
        return None
    t = threading.Thread(target=importlib.import_module, args=(name,),
                         name=f"import-{name}", daemon=True)
    t.start()
    return t


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
    ckpt_fingerprint: bool = True,
    codec: str = "auto",
    writer_threads: int = 2,
    store_backend: str = "local",
    spill_threads: int = 2,
    hot_budget_mb: Optional[int] = None,
    spill_barrier: bool = False,
    remote_opts: Optional[Dict] = None,
    io_backend: str = "thread",
    io_workers: Optional[int] = None,
    resume: bool = False,
    fail_at: Optional[Union[int, str]] = None,
    seed: int = 0,
    log_csv: Optional[str] = None,
    lr: float = 1e-3,
    device=None,
    num_layers: Optional[int] = None,
    scrub_on_start: bool = False,
    shard_participants: int = 1,
    fail_mode: str = "raise",
    handle_sigterm: bool = False,
    progress_file: Optional[str] = None,
) -> Dict:
    started = time.time()
    if shard_participants < 1:
        raise ValueError(f"shard_participants={shard_participants}: a save "
                         "needs at least one participant")
    if ckpt_spread_steps > 0 and shard_participants > 1:
        raise ValueError("--ckpt-spread-steps is incompatible with "
                         "--shard-participants > 1")
    t = time.perf_counter()
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)   # the card's context, timed here
    startup = {"device_seconds": time.perf_counter() - t}
    fail_step, fail_point, fail_hit = (None, None, 1)
    if fail_at is not None:
        fail_step, fail_point, fail_hit = faults.parse_fail_at(fail_at)
    t = time.perf_counter()
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
                            writer_threads=writer_threads, codec=codec,
                            fingerprint=ckpt_fingerprint,
                            store_backend=store_backend,
                            spill_threads=spill_threads,
                            hot_budget_bytes=(hot_budget_mb * 2**20
                                              if hot_budget_mb else None),
                            spill_barrier=spill_barrier,
                            remote_opts=remote_opts,
                            io_backend=io_backend, io_workers=io_workers)
    tracker = DeltaTracker(registry) if policy_name == "topk_delta" else None
    # Shard-native saves: N participants on threads, one commit through the
    # barrier; ``saver`` keeps ``CheckpointManager.save``'s signature.
    saver = (ShardedCheckpointer(mgr, shard_participants)
             if shard_participants > 1 else mgr)
    # Zero-stall pipeline: events begin at the step boundary and run their
    # host-side copy/encode/write across the next ``ckpt_spread_steps``.
    try:
        ov = (OverlappedSaver(mgr, spread_steps=ckpt_spread_steps)
              if ckpt_spread_steps > 0 else None)
    except ValueError:
        mgr.close()
        raise
    data = SyntheticTokens(vocab_size=cfg.vocab_size, batch=batch,
                           seq_len=seq_len, seed=seed)
    train_step = steps_lib.make_train_step(model, tcfg, registry)
    startup["build_seconds"] = time.perf_counter() - t

    with _preemption_flag(handle_sigterm) as preempt_flag, \
            contextlib.closing(_Progress(progress_file)) as progress, \
            contextlib.closing(_Lines(log_csv, "w")) as loss_log:
        scrub_report = None
        t = time.perf_counter()
        if scrub_on_start:
            # fsck before the store is touched: repair corrupt tier copies
            # from a good one and quarantine the unrecoverable, so the
            # resume's plan skips them up front
            try:
                scrub_report = mgr.scrub(device=dev)
            except BaseException:
                _close_quietly(ov, mgr)
                raise
            log.info("scrub-on-start: %d object(s) checked, %d repaired, "
                     "%d unrecoverable", scrub_report["checked_objects"],
                     len(scrub_report["repaired"]),
                     len(scrub_report["unrecoverable"]))
        startup["scrub_seconds"] = time.perf_counter() - t
        t = time.perf_counter()
        restore_stats = None
        if resume:
            # a restarted trainer's first step imports torch._dynamo
            # (torch.utils.checkpoint's disabled frames: seconds): import
            # it while the restore reads and decodes
            warm = _import_in_background("torch._dynamo")
            state = mgr.restore(steps_lib.state_specs(model), device=dev)
            if warm is not None:
                warm.join()
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
        startup["state_seconds"] = time.perf_counter() - t
        preempted_at: Optional[int] = None
        progress.emit("start", start)

        def event_meta():
            return {"data_state": data.state_dict(), "arch": arch,
                    "reduced": reduced, "tcfg": tcfg.to_json()}

        losses, aux_losses, step_seconds, save_events = [], [], [], []
        # event step -> seconds of the steps whose tick served that event
        tick_seconds: Dict[int, List[float]] = {}

        def absorb_event(manifest) -> None:
            """Account one committed event (either mode) and, for an
            overlapped one, advance the tracker to its snapshot
            fingerprints."""
            ev = dict(mgr.last_save_stats)
            # the same list the loop appends to: a commit may precede the
            # seconds of the step whose tick made it
            ev["tick_step_seconds"] = tick_seconds.setdefault(ev["step"],
                                                              [])
            save_events.append(ev)
            progress.emit("ckpt", manifest.step)
            if ov is not None and tracker:
                for u in manifest.saved_units:
                    if u in ov.last_snapshot_fps:
                        tracker.set_reference(u, ov.last_snapshot_fps[u])

        loss_log.write("step,loss")
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
                    # One spread slice per step, between dispatching the
                    # step and reading its loss: the host stages and writes
                    # while the card computes.
                    done = ov.tick()
                    if done is not None:
                        absorb_event(done)
                loss = float(metrics["loss"])
                step_seconds.append(time.perf_counter() - t_step)
                if ticked is not None:
                    tick_seconds.setdefault(ticked, []).append(
                        step_seconds[-1])
                losses.append((step, loss))
                # the MoE layers' load-balancing term (0 without MoE)
                aux_losses.append((step, float(metrics["aux_loss"].detach())))
                loss_log.write(f"{step},{loss}")
                progress.emit("step", step + 1)
                if fail_step is not None and step + 1 == fail_step:
                    if fail_point is None:
                        raise SimulatedFailure(
                            f"injected failure at step {fail_step}", losses,
                            save_events)
                    # The death happens inside the save machinery (possibly
                    # on a writer thread, surfacing on a drain), not here.
                    faults.arm(fail_point, hit=fail_hit, mode=fail_mode)
                    log.info("armed crash point %r (hit=%d mode=%s) at step "
                             "%d", fail_point, fail_hit, fail_mode, fail_step)
                if preempt_flag.is_set():
                    # The preemption save: every unit (unchanged ones dedup
                    # and move nothing), so the resume is exact whatever the
                    # policy, with the durable spill barrier waived so the
                    # manifest commits now; the grace period drains the
                    # spill backlog below.  An event in flight commits first
                    # (FIFO).
                    if ov is not None and ov.active:
                        absorb_event(ov.finish())
                    manifest = saver.save(state, step=step + 1,
                                          meta=event_meta(),
                                          units=policy.all_units(),
                                          durability_barrier=False)
                    save_events.append(dict(mgr.last_save_stats,
                                            tick_step_seconds=[],
                                            preemption=True))
                    preempted_at = step + 1
                    progress.emit("preempt", step + 1)
                    log.info("preempted: hot save committed at step %d "
                             "(durable_on=%s)", step + 1,
                             manifest.meta["storage"]["durable_on"])
                    break
                if (step + 1) % ckpt_interval == 0:
                    if ov is not None and ov.active:
                        # Events are FIFO: the one still in flight commits
                        # first (begin would force it as well), so its
                        # snapshot fingerprints are the tracker's references
                        # below.
                        absorb_event(ov.finish())
                    scores = (tracker.scores(state["params"]) if tracker
                              else None)
                    if ov is not None:
                        # Device reads and decisions now, while the state
                        # still holds this step's values; the rest rides the
                        # ticks.
                        ov.begin(state, step + 1, meta=event_meta(),
                                 drift_scores=scores)
                    else:
                        manifest = saver.save(state, step=step + 1,
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
                    f"crash point {fail_point!r} armed at step {fail_step} "
                    "was never reached before the run ended", losses,
                    save_events)
            total = time.perf_counter() - t0
            # How far durability lagged the hot tier at the end of the run
            # (0 on one tier): the last manifests become durable-tier backed
            # before the process exits.
            t_drain = time.perf_counter()
            mgr.drain_spill()
            spill_drain_seconds = time.perf_counter() - t_drain
        except BaseException:
            _close_quietly(ov, mgr)
            raise

        tier_stats = mgr.store.tier_stats()
        if ov is not None:
            ov.close()
        mgr.close()
        usage = mgr.disk_usage()
        if preempted_at is not None:
            progress.emit("preempt_durable", preempted_at)
        else:
            progress.emit("done", total_steps)
        # The loop only ever blocked for the stall portion of an event: that
        # is what save_seconds means in both modes.
        save_seconds = sum(e["stall_seconds"] for e in save_events)
        return {
            "preempted": preempted_at is not None,
            "preempted_at": preempted_at,
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
            "final_loss": losses[-1][1] if losses else float("nan"),
            "losses": losses,
            "aux_losses": aux_losses,
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
            "store_backend": store_backend,
            "io_backend": io_backend,
            "spill_drain_seconds": spill_drain_seconds,
            "tier_stats": tier_stats,
            # the report of the scrub-on-start pass (None when not run)
            "scrub_report": scrub_report,
            "shard_participants": shard_participants,
            # what came before the first step: the unix time ``train`` was
            # entered, and the seconds of the card's context, the model and
            # manager, the scrub and the restore (or the initial state); and
            # the unix time it returned
            "started_unix": started,
            "startup": startup,
            "finished_unix": time.time(),
            # the kernel libraries this process compiled (none when it found
            # them built) and its launch counts at the run's end
            "kernels_compiled": list(_build.BUILDER.compiled),
            "kernel_launches": _kernel_launches(),
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
                         "spread over the next N steps (fingerprint path "
                         "only)")
    ap.add_argument("--no-fingerprint", action="store_true",
                    help="canonical save path: each selected unit crosses "
                         "to the host whole, addressed by the blake2b of "
                         "its canonical payload (full or XOR-delta "
                         "objects)")
    ap.add_argument("--codec", default="auto",
                    choices=["auto", "none", "int8"],
                    help="object codec: auto/none store raw bytes, int8 "
                         "quantizes float leaves on the device (lossy)")
    ap.add_argument("--writer-threads", type=int, default=2,
                    help="threads that encode and write objects")
    ap.add_argument("--store-backend", default="local",
                    choices=["local", "memory", "tiered", "remote",
                             "remote3"],
                    help="object tier: local POSIX tree, volatile RAM, RAM "
                         "hot tier spilling to disk, simulated remote "
                         "bucket, or RAM -> disk -> remote")
    ap.add_argument("--remote-latency", type=float, default=0.0,
                    help="remote/remote3: simulated per-op latency (s)")
    ap.add_argument("--remote-error-rate", type=float, default=0.0,
                    help="remote/remote3: seeded per-op fault rate of the "
                         "simulated service")
    ap.add_argument("--remote-seed", type=int, default=0,
                    help="remote/remote3: fault-schedule seed")
    ap.add_argument("--spill-threads", type=int, default=2,
                    help="tiered/remote3: threads per spill lane")
    ap.add_argument("--hot-budget-mb", type=int,
                    help="tiered/remote3: RAM tier budget; spilled objects "
                         "are evicted least recently used first past it")
    ap.add_argument("--spill-barrier", action="store_true",
                    help="tiered/remote3: wait for the durable tier before "
                         "each manifest commit")
    ap.add_argument("--io-backend", default="thread",
                    choices=["thread", "process"],
                    help="where the checkpoint byte work runs: 'process' "
                         "in subprocess workers over shared memory, "
                         "'thread' in this process")
    ap.add_argument("--io-workers", type=int,
                    help="process backend: subprocess IO workers (default "
                         "max(2, pool threads))")
    ap.add_argument("--sync-save", action="store_true",
                    help="write objects inline on the training thread "
                         "instead of on the writer threads")
    ap.add_argument("--scrub-on-start", action="store_true",
                    help="run the store-wide integrity scrub (fsck) before "
                         "training or the resume: repair corrupt tier "
                         "copies from a good one, quarantine the "
                         "unrecoverable")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at",
                    help="N: simulated failure at the step-N boundary; "
                         "N@point[:hit]: arm that crash point at step N")
    ap.add_argument("--fail-mode", default="raise",
                    choices=["raise", "exit"],
                    help="armed crash points raise InjectedCrash, or end "
                         "the process at once with exit code %d (no "
                         "unwinding, no flushing)" % faults.EXIT_CRASHED)
    ap.add_argument("--handle-sigterm", action="store_true",
                    help="treat SIGTERM as a preemption: a save of every "
                         "unit at the next step boundary, the spill backlog "
                         "drained, exit code %d" % EXIT_PREEMPTED)
    ap.add_argument("--progress-file",
                    help="append kind,step,unix-time progress lines here "
                         "(the supervisor's feed)")
    ap.add_argument("--shard-participants", type=int, default=1,
                    help="N > 1: shard-native saves, N participants (each "
                         "its axis-0 blocks) and a two-phase commit")
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
                ckpt_fingerprint=not args.no_fingerprint,
                codec=args.codec,
                writer_threads=args.writer_threads,
                store_backend=args.store_backend,
                spill_threads=args.spill_threads,
                hot_budget_mb=args.hot_budget_mb,
                spill_barrier=args.spill_barrier,
                remote_opts={"latency": args.remote_latency,
                             "error_rate": args.remote_error_rate,
                             "seed": args.remote_seed},
                io_backend=args.io_backend, io_workers=args.io_workers,
                resume=args.resume, scrub_on_start=args.scrub_on_start,
                fail_at=args.fail_at, fail_mode=args.fail_mode,
                handle_sigterm=args.handle_sigterm,
                progress_file=args.progress_file,
                shard_participants=args.shard_participants, seed=args.seed,
                log_csv=args.log_csv, lr=args.lr, device=args.device,
                num_layers=args.num_layers)
    out.pop("losses")
    print(json.dumps(out, indent=2))
    if out["preempted"]:
        sys.exit(EXIT_PREEMPTED)


if __name__ == "__main__":
    main()
