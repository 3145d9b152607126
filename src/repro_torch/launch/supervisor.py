"""Resiliency supervisor of the port: run the trainer as a child process,
survive its deaths and account for what they cost.

    sup = Supervisor("/ckpt", steps=6, interval=3, run_dir="/run",
                     arch="yi-9b", reduced=False, num_layers=2,
                     injections=[Injection("kill", at_step=4),
                                 Injection("sigterm", at_step=4)],
                     verify_restore=True, scrub_on_restart=True)
    report = sup.run()          # -> goodput / MTTR / lost-step report

Each attempt:

1. launches ``python -m repro_torch.launch.train`` with
   ``--handle-sigterm``, a ``--progress-file`` feed, the attempt's
   ``--shard-participants`` from the ``participants`` plan (the elastic
   plan: e.g. ``(4, 2)`` saves 4-wide, then resumes 2-wide from the
   4-wide store), and ``--resume`` when the checkpoint root already has a
   committed manifest;
2. tails the feed and fires the attempt's injection: ``kill`` sends
   SIGKILL once the child reports the target step (a node lost, nothing
   flushed), ``sigterm`` sends SIGTERM (a preemption notice: the trainer
   commits a save of every unit with the durability barrier waived, drains
   the spill backlog and exits ``EXIT_PREEMPTED``), ``crash`` passes
   ``--fail-at N@point --fail-mode exit`` so the child ends itself inside
   that stage of the save pipeline (``checkpoint/faults.py``);
3. classifies the exit: 0 the run completed, ``EXIT_PREEMPTED`` a clean
   preemption (it must lose no step), anything else a crash.  For every
   interruption LATEST is authoritative, and the supervisor accounts
   ``lost_steps`` (the last step the child ran less the last committed
   one), ``lost_seconds`` (from the last commit to the death) and
   ``mttr_seconds`` (from the death to the next attempt's first progress
   line: the scrub and the probe below, the process start, the card's
   context, the model and the restore);
4. optionally scrubs the store (``checkpoint/scrub.py``: repair or
   quarantine before the next attempt plans its restore) and probes that
   it restores (``launch/elastic.py``), then relaunches.  It stops after
   ``max_restarts`` deaths that no injection caused.

The report adds ``goodput_steps`` (total steps over the steps executed,
re-executed tails being the waste) and ``goodput_wall`` (1 - (lost +
recovery seconds) / wall seconds).

Where the port departs from the JAX package's supervisor:

- ``device``, ``reduced`` and ``num_layers`` reach the child
  (``--device``, ``--full``, ``--num-layers``), the probe and the scrub;
  the defaults behave as the JAX package's (the card is the port's
  default device; ``run`` raises without one unless ``device="cpu"``);
- the child's standard output (the trainer's JSON result) goes to
  ``attempt-N.out`` apart from its log, and each attempt's record carries
  the part of that result that says where the attempt's time and memory
  went (``result``, ``startup``);
- each child leads a process group of its own: after its death the
  group's other processes (its IO workers) are killed, and the shared
  memory segments of dead owners are swept
  (``async_io.sweep_dead_owner_shm``), before the scrub and the next
  launch;
- the CLI writes ``run_dir/report.json`` and prints the report; it writes
  no benchmark file (the port's benchmark is ROADMAP A6).
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

log = logging.getLogger("repro_torch.supervisor")

#: ``repro_torch.launch.train.EXIT_PREEMPTED``, kept here so that this
#: module imports neither torch nor the trainer until ``run``.
EXIT_PREEMPTED = 17

#: The keys of a child's result an attempt's record keeps.
RESULT_KEYS = ("device", "peak_device_bytes", "steps", "preempted_at",
               "step_seconds", "train_seconds", "save_seconds",
               "spill_drain_seconds", "kernels_compiled", "kernel_launches")


@dataclasses.dataclass
class Injection:
    """One scheduled failure drill.  ``kind``:

    - ``"kill"``    — SIGKILL once the child reports step >= at_step,
    - ``"sigterm"`` — SIGTERM ditto (preemption notice),
    - ``"crash"``   — the child arms ``at_step@crash_point`` with
      ``--fail-mode exit`` and dies inside that pipeline stage on its
      own (no supervisor signal involved).
    """
    kind: str
    at_step: int
    crash_point: Optional[str] = None

    def __post_init__(self) -> None:
        if self.kind not in ("kill", "sigterm", "crash"):
            raise ValueError(f"unknown injection kind {self.kind!r}")
        if self.kind == "crash" and not self.crash_point:
            raise ValueError("kind='crash' needs a crash_point")


def _read_progress(path: Path) -> List[Tuple[str, int, float]]:
    """Parse a trainer ``--progress-file`` feed; tolerant of a torn last
    line (the writer may have died mid-write)."""
    out: List[Tuple[str, int, float]] = []
    if not path.is_file():
        return out
    for line in path.read_text().splitlines():
        parts = line.strip().split(",")
        if len(parts) != 3:
            continue
        try:
            out.append((parts[0], int(parts[1]), float(parts[2])))
        except ValueError:
            continue
    return out


def _latest_committed(ckpt_dir: Path) -> Optional[int]:
    # LATEST is the commit pointer (the manifest is written first): what
    # it names is authoritative, however the writer died.
    p = ckpt_dir / "LATEST"
    if not p.is_file():
        return None
    try:
        return int(p.read_text().strip())
    except ValueError:
        return None


def _child_result(path: Path) -> Optional[Dict[str, Any]]:
    """The trainer's JSON result from its standard output, or None (a
    child that died printed none)."""
    try:
        return json.loads(path.read_text())
    except (OSError, ValueError):
        return None


def _end_group(pgid: int, wait: float = 5.0) -> None:
    """SIGKILL what is left of a dead child's process group and wait, up to
    ``wait`` seconds, until none of it is left."""
    try:
        os.killpg(pgid, signal.SIGKILL)
    except ProcessLookupError:
        return
    deadline = time.time() + wait
    while time.time() < deadline:
        try:
            os.killpg(pgid, 0)
        except ProcessLookupError:
            return
        time.sleep(0.05)


class Supervisor:
    def __init__(
        self,
        ckpt_dir: "str | Path",
        *,
        steps: int,
        interval: int,
        run_dir: "str | Path",
        arch: str = "llama3.2-3b",
        batch: int = 2,
        seq_len: int = 16,
        policy: str = "full",
        store_backend: str = "local",
        io_backend: str = "thread",
        io_workers: Optional[int] = None,
        participants: Sequence[int] = (1,),
        injections: Sequence[Injection] = (),
        verify_restore: bool = False,
        scrub_on_restart: bool = False,
        max_restarts: int = 2,
        attempt_timeout: float = 600.0,
        poll: float = 0.05,
        seed: int = 0,
        extra_args: Sequence[str] = (),
        device: Optional[str] = None,
        reduced: bool = True,
        num_layers: Optional[int] = None,
    ) -> None:
        self.participants = [int(p) for p in participants] or [1]
        if any(p < 1 for p in self.participants):
            raise ValueError(f"participants plan {self.participants}: "
                             "every attempt needs at least 1 participant")
        self.ckpt_dir = Path(ckpt_dir)
        self.run_dir = Path(run_dir)
        self.steps = int(steps)
        self.interval = int(interval)
        self.arch = arch
        self.batch = batch
        self.seq_len = seq_len
        self.policy = policy
        self.store_backend = store_backend
        self.io_backend = io_backend
        self.io_workers = io_workers
        self.injections = list(injections)
        self.verify_restore = verify_restore
        self.scrub_on_restart = scrub_on_restart
        self.max_restarts = int(max_restarts)
        self.attempt_timeout = float(attempt_timeout)
        self.poll = float(poll)
        self.seed = seed
        self.extra_args = list(extra_args)
        self.device = None if device is None else str(device)
        self.reduced = bool(reduced)
        self.num_layers = num_layers
        self._device = None     # resolved by ``run``

    # ----------------------------------------------------------- plumbing
    def _participants_for(self, attempt: int) -> int:
        """The attempt's save participants: the plan's entry, its last one
        past its end (the elastic plan, e.g. 4 then 2)."""
        plan = self.participants
        return plan[attempt] if attempt < len(plan) else plan[-1]

    def _child_env(self) -> Dict[str, str]:
        env = dict(os.environ)
        src = str(Path(__file__).resolve().parents[2])
        env["PYTHONPATH"] = src + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        return env

    def _argv(self, attempt: int, injection: Optional[Injection],
              progress: Path, losses: Path) -> List[str]:
        argv = [
            sys.executable, "-m", "repro_torch.launch.train",
            "--arch", self.arch,
            "--steps", str(self.steps),
            "--batch", str(self.batch),
            "--seq-len", str(self.seq_len),
            "--policy", self.policy,
            "--ckpt-interval", str(self.interval),
            "--ckpt-dir", str(self.ckpt_dir),
            "--store-backend", self.store_backend,
            "--io-backend", self.io_backend,
            "--shard-participants", str(self._participants_for(attempt)),
            "--seed", str(self.seed),
            "--handle-sigterm",
            "--progress-file", str(progress),
            "--log-csv", str(losses),
        ]
        if self.device is not None:
            argv += ["--device", self.device]
        if not self.reduced:
            argv.append("--full")
        if self.num_layers is not None:
            argv += ["--num-layers", str(self.num_layers)]
        if self.io_workers is not None:
            argv += ["--io-workers", str(self.io_workers)]
        if _latest_committed(self.ckpt_dir) is not None:
            argv.append("--resume")
        if injection is not None and injection.kind == "crash":
            argv += ["--fail-at",
                     f"{injection.at_step}@{injection.crash_point}",
                     "--fail-mode", "exit"]
        argv += self.extra_args
        return argv

    def _probe(self) -> Optional[Dict[str, Any]]:
        """Restorability check before the relaunch (counted in MTTR)."""
        if not self.verify_restore:
            return None
        if _latest_committed(self.ckpt_dir) is None:
            # Death before the first commit: nothing to probe, and the
            # relaunch (without --resume) starts from scratch anyway.
            return None
        from repro_torch.launch.elastic import probe_restore
        return probe_restore(self.ckpt_dir, self.arch, reduced=self.reduced,
                             num_layers=self.num_layers,
                             store_backend=self.store_backend,
                             device=self._device)

    def _scrub(self) -> Optional[Dict[str, Any]]:
        """Integrity scrub before the relaunch: a crash is when bit-rot or a
        torn tier copy surfaces, so repair or quarantine before the next
        attempt plans its restore.  It runs here, against the tiers that
        outlive the dead child (the disk tree of a backend whose RAM tier
        died with it)."""
        if not self.scrub_on_restart:
            return None
        if _latest_committed(self.ckpt_dir) is None:
            return None
        from repro_torch.checkpoint.scrub import scrub_root
        backend = (self.store_backend
                   if self.store_backend in ("remote", "remote3")
                   else "local")
        t0 = time.time()
        rep = scrub_root(self.ckpt_dir, backend=backend, device=self._device)
        return {"checked_objects": rep["checked_objects"],
                "repaired": len(rep["repaired"]),
                "unrecoverable": len(rep["unrecoverable"]),
                "demoted_manifests": rep["demoted_manifests"],
                "seconds": time.time() - t0}

    # ---------------------------------------------------------------- run
    def run(self) -> Dict[str, Any]:
        from repro_torch.checkpoint.async_io import sweep_dead_owner_shm
        from repro_torch.devices import resolve_device

        # the card unless asked for the CPU: raises here, before any
        # launch, when there is none
        self._device = resolve_device(self.device)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        t_run0 = time.time()
        interruptions: List[Dict[str, Any]] = []
        attempts: List[Dict[str, Any]] = []
        injection_queue = list(self.injections)
        unscheduled_deaths = 0
        attempt = 0
        completed = False

        while not completed:
            injection = injection_queue.pop(0) if injection_queue else None
            progress = self.run_dir / f"progress-{attempt}.log"
            losses = self.run_dir / f"losses-{attempt}.csv"
            child_log = self.run_dir / f"attempt-{attempt}.log"
            child_out = self.run_dir / f"attempt-{attempt}.out"
            argv = self._argv(attempt, injection, progress, losses)
            n_parts = self._participants_for(attempt)
            log.info("attempt %d: participants=%d injection=%s",
                     attempt, n_parts, injection)
            t_launch = time.time()
            with open(child_log, "wb") as lf, open(child_out, "wb") as of:
                proc = subprocess.Popen(argv, env=self._child_env(),
                                        stdout=of, stderr=lf,
                                        start_new_session=True)
                try:
                    exit_code, t_death = self._monitor(proc, progress,
                                                       injection)
                finally:
                    _end_group(proc.pid)
            removed = sweep_dead_owner_shm()
            if removed:
                log.info("swept %d shared-memory segment(s) of dead "
                         "owners", len(removed))
            lines = _read_progress(progress)
            steps_executed = sum(1 for k, _, _ in lines if k == "step")
            reached = max((s for k, s, _ in lines if k == "step"), default=0)
            t_start_line = next((t for k, _, t in lines if k == "start"),
                                t_launch)
            result = _child_result(child_out)
            attempts.append({
                "attempt": attempt,
                "participants": n_parts,
                "pid": proc.pid,
                "exit_code": exit_code,
                "steps_executed": steps_executed,
                "reached_step": reached,
                "launch_to_first_progress": t_start_line - t_launch,
                "seconds": t_death - t_launch,
                # where launch_to_first_progress went, from the child's
                # result: the interpreter and its imports up to ``train``,
                # then the card's context, the model and manager, the
                # scrub and the restore
                "startup": (None if result is None else
                            {"process_seconds":
                             result["started_unix"] - t_launch,
                             **result["startup"]}),
                "result": (None if result is None else
                           {k: result.get(k) for k in RESULT_KEYS}
                           | {"restore_seconds": (
                               result["restore_stats"] or {}).get(
                                   "seconds"),
                              # from ``train``'s return to the death
                              "exit_seconds":
                                  t_death - result["finished_unix"]}),
            })

            if exit_code == 0:
                completed = True
                break

            committed = _latest_committed(self.ckpt_dir) or 0
            # Wall time from the last commit-ish event (a ckpt/preempt
            # line, else the attempt start) to the death: the work that
            # existed only in the lost process.
            t_last_commit = max(
                (t for k, s, t in lines
                 if k in ("ckpt", "preempt") and s <= committed),
                default=t_start_line)
            interruption = {
                "attempt": attempt,
                "kind": (injection.kind if injection is not None
                         else "unscheduled"),
                "injected_at_step": (injection.at_step
                                     if injection is not None else None),
                "crash_point": (injection.crash_point
                                if injection is not None else None),
                "exit_code": exit_code,
                "preempted": exit_code == EXIT_PREEMPTED,
                "reached_step": reached,
                "committed_step": committed,
                "lost_steps": max(0, reached - committed),
                "lost_seconds": max(0.0, t_death - t_last_commit),
            }
            if injection is None:
                unscheduled_deaths += 1
                if unscheduled_deaths > self.max_restarts:
                    interruptions.append(interruption)
                    raise RuntimeError(
                        f"{unscheduled_deaths} unscheduled child deaths "
                        f"(exit {exit_code}) exceed max_restarts="
                        f"{self.max_restarts}; last attempt log: "
                        f"{child_log}")
            scrub = self._scrub()
            if scrub is not None:
                interruption["scrub"] = scrub
            probe = self._probe()
            if probe is not None:
                interruption["restore_probe"] = probe
            # MTTR closes when the NEXT attempt emits its first progress
            # line; filled in after relaunch.
            interruption["_t_death"] = t_death
            interruptions.append(interruption)
            attempt += 1

        # Close open MTTR windows against each following attempt's first
        # progress timestamp.
        for inter in interruptions:
            t_death = inter.pop("_t_death", None)
            if t_death is None:
                continue
            nxt = inter["attempt"] + 1
            lines = _read_progress(self.run_dir / f"progress-{nxt}.log")
            t_up = next((t for k, _, t in lines if k == "start"), None)
            inter["mttr_seconds"] = (max(0.0, t_up - t_death)
                                     if t_up is not None else None)

        total_wall = time.time() - t_run0
        step_executions = sum(a["steps_executed"] for a in attempts)
        lost_total = sum(i["lost_steps"] for i in interruptions)
        lost_seconds = sum(i["lost_seconds"] for i in interruptions)
        mttrs = [i["mttr_seconds"] for i in interruptions
                 if i.get("mttr_seconds") is not None]
        report = {
            "completed": completed,
            "total_steps": self.steps,
            "ckpt_interval": self.interval,
            "policy": self.policy,
            "store_backend": self.store_backend,
            "participants_plan": self.participants,
            "device": str(self._device),
            "attempts": attempts,
            "interruptions": [
                {k: v for k, v in i.items() if not k.startswith("_")}
                for i in interruptions],
            "n_interruptions": len(interruptions),
            "lost_steps_total": lost_total,
            "lost_seconds_total": lost_seconds,
            "mttr_seconds_mean": (sum(mttrs) / len(mttrs)
                                  if mttrs else None),
            "step_executions": step_executions,
            # scrub-on-restart accounting (fsck between attempts)
            "scrubs_run": sum(1 for i in interruptions if "scrub" in i),
            "scrub_repaired_total": sum(
                i["scrub"]["repaired"] for i in interruptions
                if "scrub" in i),
            "scrub_unrecoverable_total": sum(
                i["scrub"]["unrecoverable"] for i in interruptions
                if "scrub" in i),
            "goodput_steps": (self.steps / step_executions
                              if step_executions else None),
            "goodput_wall": (max(0.0, 1.0 - (lost_seconds + sum(mttrs))
                                 / total_wall)
                             if total_wall > 0 else None),
            "total_wall_seconds": total_wall,
        }
        (self.run_dir / "report.json").write_text(
            json.dumps(report, indent=2, default=str))
        return report

    def _monitor(self, proc: subprocess.Popen, progress: Path,
                 injection: Optional[Injection]
                 ) -> Tuple[int, float]:
        """Poll the child + its progress feed; fire the injection's
        signal at the target step.  Returns (exit_code, death_time)."""
        deadline = time.time() + self.attempt_timeout
        sig = None
        if injection is not None and injection.kind in ("kill", "sigterm"):
            sig = (signal.SIGKILL if injection.kind == "kill"
                   else signal.SIGTERM)
        fired = sig is None
        while True:
            rc = proc.poll()
            if rc is not None:
                return rc, time.time()
            if time.time() > deadline:
                proc.kill()
                proc.wait()
                raise TimeoutError(
                    f"trainer exceeded attempt_timeout="
                    f"{self.attempt_timeout}s (progress: {progress})")
            if not fired:
                lines = _read_progress(progress)
                reached = max((s for k, s, _ in lines if k == "step"),
                              default=-1)
                if reached >= injection.at_step:
                    log.info("firing %s at step %d (pid %d)",
                             injection.kind, reached, proc.pid)
                    proc.send_signal(sig)
                    fired = True
            time.sleep(self.poll)


def merged_losses(run_dir: "str | Path") -> Dict[int, float]:
    """Merge every attempt's loss CSV into one step->loss map.

    Later attempts win on overlap: after a crash the steps past the last
    commit run again in the next attempt, and under an exact resume both
    values are the same."""
    out: Dict[int, float] = {}
    run_dir = Path(run_dir)
    for path in sorted(run_dir.glob("losses-*.csv"),
                       key=lambda p: int(p.stem.split("-")[1])):
        for line in path.read_text().splitlines()[1:]:
            s, l = line.split(",")
            out[int(s)] = float(l)
    return out


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--full", action="store_true",
                    help="the config at full width (default: reduced)")
    ap.add_argument("--num-layers", type=int,
                    help="cut the config's depth (widths unchanged)")
    ap.add_argument("--steps", type=int, default=48)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=16)
    ap.add_argument("--policy", default="full")
    ap.add_argument("--ckpt-interval", type=int, default=8)
    ap.add_argument("--store-backend", default="local")
    ap.add_argument("--io-backend", default="thread",
                    choices=["thread", "process"],
                    help="trainer IO backend (forwarded to "
                         "repro_torch.launch.train --io-backend)")
    ap.add_argument("--io-workers", type=int,
                    help="process backend: subprocess IO worker count")
    ap.add_argument("--participants", default="1",
                    help="comma-separated per-attempt plan of save "
                         "participants (the last entry repeats), e.g. 4,2")
    ap.add_argument("--inject", action="append", default=[],
                    help="kind:step[:point], e.g. kill:11, sigterm:30, "
                         "crash:12:spill (repeatable; one per attempt)")
    ap.add_argument("--verify-restore", action="store_true")
    ap.add_argument("--scrub-on-restart", action="store_true",
                    help="run the store-wide integrity scrub (fsck) "
                         "between attempts: repair corrupt tier copies, "
                         "quarantine the unrecoverable before relaunch")
    ap.add_argument("--attempt-timeout", type=float, default=600.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu': the children's, the "
                         "scrub's and the probe's device")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO)

    injections = []
    for spec in args.inject:
        parts = spec.split(":")
        injections.append(Injection(
            parts[0], int(parts[1]),
            crash_point=parts[2] if len(parts) > 2 else None))
    sup = Supervisor(
        args.ckpt_dir, run_dir=args.run_dir, arch=args.arch,
        steps=args.steps, batch=args.batch, seq_len=args.seq_len,
        policy=args.policy, interval=args.ckpt_interval,
        store_backend=args.store_backend,
        io_backend=args.io_backend, io_workers=args.io_workers,
        participants=[int(p) for p in args.participants.split(",")],
        injections=injections, verify_restore=args.verify_restore,
        scrub_on_restart=args.scrub_on_restart,
        attempt_timeout=args.attempt_timeout, seed=args.seed,
        device=args.device, reduced=not args.full,
        num_layers=args.num_layers)
    report = sup.run()
    print(json.dumps(report, indent=2, default=str))


if __name__ == "__main__":
    main()
