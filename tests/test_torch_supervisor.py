"""The port's failure surface on the CPU: the trainer's preemption, crash
exit and progress feed, the supervisor's drills (kill, SIGTERM, crash),
its limits and edges, and its CLI.  Every child runs ``--device cpu``
with one intra-op thread, under a timeout."""
import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from repro_torch.core.manifest import ManifestStore
from repro_torch.launch.elastic import probe_restore
from repro_torch.launch.supervisor import (EXIT_PREEMPTED, Injection,
                                           Supervisor, _read_progress,
                                           merged_losses)
from repro_torch.launch.train import SimulatedFailure, train

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
UNITS = ["embed", "block_000", "block_001", "block_002", "block_003",
         "final_norm", "lm_head"]
# the JAX package's acceptance drill (tests/test_resiliency.py)
DRILL = dict(arch="llama3.2-3b", total_steps=18, batch=2, seq_len=16,
             ckpt_interval=6, seed=11)


@pytest.fixture(autouse=True)
def _one_thread_children(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _env():
    return dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")


def _trainer_cmd(ckpt, *extra):
    return [sys.executable, "-m", "repro_torch.launch.train", "--device",
            "cpu", "--arch", "yi-9b", "--batch", "2", "--seq-len", "16",
            "--ckpt-dir", str(ckpt), *extra]


def _wait_for_step(proc, feed: Path, step: int, timeout: float = 120.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"the trainer exited {proc.returncode} "
                                 f"before step {step}")
        if any(k == "step" and s >= step for k, s, _ in
               _read_progress(feed)):
            return
        time.sleep(0.02)
    proc.kill()
    raise AssertionError(f"no step {step} in {timeout} s")


def _live_group_members(pgid: int):
    """Pids of processes in group ``pgid`` that are not zombies."""
    out = []
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            stat = (d / "stat").read_text()
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        if int(fields[2]) == pgid and fields[0] != "Z":
            out.append(int(d.name))
    return out


def test_preemption_commits_every_unit_and_resumes_exactly(tmp_path):
    """SIGTERM once the feed shows step 3: the trainer saves every unit at
    the next boundary (off the parity policy's cadence), writes
    ``preempt,r`` then ``preempt_durable,r``, exits 17; its resume to the
    end gives the uninterrupted run's losses bit for bit."""
    kw = dict(arch="yi-9b", total_steps=10, batch=2, seq_len=16, seed=3,
              policy_name="parity", ckpt_interval=4, device="cpu")
    ref = train(ckpt_dir=str(tmp_path / "ref"), **kw)
    ckpt, feed = tmp_path / "run", tmp_path / "progress.log"
    cmd = _trainer_cmd(ckpt, "--steps", "10", "--seed", "3", "--policy",
                       "parity", "--ckpt-interval", "4", "--handle-sigterm",
                       "--progress-file", str(feed), "--log-csv",
                       str(tmp_path / "l.csv"))
    proc = subprocess.Popen(cmd, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        _wait_for_step(proc, feed, 3)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        proc.kill()
    assert proc.returncode == EXIT_PREEMPTED, err
    result = json.loads(out)
    lines = _read_progress(feed)
    r = result["preempted_at"]
    assert result["preempted"] and r >= 3
    assert [(k, s) for k, s, _ in lines[-2:]] == [("preempt", r),
                                                  ("preempt_durable", r)]
    ms = ManifestStore(ckpt)
    assert ms.latest_step() == r
    assert ms.load(r).saved_units == UNITS
    assert result["save_events"][-1]["preemption"]
    res = train(ckpt_dir=str(ckpt), resume=True, **kw)
    assert res["restore_stats"]["step"] == r
    want = dict(ref["losses"])
    before = [tuple(map(float, x.split(","))) for x in
              (tmp_path / "l.csv").read_text().splitlines()[1:]]
    assert [int(s) for s, _ in before] == list(range(r))
    for step, loss in [(int(s), l) for s, l in before] + res["losses"]:
        assert loss == want[step], (step, loss, want[step])


def test_crash_exit_mode_tears_the_commit(tmp_path):
    """``--fail-mode exit`` at ``manifest_latest`` ends the process with
    43 between the manifest write and the LATEST flip."""
    feed = tmp_path / "p.log"
    out = subprocess.run(
        _trainer_cmd(tmp_path / "run", "--steps", "6", "--policy", "full",
                     "--ckpt-interval", "2", "--progress-file", str(feed),
                     "--fail-at", "4@manifest_latest", "--fail-mode",
                     "exit"), env=_env(), capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 43, out.stderr
    assert out.stdout == ""
    assert ManifestStore(tmp_path / "run").latest_step() == 2
    assert (tmp_path / "run/manifests/manifest-00000004.json").is_file()
    assert [(k, s) for k, s, _ in _read_progress(feed)] == [
        ("start", 0), ("step", 1), ("step", 2), ("ckpt", 2), ("step", 3),
        ("step", 4)]


def test_progress_feed_and_sigterm_handler_in_process(tmp_path):
    """In process: the feed's kinds, and the SIGTERM handler put back as
    it was when ``train`` returns (or raises)."""
    before = signal.getsignal(signal.SIGTERM)
    feed = tmp_path / "p.log"
    out = train(arch="yi-9b", total_steps=4, batch=2, seq_len=16,
                ckpt_interval=2, device="cpu", ckpt_dir=str(tmp_path / "r"),
                handle_sigterm=True, progress_file=str(feed))
    assert signal.getsignal(signal.SIGTERM) is before
    assert not out["preempted"] and out["preempted_at"] is None
    assert out["startup"].keys() == {"device_seconds", "build_seconds",
                                     "scrub_seconds", "state_seconds"}
    assert out["kernels_compiled"] == []
    assert [(k, s) for k, s, _ in _read_progress(feed)] == [
        ("start", 0), ("step", 1), ("step", 2), ("ckpt", 2), ("step", 3),
        ("step", 4), ("ckpt", 4), ("done", 4)]
    with pytest.raises(SimulatedFailure):
        train(arch="yi-9b", total_steps=4, batch=2, seq_len=16,
              ckpt_interval=2, device="cpu", ckpt_dir=str(tmp_path / "f"),
              handle_sigterm=True, fail_at=3)
    assert signal.getsignal(signal.SIGTERM) is before


def test_sigterm_off_the_main_thread_warns(tmp_path, caplog):
    got = {}

    def run():
        got["out"] = train(arch="yi-9b", total_steps=2, batch=2,
                           seq_len=16, ckpt_interval=2, device="cpu",
                           ckpt_dir=str(tmp_path / "r"),
                           handle_sigterm=True)

    with caplog.at_level(logging.WARNING, logger="repro_torch.train"):
        t = threading.Thread(target=run)
        t.start()
        t.join(timeout=120)
    assert not got["out"]["preempted"]
    assert "cannot install SIGTERM handler off the main thread" in \
        caplog.text


def test_acceptance_drill_kill_and_preempt_exact(tmp_path):
    """The JAX package's acceptance drill on the port (one participant):
    SIGKILL mid-run, then SIGTERM; the kill loses at most one cadence, the
    preemption nothing; merged losses equal an uninterrupted run bit for
    bit; the finished store restores at the last step."""
    ref = train(ckpt_dir=str(tmp_path / "ref"), device="cpu", **DRILL)
    ref_losses = dict(ref["losses"])
    sup = Supervisor(
        tmp_path / "ckpt", run_dir=tmp_path / "run", arch="llama3.2-3b",
        steps=18, interval=6, batch=2, seq_len=16, policy="full", seed=11,
        participants=(1,), injections=[Injection("kill", at_step=7),
                                       Injection("sigterm", at_step=13)],
        verify_restore=True, scrub_on_restart=True, device="cpu",
        attempt_timeout=180)
    report = sup.run()
    assert report["completed"]
    assert [a["exit_code"] for a in report["attempts"]] == [
        -signal.SIGKILL, EXIT_PREEMPTED, 0]
    kill, preempt = report["interruptions"]
    assert kill["kind"] == "kill" and not kill["preempted"]
    assert 0 <= kill["lost_steps"] <= 6 and kill["committed_step"] >= 6
    assert preempt["kind"] == "sigterm" and preempt["preempted"]
    assert preempt["lost_steps"] == 0
    assert preempt["committed_step"] == preempt["reached_step"]
    for inter in (kill, preempt):
        assert inter["mttr_seconds"] is not None
        assert not inter["restore_probe"]["fallback_units"]
        assert inter["scrub"]["unrecoverable"] == 0
        assert inter["scrub"]["checked_objects"] > 0
    assert 0 < report["goodput_steps"] <= 1.0
    done = report["attempts"][-1]
    assert done["result"]["device"] == "cpu"
    assert done["startup"]["process_seconds"] > 0
    merged = merged_losses(tmp_path / "run")
    assert sorted(merged) == list(range(18))   # the killed attempt's too
    for s, loss in merged.items():
        assert loss == ref_losses[s], (s, loss, ref_losses[s])
    probe = probe_restore(tmp_path / "ckpt", "llama3.2-3b", device="cpu")
    assert probe["step"] == 18 and not probe["fallback_units"]
    assert json.loads((tmp_path / "run/report.json").read_text())[
        "completed"]


def test_max_restarts_exceeded_raises(tmp_path):
    """A child that fails on its own at every attempt: the second
    unscheduled death past ``max_restarts=1`` raises."""
    sup = Supervisor(tmp_path / "ckpt", run_dir=tmp_path / "run",
                     arch="yi-9b", steps=4, interval=3, device="cpu",
                     max_restarts=1, attempt_timeout=120,
                     extra_args=["--fail-at", "2"])
    with pytest.raises(RuntimeError, match="exceed max_restarts=1"):
        sup.run()
    assert sorted(p.name for p in (tmp_path / "run").glob("attempt-*.log")) \
        == ["attempt-0.log", "attempt-1.log"]


def test_attempt_timeout_kills_the_child(tmp_path):
    sup = Supervisor(tmp_path / "ckpt", run_dir=tmp_path / "run",
                     arch="yi-9b", steps=1000, interval=500, device="cpu",
                     attempt_timeout=1.0)
    with pytest.raises(TimeoutError, match="attempt_timeout=1.0"):
        sup.run()
    mine = str(tmp_path / "ckpt")
    time.sleep(0.2)
    left = []
    for d in Path("/proc").iterdir():
        try:
            if d.name.isdigit() and mine in (d / "cmdline").read_text():
                left.append(d.name)
        except OSError:
            pass
    assert not left


@pytest.mark.parametrize("how", ["plan", "train", "cli"])
def test_more_than_one_participant_names_a4(tmp_path, how):
    """More than one save participant runs (ROADMAP A4.1): an elastic plan
    ``(2, 1)`` saves 2-wide, is killed, and resumes 1-wide from the
    sharded store; ``train(shard_participants=2)`` and the CLI's
    ``--shard-participants 2`` commit shard sets of two participants."""
    ckpt = tmp_path / "c"
    if how == "plan":
        report = Supervisor(
            ckpt, run_dir=tmp_path / "r", arch="yi-9b", steps=4,
            interval=2, participants=(2, 1), device="cpu",
            injections=[Injection("kill", at_step=3)],
            verify_restore=True, attempt_timeout=180).run()
        assert report["completed"] and report["participants_plan"] == [2, 1]
        assert [a["participants"] for a in report["attempts"]] == [2, 1]
        assert report["interruptions"][0]["committed_step"] == 2
        probe = report["interruptions"][0]["restore_probe"]
        assert probe["step"] == 2 and not probe["fallback_units"]
        m2 = ManifestStore(ckpt).load(2)
        assert m2.meta["sharded"]["n_participants"] == 2
        assert "sharded" not in ManifestStore(ckpt).load(4).meta
        return
    if how == "train":
        out = train(arch="yi-9b", total_steps=2, ckpt_interval=2,
                    batch=2, seq_len=16, device="cpu", ckpt_dir=str(ckpt),
                    shard_participants=2)
        assert out["shard_participants"] == 2
        assert out["save_events"][0]["participants"] == 2
    else:
        res = subprocess.run(
            _trainer_cmd(ckpt, "--steps", "2", "--ckpt-interval", "2",
                         "--shard-participants", "2"),
            env=_env(), capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr[-2000:]
        assert json.loads(res.stdout)["shard_participants"] == 2
    m = ManifestStore(ckpt).load()
    assert m.step == 2 and m.meta["sharded"] == {"n_participants": 2}
    assert all(len(e) == 2 for kinds in m.entries.values()
               for e in kinds.values())


def test_run_without_a_card_raises_before_any_launch(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sup = Supervisor(tmp_path / "c", run_dir=tmp_path / "r", steps=2,
                     interval=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sup.run()
    assert not list((tmp_path / "r").glob("attempt-*"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probe_restore(tmp_path / "c", "yi-9b")


def test_process_backend_kill_leaves_no_worker_or_segment(tmp_path):
    """A kill drill on the process IO backend: after the run no worker of
    the dead child is alive and none of its ``/dev/shm`` segments is left
    (the supervisor ends the child's process group and sweeps dead
    owners' segments after each death)."""
    sup = Supervisor(tmp_path / "ckpt", run_dir=tmp_path / "run",
                     arch="yi-9b", steps=6, interval=2, device="cpu",
                     io_backend="process", io_workers=2,
                     injections=[Injection("kill", at_step=3)],
                     attempt_timeout=180)
    report = sup.run()
    assert report["completed"]
    dead = report["attempts"][0]
    assert dead["exit_code"] == -signal.SIGKILL
    assert not _live_group_members(dead["pid"])
    assert not list(Path("/dev/shm").glob(f"repro-io-{dead['pid']:x}-*"))
    assert report["attempts"][1]["result"]["steps"] == 4


def test_cli_writes_and_prints_the_report(tmp_path):
    bench_before = set(ROOT.glob("BENCH_*.json"))
    cmd = [sys.executable, "-m", "repro_torch.launch.supervisor", "--device",
           "cpu", "--arch", "yi-9b", "--steps", "6", "--ckpt-interval", "2",
           "--ckpt-dir", str(tmp_path / "ckpt"), "--run-dir",
           str(tmp_path / "run"), "--inject", "crash:4:manifest_latest",
           "--scrub-on-restart", "--verify-restore",
           "--attempt-timeout", "180"]
    out = subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                         cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr
    printed = json.loads(out.stdout)
    assert printed == json.loads((tmp_path / "run/report.json").read_text())
    assert [a["exit_code"] for a in printed["attempts"]] == [43, 0]
    (crash,) = printed["interruptions"]
    assert crash["committed_step"] == 2 and crash["lost_steps"] == 2
    assert crash["restore_probe"]["step"] == 2
    assert not list(tmp_path.rglob("BENCH_*.json"))
    assert set(ROOT.glob("BENCH_*.json")) == bench_before
