"""The port's trainer on the CPU: fail and resume, and the CLI."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.devices import resolve_device
from repro_torch.launch.train import SimulatedFailure, train

# The suite runs in several worker processes at once: one intra-op
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

BASE = dict(arch="llama3.2-3b", total_steps=10, batch=2, seq_len=32,
            ckpt_interval=3, seed=11, lr=3e-3, device="cpu")
SRC = Path(__file__).resolve().parent.parent / "src"


def test_full_policy_resume_is_exact(tmp_path):
    ref = train(ckpt_dir=str(tmp_path / "ref"), policy_name="full", **BASE)
    with pytest.raises(SimulatedFailure) as e:
        train(ckpt_dir=str(tmp_path / "f"), policy_name="full", fail_at=8,
              **BASE)
    assert [s for s, _ in e.value.losses] == list(range(8))
    assert len(e.value.save_events) == 2
    res = train(ckpt_dir=str(tmp_path / "f"), policy_name="full",
                resume=True, **BASE)
    assert res["restore_stats"]["step"] == 6
    assert [s for s, _ in res["losses"]] == [6, 7, 8, 9]
    want = dict(ref["losses"])
    for step, loss in res["losses"]:
        assert loss == want[step], (step, loss, want[step])


@pytest.mark.parametrize("policy", ["parity", "interval"])
def test_selective_resume_recovers(tmp_path, policy):
    ref = train(ckpt_dir=str(tmp_path / "ref"), policy_name="full", **BASE)
    with pytest.raises(SimulatedFailure):
        train(ckpt_dir=str(tmp_path / policy), policy_name=policy,
              fail_at=8, **BASE)
    res = train(ckpt_dir=str(tmp_path / policy), policy_name=policy,
                resume=True, **BASE)
    # Frankenstein resume: the final loss stays in a band of the
    # uninterrupted run (the merge holds units one event stale).
    assert abs(res["final_loss"] - ref["final_loss"]) < 0.2


def test_device_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        train(ckpt_dir="/nonexistent", **{**BASE, "device": None})
    assert resolve_device("cpu") == torch.device("cpu")


def test_cli_runs_and_resumes(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device",
           "cpu", "--arch", "yi-9b", "--steps", "4", "--batch", "2",
           "--seq-len", "16", "--policy", "parity", "--ckpt-interval", "2",
           "--ckpt-dir", str(tmp_path / "run"), "--sync-save",
           "--num-layers", "2", "--log-csv", str(tmp_path / "l.csv")]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=300, check=True)
    r = json.loads(out.stdout)
    assert r["device"] == "cpu" and r["steps"] == 4
    assert len(r["save_events"]) == 2
    assert (tmp_path / "l.csv").read_text().count("\n") == 5
    out = subprocess.run(cmd[:-2] + ["--steps", "6", "--resume"],
                         capture_output=True, text=True, env=env,
                         timeout=300, check=True)
    r2 = json.loads(out.stdout)
    assert r2["restore_stats"]["step"] == 4 and r2["steps"] == 2


OV = dict(arch="yi-9b", num_layers=2, total_steps=8, batch=2, seq_len=16,
          seed=0, ckpt_interval=2, device="cpu")
# Resumed vs uninterrupted losses: the merge holds one block two warmup
# steps stale (as on the card, chip_smoke.LOSS_TOL).
LOSS_TOL = 0.02


def _signatures(root):
    from repro_torch.core.manifest import ManifestStore

    ms = ManifestStore(root)
    return {s: {(u, k): (r.digest, r.stored, r.delta_base)
                for u, kinds in ms.load(s).entries.items()
                for k, r in kinds.items()}
            for s in ms.all_steps()}


def test_overlapped_topk_delta_crash_mid_spread_and_resume(tmp_path):
    """Events begin at steps 2, 4 and 6; each begin force-finishes the one
    before.  A crash in the step-8 tick leaves event 6 uncommitted, so the
    step-4 manifest stays LATEST, and the resume trains on from it."""
    from repro_torch.checkpoint.faults import InjectedCrash

    kw = dict(OV, policy_name="topk_delta", ckpt_spread_steps=2)
    ref = train(ckpt_dir=str(tmp_path / "ref"),
                **{**kw, "ckpt_interval": 9})
    with pytest.raises(InjectedCrash):
        train(ckpt_dir=str(tmp_path / "run"), fail_at="7@spread_slice", **kw)
    assert (tmp_path / "run" / "LATEST").read_text() == "4"
    res = train(ckpt_dir=str(tmp_path / "run"), resume=True, **kw)
    assert res["restore_stats"]["step"] == 4
    assert [s for s, _ in res["losses"]] == [4, 5, 6, 7]
    want = dict(ref["losses"])
    for step, loss in res["losses"]:
        assert abs(loss - want[step]) < LOSS_TOL, (step, loss, want[step])
    assert res["save_mode"] == "overlapped"
    assert [e["step"] for e in res["save_events"]] == [6, 8]
    assert all(e["save_mode"] == "overlapped" for e in res["save_events"])
    # event 6 commits when event 8 begins, event 8 at the end of the run
    assert res["overlap_slices"] >= 2
    assert res["save_seconds"] == pytest.approx(res["stall_seconds"])
    for k in ("snapshot_seconds", "stage_seconds", "writeback_seconds",
              "overflow_redispatches"):
        assert k in res
    assert len(res["save_events"][0]["tick_step_seconds"]) == 2


@pytest.mark.parametrize("mode", ["sync_async_writer", "overlapped"])
def test_save_modes_commit_the_same_manifests(tmp_path, mode):
    """--sync-save (inline writes), the async writer and the overlapped
    saver commit identical manifests for the same run."""
    kw = dict(OV, policy_name="topk_delta", total_steps=6)
    train(ckpt_dir=str(tmp_path / "inline"), ckpt_async=False, **kw)
    other = dict(kw, ckpt_async=True,
                 ckpt_spread_steps=2 if mode == "overlapped" else 0)
    r = train(ckpt_dir=str(tmp_path / mode), **other)
    assert r["save_mode"] == ("overlapped" if mode == "overlapped"
                              else "sync")
    want = _signatures(tmp_path / "inline")
    assert sorted(want) == [2, 4, 6]
    assert _signatures(tmp_path / mode) == want


def test_armed_point_never_reached_fails_the_run(tmp_path):
    # the sync path never reaches the overlapped saver's crash point
    with pytest.raises(SimulatedFailure, match="never reached"):
        train(ckpt_dir=str(tmp_path / "run"), policy_name="parity",
              fail_at="3@snapshot_overlap", **{**OV, "total_steps": 4})


def test_cli_overlapped_flags(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device",
           "cpu", "--arch", "yi-9b", "--num-layers", "2", "--steps", "4",
           "--batch", "2", "--seq-len", "16", "--policy", "topk_delta",
           "--ckpt-interval", "2", "--ckpt-spread-steps", "2",
           "--writer-threads", "1", "--ckpt-dir", str(tmp_path / "run")]
    out = subprocess.run(cmd + ["--fail-at", "3@snapshot_overlap"],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode != 0 and "InjectedCrash" in out.stderr
    assert (tmp_path / "run" / "LATEST").read_text() == "2"
    out = subprocess.run(cmd + ["--steps", "6", "--resume"],
                         capture_output=True, text=True, env=env,
                         timeout=300, check=True)
    r = json.loads(out.stdout)
    assert r["restore_stats"]["step"] == 2 and r["steps"] == 4
    assert r["save_mode"] == "overlapped"
    assert [e["step"] for e in r["save_events"]] == [4, 6]
