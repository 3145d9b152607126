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
