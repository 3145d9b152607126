"""The port's failure surface against the JAX package's, on the CPU: the
trainers' crash exit and progress feed on the same flags, their
preemption saves, the two supervisors on one crash drill from one
JAX-written store, the restorability probe on stores of either package,
and the feed and loss readers on the same files."""
import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.saver import CheckpointManager as JaxManager
from repro.configs import get_config as jax_get_config
from repro.core import LayerRegistry as JaxRegistry
from repro.core import make_policy as jax_make_policy
from repro.launch import steps as jax_steps
from repro.launch import supervisor as jax_sup
from repro.launch.elastic import probe_restore as jax_probe_restore
from repro.launch.train import train as jax_train
from repro.models import build_model as jax_build_model
from repro_torch.core.manifest import ManifestStore
from repro_torch.launch import supervisor as port_sup
from repro_torch.launch.elastic import probe_restore
from repro_torch.launch.train import train

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
ARCH = "yi-9b"


@pytest.fixture(autouse=True)
def _cpu_children(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")


def _env():
    return dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
                JAX_PLATFORMS="cpu")


def _cmd(package, ckpt, feed, *extra):
    """The same trainer flags for both packages (codec none: the JAX
    package's ``auto`` is zstd); the port's child asks for the CPU."""
    cmd = [sys.executable, "-m", f"{package}.launch.train", "--arch", ARCH,
           "--batch", "2", "--seq-len", "16", "--codec", "none",
           "--ckpt-dir", str(ckpt), "--progress-file", str(feed), *extra]
    return cmd + (["--device", "cpu"] if package == "repro_torch" else [])


def _kinds(feed):
    return [(k, s) for k, s, _ in port_sup._read_progress(feed)]


def _entries(root, step):
    m = ManifestStore(root).load(step)
    return {u: {k: (r.stored, r.step) for k, r in kinds.items()}
            for u, kinds in m.entries.items()}


def _seed_store(root):
    """A store holding the JAX-initialized state at step 0 (codec none)."""
    model = jax_build_model(jax_get_config(ARCH, reduced=True))
    m = JaxManager(root, JaxRegistry(model),
                   jax_make_policy("full", model.layer_units()),
                   codec="none", async_save=False)
    m.save(jax.tree.map(np.asarray,
                        jax_steps.init_state(model, jax.random.key(0))),
           step=0)
    m.close()


def test_crash_exit_and_progress_match_jax(tmp_path):
    """``--fail-at 4@manifest_latest --fail-mode exit`` in each package's
    trainer: both exit 43 with LATEST at 2 and manifest 4 on disk (the
    torn commit), both feeds hold the same kinds and steps, and a resume
    of each starts at 2."""
    feeds = {}
    for pkg in ("repro", "repro_torch"):
        ckpt, feed = tmp_path / pkg, tmp_path / f"{pkg}.log"
        flags = ("--steps", "6", "--policy", "full", "--ckpt-interval", "2")
        out = subprocess.run(
            _cmd(pkg, ckpt, feed, *flags, "--fail-at", "4@manifest_latest",
                 "--fail-mode", "exit"), env=_env(), capture_output=True,
            text=True, timeout=180)
        assert out.returncode == 43, (pkg, out.stderr[-2000:])
        assert ManifestStore(ckpt).latest_step() == 2
        assert (ckpt / "manifests" / "manifest-00000004.json").is_file()
        feeds[pkg] = _kinds(feed)
        out = subprocess.run(
            _cmd(pkg, ckpt, tmp_path / f"{pkg}-resume.log", *flags,
                 "--resume"), env=_env(), capture_output=True, text=True,
            timeout=180)
        assert out.returncode == 0, (pkg, out.stderr[-2000:])
        assert json.loads(out.stdout)["steps"] == 4
        assert _kinds(tmp_path / f"{pkg}-resume.log") == [
            ("start", 2), ("step", 3), ("step", 4), ("ckpt", 4),
            ("step", 5), ("step", 6), ("ckpt", 6), ("done", 6)]
    assert feeds["repro_torch"] == feeds["repro"]
    assert feeds["repro"][-1] == ("step", 4)


def _preempt(pkg, tmp_path, at_step=3):
    ckpt, feed = tmp_path / pkg, tmp_path / f"{pkg}.log"
    proc = subprocess.Popen(
        _cmd(pkg, ckpt, feed, "--steps", "12", "--policy", "parity",
             "--ckpt-interval", "5", "--handle-sigterm"),
        env=_env(), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    try:
        deadline = time.time() + 180
        while not any(k == "step" and s >= at_step
                      for k, s in _kinds(feed)):
            assert proc.poll() is None and time.time() < deadline, pkg
            time.sleep(0.02)
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=180)
    finally:
        proc.kill()
    assert proc.returncode == 17, (pkg, err[-2000:])
    kinds = _kinds(feed)
    (r,) = {s for k, s in kinds if k == "preempt"}
    assert kinds[-2:] == [("preempt", r), ("preempt_durable", r)]
    ms = ManifestStore(ckpt)
    assert ms.latest_step() == r
    m = ms.load(r)
    return r, m.saved_units, {u: sorted(k) for u, k in m.entries.items()}


def test_preemption_save_matches_jax(tmp_path):
    """SIGTERM at step 3 (parity policy, a save every 5 steps): both
    trainers exit 17 after ``preempt,r`` and ``preempt_durable,r`` with a
    manifest at r holding every unit, the same units and kinds."""
    jr, junits, jkinds = _preempt("repro", tmp_path)
    pr, punits, pkinds = _preempt("repro_torch", tmp_path)
    assert jr >= 3 and pr >= 3
    assert punits == junits and pkinds == jkinds
    assert sorted(punits) == sorted(pkinds)


def test_supervisors_agree_on_a_crash_drill(tmp_path):
    """Both supervisors from one JAX-written step-0 store, one crash at
    step 4's LATEST flip, 6 steps, a save every 2, scrub between
    attempts: equal report fields, merged losses within 5e-3, and the
    manifests at 2, 4 and 6 holding the same units, kinds and formats."""
    _seed_store(tmp_path / "seed")
    reports = {}
    for name, mod in (("jax", jax_sup), ("port", port_sup)):
        shutil.copytree(tmp_path / "seed", tmp_path / name / "ckpt")
        kw = dict(run_dir=tmp_path / name / "run", arch=ARCH, steps=6,
                  interval=2, batch=2, seq_len=16, policy="full",
                  injections=[mod.Injection("crash", at_step=4,
                                            crash_point="manifest_latest")],
                  scrub_on_restart=True, attempt_timeout=240,
                  extra_args=["--codec", "none"])
        if mod is port_sup:
            kw["device"] = "cpu"
        reports[name] = mod.Supervisor(tmp_path / name / "ckpt", **kw).run()
    jr, pr = reports["jax"], reports["port"]
    for key in ("completed", "n_interruptions", "lost_steps_total",
                "step_executions", "goodput_steps", "scrubs_run",
                "scrub_repaired_total", "scrub_unrecoverable_total"):
        assert pr[key] == jr[key], key
    for key in ("exit_code", "steps_executed", "reached_step"):
        assert [a[key] for a in pr["attempts"]] == \
            [a[key] for a in jr["attempts"]], key
    assert [a["exit_code"] for a in pr["attempts"]] == [43, 0]
    (ji,), (pi,) = jr["interruptions"], pr["interruptions"]
    for key in ("kind", "exit_code", "preempted", "reached_step",
                "committed_step", "lost_steps"):
        assert pi[key] == ji[key], key
    assert pi["committed_step"] == 2 and pi["lost_steps"] == 2
    assert {k: v for k, v in pi["scrub"].items() if k != "seconds"} == \
        ji["scrub"]
    jl = jax_sup.merged_losses(tmp_path / "jax" / "run")
    pl = port_sup.merged_losses(tmp_path / "port" / "run")
    # the JAX trainer writes its loss file at the run's end, the port's
    # a line a step: only the port's crashed attempt left its steps
    assert sorted(jl) == [2, 3, 4, 5] and sorted(pl) == list(range(6))
    for s in jl:
        assert abs(pl[s] - jl[s]) < 5e-3, (s, pl[s], jl[s])
    for step in (2, 4, 6):
        assert _entries(tmp_path / "port" / "ckpt", step) == \
            _entries(tmp_path / "jax" / "ckpt", step), step


def _jax_store(root):
    jax_train(arch=ARCH, total_steps=4, batch=2, seq_len=16,
              policy_name="parity", ckpt_interval=2, ckpt_dir=str(root),
              codec="none", seed=0)


def _port_store(root):
    train(arch=ARCH, total_steps=4, batch=2, seq_len=16,
          policy_name="parity", ckpt_interval=2, ckpt_dir=str(root),
          codec="none", seed=0, device="cpu")


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("lose_an_object", [False, True])
def test_probe_restore_matches_jax(tmp_path, writer, lose_an_object):
    """``probe_restore`` (weights only) on a store either package wrote,
    whole or with step 4's block_001 weights object gone (the unit falls
    back to step 2): JAX's step, parts, bytes read and fallback units."""
    root = tmp_path / "run"
    (_jax_store if writer == "jax" else _port_store)(root)
    if lose_an_object:
        ref = ManifestStore(root).load(4).entries["block_001"]["weights"]
        assert ref.step == 4
        (root / ref.relpath).unlink()
    want = jax_probe_restore(root, ARCH)
    got = probe_restore(root, ARCH, device="cpu")
    for key in ("step", "parts", "bytes_read", "fallback_units"):
        assert got[key] == want[key], key
    assert got["step"] == 4
    assert bool(got["fallback_units"]) == lose_an_object


def test_feed_and_loss_readers_match_jax(tmp_path):
    feed = tmp_path / "progress.log"
    feed.write_text("start,0,1.5\nstep,1,2.25\nckpt,1,2.5\nbogus\n"
                    "step,x,3.0\nstep,2,3.5\nstep,3,4.")
    assert port_sup._read_progress(feed) == jax_sup._read_progress(feed)
    torn = tmp_path / "torn.log"
    torn.write_text("start,0,1.0\nstep,1,2.0\nste")
    assert port_sup._read_progress(torn) == jax_sup._read_progress(torn) \
        == [("start", 0, 1.0), ("step", 1, 2.0)]
    assert port_sup._read_progress(tmp_path / "none.log") == []
    run = tmp_path / "run"
    run.mkdir()
    (run / "losses-0.csv").write_text("step,loss\n0,5.5\n1,5.25\n2,5.0\n")
    (run / "losses-10.csv").write_text("step,loss\n2,4.75\n3,4.5\n")
    (run / "losses-2.csv").write_text("step,loss\n2,4.0\n")
    assert port_sup.merged_losses(run) == jax_sup.merged_losses(run) == {
        0: 5.5, 1: 5.25, 2: 4.75, 3: 4.5}
