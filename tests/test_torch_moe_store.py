"""The MoE family through the port's checkpoint stack and entry points,
against the JAX package on the CPU (reduced DeepSeek-V2-Lite: the first
block unit, ``block_000``, is the unstacked ``dense_first_0`` with no
index, the first such block unit any port path has seen; the others are
stacked MoE blocks with MLA).

- Stores: four events (initial, unchanged, perturbed, unchanged) under
  ``full`` and ``parity`` give equal manifests and byte-identical objects
  in both packages, unsharded and saved by 4 virtual participants
  (``ShardedCheckpointer``); each store restores bit for bit in the
  other package.
- Entry points: the trainer CLI saves every 2 steps, fails at step 5 and
  resumes from step 4 with the uninterrupted run's losses, 4-wide and
  resumed 2-wide (``--shard-participants``); the server cold-loads step 4,
  hot-swaps to 6 and generates the tokens of a server cold-loaded at 6.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.checkpoint.workers as jax_workers
from repro.checkpoint.saver import CheckpointManager as JaxManager
from repro.checkpoint.sharded import ShardedCheckpointer as JaxSharded
from repro.configs import get_config as jax_get_config
from repro.core import LayerRegistry as JaxRegistry
from repro.core.policies import make_policy as jax_make_policy
from repro.launch import steps as jax_steps
from repro.models import build_model as jax_build_model
from repro_torch.checkpoint.saver import CheckpointManager
from repro_torch.checkpoint.serial import flatten_with_paths
from repro_torch.checkpoint.sharded import ShardedCheckpointer
from repro_torch.configs import get_config
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core.layer_registry import LayerRegistry
from repro_torch.core.manifest import ManifestStore, is_sharded
from repro_torch.core.policies import make_policy
from repro_torch.launch import steps
from repro_torch.launch.serve import serve
from repro_torch.launch.train import SimulatedFailure, train
from repro_torch.models import build_model

torch.set_num_threads(1)

ARCH = "deepseek-v2-lite-16b"
ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
BB = 4096
BF16 = ml_dtypes.bfloat16


@pytest.fixture(autouse=True)
def _jax_without_zstd(monkeypatch):
    monkeypatch.setattr(jax_workers, "HAVE_ZSTD", False)


@pytest.fixture(scope="module")
def pair():
    jm = jax_build_model(jax_get_config(ARCH, reduced=True))
    pm = build_model(get_config(ARCH, reduced=True))
    st = jax.tree.map(np.asarray, jax_steps.init_state(jm,
                                                       jax.random.key(0)))
    return jm, pm, st


def _perturb(np_state):
    """A copy with a few elements of the unstacked first block's MLA
    query projection and of block_002's expert weights changed."""
    out = jax.tree.map(np.array, np_state)
    for tree in (out["params"], out["opt"]["master"], out["opt"]["m"]):
        for w in (tree["dense_first_0"]["attn"]["wq"],
                  tree["blocks"]["moe"]["we_up"][1]):
            w.flat[:3] = (w.flat[:3].astype(np.float32) + 0.5).astype(w.dtype)
    return out


def _entries(mgr, step):
    m = mgr.manifests.load(step)
    return {u: {k: (tuple((r.digest, r.stored, r.delta_base, r.nbytes)
                          for r in v) if isinstance(v, list) else
                    (v.digest, v.stored, v.delta_base, v.nbytes, v.step))
                for k, v in kinds.items()}
            for u, kinds in m.entries.items()}


def _tree_bytes(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(Path(root).rglob("*")) if p.is_file()}


def _jax_mgr(root, jm, policy):
    return JaxManager(root, JaxRegistry(jm),
                      jax_make_policy(policy, jm.layer_units()),
                      codec="none", async_save=False, fp_block_bytes=BB)


def _port_mgr(root, pm, policy):
    return CheckpointManager(root, LayerRegistry(pm),
                             make_policy(policy, pm.layer_units()),
                             async_save=False, fp_block_bytes=BB)


def _state_bytes(tree):
    return [(p, a.dtype, a.shape, a.tobytes())
            for p, a in flatten_with_paths(tree)]


@pytest.mark.parametrize("participants", [1, 4])
@pytest.mark.parametrize("policy", ["full", "parity"])
def test_same_state_same_store(tmp_path, pair, policy, participants):
    """Four events saved by both packages (by 4 virtual participants
    each, or unsharded): byte-identical stores; ``block_000`` saved whole
    (and as 4 shards), its weights a delta after the perturbation under
    ``full``; each store restores bit for bit in the other package."""
    jm, pm, st = pair
    s1 = _perturb(st)
    states = ((1, st), (2, st), (3, s1), (4, s1))
    for pkg in ("jax", "port"):
        root = tmp_path / pkg
        if pkg == "jax":
            mgr = _jax_mgr(root, jm, policy)
            conv = lambda s: s  # noqa: E731
            sharded = JaxSharded(mgr, participants)
        else:
            mgr = _port_mgr(root, pm, policy)
            conv = lambda s: state_from_numpy(s, "cpu")  # noqa: E731
            sharded = ShardedCheckpointer(mgr, participants)
        for step, s in states:
            if participants == 1:
                mgr.save(conv(s), step=step)
            else:
                sharded.save(conv(s), step=step)
        mgr.close()
    assert _tree_bytes(tmp_path / "port") == _tree_bytes(tmp_path / "jax")
    m1 = ManifestStore(tmp_path / "port").load(1)
    assert sorted(m1.entries["block_000"]) == ["opt", "weights"]
    if participants > 1:
        assert all(is_sharded(e) for kinds in m1.entries.values()
                   for e in kinds.values())
        assert len(m1.entries["block_001"]["opt"]) == participants
    elif policy == "full":
        m3 = ManifestStore(tmp_path / "port").load(3)
        assert m3.entries["block_000"]["weights"].stored == "delta"
    for writer in ("jax", "port"):
        jmgr = _jax_mgr(tmp_path / writer, jm, policy)
        want = jax.tree.map(np.asarray,
                            jmgr.restore(jax_steps.state_specs(jm)))
        jmgr.close()
        pmgr = _port_mgr(tmp_path / writer, pm, policy)
        got = pmgr.restore(steps.state_specs(pm), device=CPU)
        pmgr.close()
        assert int(got["step"]) == int(want["step"]) == 4
        got_np = state_to_numpy({"params": got["params"],
                                 "opt": got["opt"]}, bf16_dtype=BF16)
        assert _state_bytes(got_np) == _state_bytes(
            {"params": want["params"], "opt": want["opt"]})
        if policy == "full":
            assert _state_bytes(got_np) == _state_bytes(
                {"params": s1["params"], "opt": s1["opt"]})


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", *args], capture_output=True,
                         text=True, env=env, timeout=400)
    return out


def test_train_cli_fails_resumes_and_serve_cli_hot_swaps(tmp_path):
    """The trainer CLI on the reduced DeepSeek-V2-Lite: ``full`` sync
    saves every 2 steps by 4 participants, an injected failure at step 5,
    the resume from step 4 by 2 participants repeating the uninterrupted
    run's losses within 1e-4 (the aux loss recorded, positive); then the
    server CLI cold-loads step 4, hot-swaps to 6 and generates the tokens
    of a server cold-loaded at 6."""
    kw = dict(arch=ARCH, total_steps=6, batch=2, seq_len=24, seed=0,
              ckpt_interval=7, device="cpu", policy_name="full",
              ckpt_async=False, ckpt_dir=str(tmp_path / "ref"))
    ref = train(**kw)
    assert [s for s, _ in ref["aux_losses"]] == list(range(6))
    assert all(0 < a < 1 for _, a in ref["aux_losses"])
    run = str(tmp_path / "run")
    base = ["repro_torch.launch.train", "--device", "cpu", "--arch", ARCH,
            "--steps", "6", "--batch", "2", "--seq-len", "24", "--policy",
            "full", "--ckpt-interval", "2", "--ckpt-dir", run,
            "--sync-save"]
    failed = _cli(*base, "--shard-participants", "4", "--fail-at", "5")
    assert failed.returncode != 0
    assert "injected failure at step 5" in failed.stdout + failed.stderr
    assert ManifestStore(Path(run)).latest_step() == 4
    resumed = _cli(*base, "--shard-participants", "2", "--resume")
    assert resumed.returncode == 0, resumed.stderr[-3000:]
    res = json.loads(resumed.stdout[resumed.stdout.index("{"):])
    assert res["restore_stats"]["step"] == 4
    assert abs(res["final_loss"] - ref["losses"][-1][1]) < 1e-4
    m6 = ManifestStore(Path(run)).load(6)
    assert m6.meta["sharded"] == {"n_participants": 2}
    skw = ["repro_torch.launch.serve", "--device", "cpu", "--arch", ARCH,
           "--batch", "2", "--prompt-len", "9", "--new-tokens", "3",
           "--from-ckpt", run]
    hot = _cli(*skw, "--from-step", "4", "--hot-swap")
    cold = _cli(*skw)
    assert hot.returncode == 0 and cold.returncode == 0, hot.stderr[-3000:]
    hot, cold = (json.loads(o.stdout[o.stdout.index("{"):])
                 for o in (hot, cold))
    assert hot["restore"]["step"] == 4 and hot["swap"]["step_to"] == 6
    assert hot["served_step"] == cold["served_step"] == 6
    assert hot["tokens_digest"] == cold["tokens_digest"]


def test_train_fail_resume_repeats_the_losses(tmp_path):
    """``train()`` with ``parity`` saves (a merge of two events at step 4:
    ``block_000`` and the stacked MoE blocks alternate), a failure at 5
    and the resume: the resumed losses equal the uninterrupted run's
    within 0.02 (one event's units are one step stale), the restore reads
    the unstacked unit."""
    kw = dict(arch=ARCH, total_steps=6, batch=2, seq_len=24, seed=0,
              device="cpu", policy_name="parity", ckpt_async=False)
    ref = train(ckpt_dir=str(tmp_path / "ref"), ckpt_interval=7, **kw)
    with pytest.raises(SimulatedFailure) as e:
        train(ckpt_dir=str(tmp_path / "run"), ckpt_interval=2, fail_at=5,
              **kw)
    assert [ev["step"] for ev in e.value.save_events] == [2, 4]
    res = train(ckpt_dir=str(tmp_path / "run"), ckpt_interval=2,
                resume=True, **kw)
    assert res["restore_stats"]["step"] == 4
    m4 = ManifestStore(tmp_path / "run").load(4)
    assert {r.step for r in m4.entries["block_000"].values()} <= {2, 4}
    assert {r.step for kinds in m4.entries.values()
            for r in kinds.values()} == {2, 4}
    want = dict(ref["losses"])
    for step, loss in res["losses"]:
        assert abs(loss - want[step]) < 0.02, step


def test_serve_random_weights_end_to_end():
    kw = dict(arch=ARCH, batch=2, prompt_len=33, new_tokens=4, seed=0,
              device="cpu")
    r1, r2 = serve(**kw), serve(**kw)
    assert r1["tokens_digest"] == r2["tokens_digest"]
    assert len(r1["sample_tokens"]) == 4
    assert all(0 <= t < 512 for t in r1["sample_tokens"])
