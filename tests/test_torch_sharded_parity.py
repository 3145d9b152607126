"""Shard-native checkpoints of the port against the JAX package's on the
CPU: the same states saved by both packages' sharded checkpointers give
byte-equal stores (manifests, participant records before the commit's
sweep, every object) at N = 2, 4 and 8 on the fingerprint and canonical
paths with codecs ``none`` and ``int8``, and each store restores
bit-exactly in the other package; owned restores at another N read what
JAX's read, skip what JAX's skip and combine to the full restore; the
trainers save 4-wide, fail and resume 2-wide within 5e-3 of each other;
and the supervisors agree on an elastic plan ``2,1``.

The JAX side runs with ``repro.checkpoint.workers.HAVE_ZSTD`` patched to
False (as ``tests/test_torch_int8.py`` does) so its int8 records are not
compressed; states are the JAX package's initialization of the reduced
yi-9b, carried to the port through numpy, drifted with numpy.
"""
import shutil
from pathlib import Path

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.checkpoint.workers as jax_workers
from repro.checkpoint.saver import CheckpointManager as JaxManager
from repro.checkpoint.sharded import ShardCoordinator as JaxCoordinator
from repro.checkpoint.sharded import ShardedCheckpointer as JaxSharded
from repro.checkpoint.sharded import ShardedSaver as JaxSaver
from repro.checkpoint.sharded import combine_states as jax_combine
from repro.checkpoint.sharded import participant_wanted as jax_wanted
from repro.configs import get_config as jax_get_config
from repro.core import LayerRegistry as JaxRegistry
from repro.core.policies import make_policy as jax_make_policy
from repro.launch import steps as jax_steps
from repro.launch import supervisor as jax_sup
from repro.launch.train import SimulatedFailure as JaxSimulatedFailure
from repro.launch.train import train as jax_train
from repro.models import build_model as jax_build_model
from repro_torch.checkpoint.saver import CheckpointManager
from repro_torch.checkpoint.sharded import (ShardCoordinator,
                                            ShardedCheckpointer,
                                            ShardedSaver, combine_states,
                                            participant_wanted,
                                            record_dir)
from repro_torch.configs import get_config
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core.layer_registry import LayerRegistry
from repro_torch.core.manifest import ManifestStore, entry_refs, is_sharded
from repro_torch.core.policies import make_policy
from repro_torch.launch import steps
from repro_torch.launch import supervisor as port_sup
from repro_torch.launch.train import SimulatedFailure, train
from repro_torch.models import build_model

torch.set_num_threads(1)

ARCH = "yi-9b"
BB = 4096
CPU = torch.device("cpu")
BF16 = ml_dtypes.bfloat16


@pytest.fixture(autouse=True)
def _jax_without_zstd(monkeypatch):
    monkeypatch.setattr(jax_workers, "HAVE_ZSTD", False)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")


@pytest.fixture(scope="module")
def sides():
    jmodel = jax_build_model(jax_get_config(ARCH, reduced=True))
    pmodel = build_model(get_config(ARCH, reduced=True))
    s0 = jax.tree.map(np.asarray,
                      jax_steps.init_state(jmodel, jax.random.key(0)))
    return jmodel, pmodel, s0


def _drift(np_state, seed):
    """A copy with a few elements of one embedding row and of block_001's
    w_gate moved, in the weights, master and m."""
    rng = np.random.RandomState(seed)
    out = jax.tree.map(np.array, np_state)
    for tree in (out["params"], out["opt"]["master"], out["opt"]["m"]):
        w = tree["embed"]["w"]
        row = rng.randint(w.shape[0])
        w[row, :5] = (w[row, :5].astype(np.float32)
                      + rng.rand(5).astype(np.float32)).astype(w.dtype)
        g = tree["blocks"]["mlp"]["w_gate"]
        g[1, 3, :7] = (g[1, 3, :7].astype(np.float32) + 1).astype(g.dtype)
    return out


def _jax_mgr(root, jmodel, policy="parity", **kw):
    return JaxManager(root, JaxRegistry(jmodel),
                      jax_make_policy(policy, jmodel.layer_units()),
                      fp_block_bytes=BB, **kw)


def _port_mgr(root, pmodel, policy="parity", **kw):
    return CheckpointManager(root, LayerRegistry(pmodel),
                             make_policy(policy, pmodel.layer_units()),
                             fp_block_bytes=BB, **kw)


def _tree_bytes(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(Path(root).rglob("*")) if p.is_file()}


def _flat_np(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flat_np(tree[k], f"{prefix}{k}/")]
    return [(prefix, np.asarray(tree))]


def _assert_np_equal(a, b, parts=("params", "opt")):
    for part in parts:
        fa, fb = _flat_np(a[part]), _flat_np(b[part])
        assert [p for p, _ in fa] == [p for p, _ in fb]
        for (p, x), (_, y) in zip(fa, fb):
            assert x.dtype == y.dtype and np.array_equal(
                x.view(np.uint8), y.view(np.uint8)), p


def _jax_restore(root, jmodel, **kw):
    m = _jax_mgr(root, jmodel, async_save=False)
    try:
        out = m.restore(jax_steps.state_specs(jmodel), **kw)
        return jax.tree.map(np.asarray, out), dict(m.last_restore_stats)
    finally:
        m.close()


def _port_restore(root, pmodel, **kw):
    m = _port_mgr(root, pmodel, async_save=False)
    try:
        out = m.restore(steps.state_specs(pmodel), device=CPU, **kw)
        stats = dict(m.last_restore_stats)
        out = {k: v for k, v in out.items() if k != "step"}
        return state_to_numpy(out, BF16), stats
    finally:
        m.close()


CASES = [(n, path, codec) for n in (2, 4) for path in ("fp", "canonical")
         for codec in ("none", "int8")] + [(8, "fp", "none")]


@pytest.mark.parametrize("n,path,codec", CASES,
                         ids=[f"n{n}-{p}-{c}" for n, p, c in CASES])
def test_shard_stores_are_byte_identical(tmp_path, sides, n, path, codec):
    """Two events (every unit, then the parity half over a drift) by N
    participants in each package: the second event's participant records
    are byte-equal before the commit sweeps them, and so are the stores
    after it (manifests, LATEST, every object).  At N = 8 some
    participants own nothing of the 4-row leaves.  Each store restores in
    the other package to the other's restore, bit for bit (and, lossless,
    to the state)."""
    jmodel, pmodel, s0 = sides
    s1 = _drift(s0, 1)
    kw = dict(codec=codec, fingerprint=path == "fp", async_save=False)
    meta = {"note": "event"}
    records = {}
    for pkg in ("jax", "port"):
        root = tmp_path / pkg
        if pkg == "jax":
            mgr, ck_cls, saver_cls, coord = (
                _jax_mgr(root, jmodel, **kw), JaxSharded, JaxSaver,
                JaxCoordinator)
            states = (s0, s1)
        else:
            mgr, ck_cls, saver_cls, coord = (
                _port_mgr(root, pmodel, **kw), ShardedCheckpointer,
                ShardedSaver, ShardCoordinator)
            states = (state_from_numpy(s0, "cpu"),
                      state_from_numpy(s1, "cpu"))
        ck_cls(mgr, n).save(states[0], step=10, meta=meta)
        for pid in range(n):
            saver_cls(mgr, pid, n).save_shards(states[1], step=20,
                                               meta=meta)
        records[pkg] = _tree_bytes(record_dir(root, 20))
        assert len(records[pkg]) == n
        coord(mgr).commit(20, n)
        mgr.close()
    assert records["port"] == records["jax"]
    assert _tree_bytes(tmp_path / "port") == _tree_bytes(tmp_path / "jax")
    m = ManifestStore(tmp_path / "port").load(20)
    assert m.meta["sharded"] == {"n_participants": n}
    assert all(is_sharded(e) for kinds in m.entries.values()
               for e in kinds.values())
    if n == 8:  # block units' wo leaves have 4 rows: p4..p7 hold none
        paths = [{leaf["path"] for leaf in r.spec["leaves"]}
                 for kinds in m.entries.values() for e in kinds.values()
                 for r in e]
        assert any("attn/wo" not in p and "mlp/w_up" in p for p in paths)
    for writer in ("jax", "port"):
        want, _ = _jax_restore(tmp_path / writer, jmodel)
        got, _ = _port_restore(tmp_path / writer, pmodel)
        _assert_np_equal(got, want)
        if codec == "none":
            _assert_np_equal(got, s1)


def test_owned_restores_at_another_n_match_jax(tmp_path, sides):
    """A JAX store saved by 2 participants, restored by each of 4 in both
    packages: each port participant reads fewer bytes than the full
    restore and exactly JAX's, skips JAX's shard count, restores JAX's
    zero-filled state bit for bit, and the four combine to the full
    restore."""
    jmodel, pmodel, s0 = sides
    root = tmp_path / "store"
    mgr = _jax_mgr(root, jmodel, policy="full", codec="none",
                   async_save=False)
    JaxSharded(mgr, 2).save(s0, step=10)
    mgr.close()
    full, full_stats = _port_restore(root, pmodel)
    _, jfull_stats = _jax_restore(root, jmodel)
    assert full_stats["bytes_read"] == jfull_stats["bytes_read"]
    _assert_np_equal(full, s0)
    preg = LayerRegistry(pmodel)
    pm = _port_mgr(root, pmodel, async_save=False)
    results, wanteds = [], []
    for pid in range(4):
        want, jstats = _jax_restore(root, jmodel,
                                    owned=jax_wanted(JaxRegistry(jmodel),
                                                     pid, 4))
        wanted = participant_wanted(preg, pid, 4)
        res = pm.restore(steps.state_specs(pmodel), device=CPU,
                         owned=wanted)
        stats = pm.last_restore_stats
        assert stats["bytes_read"] < full_stats["bytes_read"]
        assert stats["bytes_read"] == jstats["bytes_read"]
        assert stats["shards_skipped"] == jstats["shards_skipped"] > 0
        assert stats["sharded_targets"] == jstats["sharded_targets"]
        _assert_np_equal(state_to_numpy(
            {k: v for k, v in res.items() if k != "step"}, BF16), want)
        results.append(res)
        wanteds.append(wanted)
    pm.close()
    combined = combine_states(steps.state_specs(pmodel), preg, results,
                              wanteds)
    _assert_np_equal(state_to_numpy(
        {k: v for k, v in combined.items() if k != "step"}, BF16), full)
    jcombined = jax_combine(jax_steps.state_specs(jmodel),
                            JaxRegistry(jmodel),
                            [jax.tree.map(np.asarray, w) for w in (
                                _jax_restore(root, jmodel,
                                             owned=jax_wanted(
                                                 JaxRegistry(jmodel), p,
                                                 4))[0]
                                for p in range(4))],
                            [jax_wanted(JaxRegistry(jmodel), p, 4)
                             for p in range(4)])
    _assert_np_equal(full, jcombined)


def _seed(root, jmodel, s0):
    m = _jax_mgr(root, jmodel, policy="full", codec="none",
                 async_save=False)
    m.save(s0, step=0)
    m.close()


def _shape(root, step):
    m = ManifestStore(root).load(step)
    return {u: {k: sorted((r.spec or {}).get("participant", -1)
                          for r in entry_refs(e))
                for k, e in kinds.items()}
            for u, kinds in m.entries.items()}


def test_trainers_save_4_wide_and_resume_2_wide(tmp_path, sides):
    """Both trainers from one JAX-written step-0 store: 4 participants,
    a save every 2 steps (parity), a failure at step 5, then the resume
    from the step-4 merge at 2 participants: losses within 5e-3 of JAX's,
    the same participants behind every entry at steps 2, 4 and 6, and the
    2-wide event's new shards full bases (another layout anchors none)."""
    jmodel, _, s0 = sides
    _seed(tmp_path / "jax", jmodel, s0)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    kw = dict(arch=ARCH, total_steps=6, batch=2, seq_len=32, seed=0,
              policy_name="parity", ckpt_interval=2, codec="none",
              lr=3e-3)
    with pytest.raises(JaxSimulatedFailure):
        jax_train(ckpt_dir=str(tmp_path / "jax"), resume=True, fail_at=5,
                  shard_participants=4, **kw)
    jres = jax_train(ckpt_dir=str(tmp_path / "jax"), resume=True,
                     shard_participants=2, **kw)
    with pytest.raises(SimulatedFailure) as e:
        train(ckpt_dir=str(tmp_path / "port"), resume=True, fail_at=5,
              shard_participants=4, device="cpu", **kw)
    assert [ev["participants"] for ev in e.value.save_events] == [4, 4]
    res = train(ckpt_dir=str(tmp_path / "port"), resume=True,
                shard_participants=2, device="cpu", **kw)
    assert res["shard_participants"] == jres["shard_participants"] == 2
    assert res["restore_stats"]["step"] == 4
    want = dict(jres["losses"])
    assert [s for s, _ in res["losses"]] == [4, 5]
    for step, loss in res["losses"]:
        assert abs(loss - want[step]) < 5e-3, (step, loss, want[step])
    for step in (2, 4, 6):
        assert _shape(tmp_path / "port", step) == \
            _shape(tmp_path / "jax", step), step
    m6 = ManifestStore(tmp_path / "port").load(6)
    for u in m6.saved_units:
        for e in m6.entries[u].values():
            assert [r.spec["participant"] for r in e] == [0, 1]
            assert all(r.stored == "full" and r.step == 6 for r in e)


def test_supervisors_agree_on_an_elastic_plan(tmp_path, sides):
    """Both supervisors from one JAX-written step-0 store with the plan
    ``2,1``: a crash at step 4's LATEST flip in the 2-wide attempt, the
    1-wide attempt finishing 6 steps: equal report fields, merged losses
    within 5e-3, and the same participants behind every entry at steps 2
    and 6."""
    jmodel, _, s0 = sides
    _seed(tmp_path / "seed", jmodel, s0)
    reports = {}
    for name, mod in (("jax", jax_sup), ("port", port_sup)):
        shutil.copytree(tmp_path / "seed", tmp_path / name / "ckpt")
        kw = dict(run_dir=tmp_path / name / "run", arch=ARCH, steps=6,
                  interval=2, batch=2, seq_len=16, policy="full",
                  participants=(2, 1),
                  injections=[mod.Injection("crash", at_step=4,
                                            crash_point="manifest_latest")],
                  verify_restore=True, attempt_timeout=240,
                  extra_args=["--codec", "none"])
        if mod is port_sup:
            kw["device"] = "cpu"
        reports[name] = mod.Supervisor(tmp_path / name / "ckpt", **kw).run()
    jr, pr = reports["jax"], reports["port"]
    for key in ("completed", "n_interruptions", "lost_steps_total",
                "step_executions", "goodput_steps", "participants_plan"):
        assert pr[key] == jr[key], key
    for key in ("participants", "exit_code", "steps_executed",
                "reached_step"):
        assert [a[key] for a in pr["attempts"]] == \
            [a[key] for a in jr["attempts"]], key
    assert [a["participants"] for a in pr["attempts"]] == [2, 1]
    (ji,), (pi,) = jr["interruptions"], pr["interruptions"]
    for key in ("kind", "exit_code", "reached_step", "committed_step",
                "lost_steps"):
        assert pi[key] == ji[key], key
    for key in ("step", "parts", "bytes_read", "fallback_units"):
        assert pi["restore_probe"][key] == ji["restore_probe"][key], key
    jl = jax_sup.merged_losses(tmp_path / "jax" / "run")
    pl = port_sup.merged_losses(tmp_path / "port" / "run")
    for s in jl:
        assert abs(pl[s] - jl[s]) < 5e-3, (s, pl[s], jl[s])
    for step in (2, 6):
        assert _shape(tmp_path / "port" / "ckpt", step) == \
            _shape(tmp_path / "jax" / "ckpt", step), step


def test_spread_steps_with_participants_raise_in_both(tmp_path):
    """The overlapped saver takes one participant: ``--ckpt-spread-steps``
    with ``--shard-participants`` above 1 raises ``ValueError`` in both
    trainers, the port's before it opens the store."""
    kw = dict(arch=ARCH, total_steps=2, batch=2, seq_len=16,
              ckpt_interval=2, ckpt_spread_steps=2, shard_participants=2)
    with pytest.raises(ValueError, match="incompatible"):
        jax_train(ckpt_dir=str(tmp_path / "jax"), **kw)
    with pytest.raises(ValueError, match="incompatible"):
        train(ckpt_dir=str(tmp_path / "port"), device="cpu", **kw)
    assert not (tmp_path / "port").exists()
