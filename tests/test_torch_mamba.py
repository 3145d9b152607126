"""The port's Mamba2 LM (ssm family, mamba2-370m reduced) against the JAX
package: structure and groups, loss and logits, prefill and its cache,
decode, a 5-step training trajectory, the checkpoint store written by both
packages, the hot-swap on a JAX-written store, and the trainer and server
end to end on the CPU.

JAX-initialized params reach the port through numpy
(``repro_torch.convert``).  Tolerances (bf16 activations, float32 state,
statistics and logits; the port takes ``exp(A_log)`` in float32 where the
JAX model rounds it to bf16): logits within 0.02, loss within 2e-3, the
decode state within 0.02 and the bf16 conv window within 0.05 (a few bf16
ulps of its inputs); every step of a decode teacher-forced on JAX's tokens
within 0.06, the bound of ``tests/test_models_consistency.py``, which also
bounds one port decode step against the port's prefill of the longer
prompt (5 chained steps: 0.1); over 5 train steps every loss within 5e-3
and every global grad norm within 1% of the JAX trajectory.  Everything
checkpointed is compared byte for byte.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.saver import CheckpointManager as JaxManager
from repro.checkpoint.swap import WeightService as JaxWeightService
from repro.configs import get_config as jax_get_config
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core import LayerRegistry as JaxRegistry
from repro.core.policies import make_policy as jax_make_policy
from repro.data.synthetic import SyntheticTokens
from repro.launch import steps as jax_steps
from repro.models import build_model as jax_build_model
from repro.optim.groups import build_group_spec as jax_group_spec
from repro.optim.groups import decay_mask as jax_decay_mask
from repro_torch.checkpoint.saver import CheckpointManager
from repro_torch.checkpoint.serial import flatten_with_paths
from repro_torch.checkpoint.swap import WeightService
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core.layer_registry import LayerRegistry
from repro_torch.core.policies import make_policy
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch import steps
from repro_torch.launch.serve import serve
from repro_torch.launch.train import SimulatedFailure, train
from repro_torch.models import build_model
from repro_torch.optim import build_group_spec, decay_mask

torch.set_num_threads(1)

ARCH = "mamba2-370m"
CPU = torch.device("cpu")
BB = 4096       # fingerprint block bytes: A_log (32 B a layer) is one block
T, B = 40, 2
SWAP_COUNTS = ("units_swapped", "units_skipped", "units_scattered",
               "units_full", "blocks_applied", "step_from", "step_to")


@pytest.fixture(scope="module")
def pair():
    jm = jax_build_model(jax_get_config(ARCH, reduced=True))
    pm = build_model(get_config(ARCH, reduced=True))
    st = jax.tree.map(np.asarray, jax_steps.init_state(jm,
                                                       jax.random.key(0)))
    return jm, pm, st


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def _jax_logits(jm, params, tokens):
    """The JAX model's full-sequence logits (its loss path, unscanned)."""
    h = jnp.take(params["embed"]["w"].astype(jnp.bfloat16), tokens, axis=0)
    for i in range(jm.cfg.num_layers):
        h, _ = jm._block(jax.tree.map(lambda x: x[i], params["blocks"]), h)
    return jm._logits(params, h)


def test_structure_matches(pair):
    jm, pm, st = pair
    jflat = [(p, tuple(a.shape)) for p, a in flatten_with_paths(st["params"])]
    pflat = [(p, tuple(s.shape))
             for p, s in flatten_with_paths(pm.param_specs())]
    assert pflat == jflat
    units = [(u.name, u.path, u.index, u.kind) for u in pm.layer_units()]
    assert units == [(u.name, u.path, u.index, u.kind)
                     for u in jm.layer_units()]
    assert units[0][0] == "embed" and units[-1][0] == "final_norm"
    pg = build_group_spec(pm, weight_decay=0.1).groups
    jg = jax_group_spec(jm, weight_decay=0.1).groups
    assert [(g.index, g.unit, g.decay, g.paths, g.weight_decay) for g in pg] \
        == [(g.index, g.unit, g.decay, g.paths, g.weight_decay) for g in jg]
    # 2L + x: each block one no-decay group (6 leaves) and one decay group
    # (7 leaves); the tied embed and the final norm one group each
    n = pm.cfg.num_layers
    assert len(pg) == 2 * n + 2
    assert [len(g.paths) for g in pg[:n]] == [6] * n
    assert [len(g.paths) for g in pg[-n:]] == [7] * n
    assert flatten_with_paths(decay_mask(pm)) == [
        (p, bool(v)) for p, v in flatten_with_paths(jax_decay_mask(jm))]


def test_full_size_param_count():
    """368,338,432 params: 48 blocks x 6,601,056 + the tied embed
    51,486,720 + the final norm 1,024."""
    specs = build_model(get_config(ARCH)).param_specs()
    sizes = {p: int(np.prod(s.shape)) for p, s in flatten_with_paths(specs)}
    assert sum(sizes.values()) == 368_338_432
    assert sizes["embed/w"] == 51_486_720 and "lm_head/w" not in sizes
    block = sum(v for p, v in sizes.items() if p.startswith("blocks/"))
    assert block == 48 * 6_601_056


def test_init_follows_the_jax_rules():
    """Deterministic leaves equal the JAX init (A_log within one float32
    ulp: the two log implementations round differently); random ones have
    its truncated-normal scale; bf16 init is the float32 init rounded."""
    cfg = get_config(ARCH, reduced=True)
    pm = build_model(cfg)
    jp = jax.tree.map(np.asarray, jax_build_model(jax_get_config(
        ARCH, reduced=True)).init(jax.random.key(0)))
    f32 = pm.init(3, CPU)
    mx = f32["blocks"]["mixer"]
    for name in ("D_skip", "dt_bias", "conv_b", "out_norm"):
        np.testing.assert_array_equal(mx[name].numpy(),
                                      jp["blocks"]["mixer"][name])
    np.testing.assert_allclose(mx["A_log"].numpy(),
                               jp["blocks"]["mixer"]["A_log"], rtol=2e-7,
                               atol=0)
    for name, scale in (("w_x", 1 / np.sqrt(cfg.d_model)), ("conv_w", 0.2)):
        x = mx[name].numpy()
        assert np.abs(x).max() <= 2 * scale + 1e-6
        assert 0.7 * scale < x.std() < 1.0 * scale
    bf = pm.init(3, CPU, dtype=torch.bfloat16)
    for (p, a), (_, b) in zip(flatten_with_paths(f32),
                              flatten_with_paths(bf)):
        assert torch.equal(a.to(torch.bfloat16), b), p


def test_logits_and_loss_match(pair):
    jm, pm, st = pair
    batch = SyntheticTokens(vocab_size=512, batch=2, seq_len=64,
                            seed=1).peek(0)
    params = jax.tree.map(jnp.asarray, st["params"])
    jlogits = np.asarray(_jax_logits(jm, params, batch["tokens"]))
    jloss = float(jm.loss(params, batch)[0])
    pst = state_from_numpy(st, "cpu")
    tokens = torch.from_numpy(batch["tokens"])
    with torch.no_grad():
        plogits = pm.logits(pst["params"], tokens).numpy()
        ploss = float(pm.loss(pst["params"], {"tokens": tokens})[0])
    assert plogits.dtype == np.float32
    np.testing.assert_allclose(plogits, jlogits, rtol=0, atol=0.02)
    assert abs(ploss - jloss) < 2e-3


def test_prefill_cache_and_decode_track_jax(pair):
    """Prefill logits and the cache (state, conv window), then 5 decode
    steps teacher-forced on JAX's greedy tokens."""
    jm, pm, st = pair
    jp = jax.tree.map(jnp.asarray, st["params"])
    pp = state_from_numpy(st, "cpu")["params"]
    toks = np.random.RandomState(0).randint(0, 512, (B, T)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    pl, pc = pm.prefill(pp, {"tokens": torch.from_numpy(toks)},
                        cache_len=T + 5)
    spec = pm.cache_spec(B, T)["blocks"]
    for name in ("state", "conv"):
        assert tuple(pc["blocks"][name].shape) == spec[name].shape \
            == jc["blocks"][name].shape
        assert pc["blocks"][name].dtype == spec[name].dtype
    assert pc["blocks"]["state"].dtype == torch.float32
    assert pc["blocks"]["conv"].dtype == torch.bfloat16
    assert _err(pl.numpy(), jl) < 0.02
    assert _err(pc["blocks"]["state"].numpy(), jc["blocks"]["state"]) < 0.02
    assert _err(pc["blocks"]["conv"].float().numpy(),
                jnp.asarray(jc["blocks"]["conv"], jnp.float32)) < 0.05
    for i in range(5):
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)[:, None]
        jl, jc = jm.decode_step(jp, jc, {"tokens": jnp.asarray(tok),
                                         "pos": jnp.int32(T + i)})
        pl, pc = pm.decode_step(pp, pc, {"tokens": torch.from_numpy(tok),
                                         "pos": T + i})
        assert _err(pl.numpy(), jl) < 0.06, i


@pytest.mark.parametrize("n_extra,tol", [(1, 0.06), (5, 0.1)])
def test_decode_matches_prefill_of_the_longer_prompt(pair, n_extra, tol):
    """Decode steps chained on the prefilled cache give the last logits of
    prefilling the extended prompt (the JAX package's consistency checks,
    on the port; T + 1 = 41 is not a multiple of the chunk)."""
    _, pm, st = pair
    pp = state_from_numpy(st, "cpu")["params"]
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, 512, (B, T + n_extra)).astype(np.int32))
    _, cache = pm.prefill(pp, {"tokens": toks[:, :T]})
    for i in range(n_extra):
        ld, cache = pm.decode_step(pp, cache, {"tokens": toks[:, T + i:][:, :1],
                                               "pos": T + i})
    lf, _ = pm.prefill(pp, {"tokens": toks})
    assert _err(ld.numpy(), lf.numpy()) < tol


def test_float32_decode_continues_the_prefill(pair):
    """With the model computing in float32 (what chip_smoke checks at full
    depth), one decode step gives the prefill of the longer prompt to
    float32 rounding: the step continues the prefill's state and conv
    window exactly."""
    _, pm, st = pair
    pm = build_model(pm.cfg, compute_dtype=torch.float32)
    pp = state_from_numpy(st, "cpu")["opt"]["master"]
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, 512, (B, T + 1)).astype(np.int32))
    _, cache = pm.prefill(pp, {"tokens": toks[:, :T]})
    assert cache["blocks"]["conv"].dtype == torch.float32
    ld, _ = pm.decode_step(pp, cache, {"tokens": toks[:, T:], "pos": T})
    lf, _ = pm.prefill(pp, {"tokens": toks})
    assert _err(ld.numpy(), lf.numpy()) < 1e-4


def test_short_prompt_conv_window_is_zero_padded(pair):
    """A prompt shorter than the conv window: prefill then decode equals
    the prefill of the longer prompt (the missing inputs are the causal
    conv's zero padding)."""
    _, pm, st = pair
    pp = state_from_numpy(st, "cpu")["params"]
    toks = torch.tensor([[5, 7, 9], [1, 2, 3]], dtype=torch.int32)
    _, cache = pm.prefill(pp, {"tokens": toks[:, :2]})
    assert not cache["blocks"]["conv"][:, :, 0].any()
    ld, _ = pm.decode_step(pp, cache, {"tokens": toks[:, 2:], "pos": 2})
    lf, _ = pm.prefill(pp, {"tokens": toks})
    assert _err(ld.numpy(), lf.numpy()) < 0.06


def test_decode_updates_the_cache_in_place(pair):
    _, pm, st = pair
    pp = state_from_numpy(st, "cpu")["params"]
    toks = torch.zeros((B, 8), dtype=torch.int32)
    _, cache = pm.prefill(pp, {"tokens": toks})
    state, conv = cache["blocks"]["state"], cache["blocks"]["conv"]
    before = state.clone()
    _, out = pm.decode_step(pp, cache, {"tokens": toks[:, :1], "pos": 8})
    assert out["blocks"]["state"] is state and out["blocks"]["conv"] is conv
    assert not torch.equal(state, before)


def test_prefill_runs_the_scan_wrapper_once_per_layer(pair, monkeypatch):
    """Prefill reaches ``ssd_scan`` (the kernel on the card) once per
    layer; training reaches only the plain version."""
    from repro_torch.models import ssm

    _, pm, st = pair
    pp = state_from_numpy(st, "cpu")["params"]
    calls = []
    real = ssd.ssd_scan

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(ssm, "ssd_scan", spy)
    toks = torch.zeros((B, 8), dtype=torch.int32)
    pm.prefill(pp, {"tokens": toks})
    assert len(calls) == pm.cfg.num_layers
    calls.clear()
    with torch.no_grad():
        pm.loss(pp, {"tokens": toks})
    assert calls == []


def test_five_train_steps_track_jax(pair):
    jm, pm, st = pair
    data = SyntheticTokens(vocab_size=512, batch=2, seq_len=64, seed=1)
    jstep = jax.jit(jax_steps.make_train_step(
        jm, JaxTrainConfig(learning_rate=3e-3, warmup_steps=2,
                           total_steps=10)))
    pstep = steps.make_train_step(pm, TrainConfig(
        learning_rate=3e-3, warmup_steps=2, total_steps=10))
    js = jax.tree.map(jnp.asarray, st)
    ps = state_from_numpy(st, "cpu")
    for i in range(5):
        b = data.peek(i)
        js, jmet = jstep(js, b)
        ps, pmet = pstep(ps, {"tokens": torch.from_numpy(b["tokens"])})
        assert abs(float(pmet["loss"]) - float(jmet["loss"])) < 5e-3, i
        assert float(pmet["grad_norm"]) == pytest.approx(
            float(jmet["grad_norm"]), rel=1e-2)
    assert int(ps["step"]) == int(js["step"]) == 5
    # the SSM's own 1-D leaves (Adam moves them by ~lr a step), as the
    # dense test holds the final norm
    for name in ("A_log", "dt_bias", "D_skip"):
        np.testing.assert_allclose(
            ps["opt"]["master"]["blocks"]["mixer"][name].numpy(),
            np.asarray(js["opt"]["master"]["blocks"]["mixer"][name]),
            rtol=0, atol=1e-3)


# ---------------------------------------------------------- checkpoint store
def _perturb(np_state):
    """A copy with a few elements of block_001's biggest weights and of its
    1-D A_log changed (block deltas next to a sub-block leaf)."""
    out = jax.tree.map(np.array, np_state)
    for tree in (out["params"], out["opt"]["master"], out["opt"]["m"]):
        mx = tree["blocks"]["mixer"]
        for name in ("w_x", "A_log"):
            w = mx[name]
            w[1].flat[:3] = (w[1].flat[:3].astype(np.float32)
                             + 0.5).astype(w.dtype)
    return out


def _entries(mgr, step):
    m = mgr.manifests.load(step)
    return {u: {k: (r.digest, r.stored, r.delta_base, r.nbytes, r.step)
                for k, r in kinds.items()}
            for u, kinds in m.entries.items()}


def _objects(root):
    return {p.name: p.read_bytes()
            for p in sorted((root / "objects").glob("*/*.chunk"))}


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


@pytest.mark.parametrize("policy", ["full", "parity"])
def test_same_state_same_store(tmp_path, pair, policy):
    """Four events (initial, unchanged, perturbed, unchanged) saved by
    both packages: equal manifests and byte-identical objects."""
    jm, pm, st = pair
    s1 = _perturb(st)
    jmgr = _jax_mgr(tmp_path / "jax", jm, policy)
    pmgr = _port_mgr(tmp_path / "port", pm, policy)
    try:
        for step, s in ((1, st), (2, st), (3, s1), (4, s1)):
            jmgr.save(s, step=step)
            pmgr.save(state_from_numpy(s, "cpu"), step=step)
            assert _entries(pmgr, step) == _entries(jmgr, step), step
            for k in ("written_bytes", "dedup_hits", "delta_chunks",
                      "full_chunks", "d2h_bytes"):
                assert pmgr.last_save_stats[k] == jmgr.last_save_stats[k], \
                    (step, k)
        assert _objects(tmp_path / "port") == _objects(tmp_path / "jax")
        stored = {r.stored for kinds in pmgr.manifests.load(3).entries
                  .values() for r in kinds.values()}
        assert "delta" in stored or policy == "parity"
    finally:
        jmgr.close()
        pmgr.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stores_cross_restore_bit_exact(tmp_path, pair, writer):
    """A Frankenstein merge (parity at step 4 carries units from step 2)
    written by either package restores bit for bit in the other."""
    jm, pm, st = pair
    s1 = _perturb(st)
    if writer == "jax":
        mgr = _jax_mgr(tmp_path, jm, "parity")
        mgr.save(st, step=2)
        mgr.save(s1, step=4)
    else:
        mgr = _port_mgr(tmp_path, pm, "parity")
        mgr.save(state_from_numpy(st, "cpu"), step=2)
        mgr.save(state_from_numpy(s1, "cpu"), step=4)
    mgr.close()
    jmgr = _jax_mgr(tmp_path, jm, "parity")
    want = jax.tree.map(np.asarray, jmgr.restore(jax_steps.state_specs(jm)))
    jmgr.close()
    pmgr = _port_mgr(tmp_path, pm, "parity")
    got = pmgr.restore(steps.state_specs(pm), device=CPU)
    m = pmgr.manifests.load(4)
    pmgr.close()
    assert int(got["step"]) == int(want["step"]) == 4
    assert {r.step for kinds in m.entries.values()
            for r in kinds.values()} == {2, 4}
    got_np = state_to_numpy({"params": got["params"], "opt": got["opt"]},
                            bf16_dtype=ml_dtypes.bfloat16)
    assert _state_bytes(got_np) == _state_bytes(
        {"params": want["params"], "opt": want["opt"]})


def _poke_np(tree):
    def poke(x):
        x = np.array(x)
        x.flat[:1] += 1
        return x
    return jax.tree.map(poke, tree)


@pytest.mark.parametrize("drift", ["all", "one"])
def test_port_swap_on_a_jax_store_matches_the_jax_service(tmp_path, pair,
                                                          drift):
    """On a Mamba store the JAX package wrote (codec none, 4 KiB blocks),
    the port's WeightService gives weights equal byte for byte to the JAX
    service's, with the same unit counts (the JAX hot-swap test's arch,
    ``tests/test_serve_swap.py``)."""
    jm, pm, s1 = pair
    jreg = JaxRegistry(jm)
    jmgr = _jax_mgr(tmp_path, jm, "full")
    try:
        jmgr.save(s1, step=10)
        if drift == "one":
            unit = jm.layer_units()[1].name
            p2 = jreg.insert_unit(dict(s1["params"]), unit, _poke_np(
                jreg.extract_unit(s1["params"], unit)))
            s2 = {"step": s1["step"], "params": p2, "opt": s1["opt"]}
        else:
            s2 = {"step": s1["step"], "params": _poke_np(s1["params"]),
                  "opt": _poke_np(s1["opt"])}
        jmgr.save(s2, step=20)
        jsvc = JaxWeightService(jmgr, jax_steps.state_specs(jm), step=10)
        jstats = jsvc.poll()
        want = jax.tree.map(np.asarray, jsvc.current())
    finally:
        jmgr.close()
    pmgr = _port_mgr(tmp_path, pm, "full")
    try:
        svc = WeightService(pmgr, steps.state_specs(pm), device="cpu",
                            step=10)
        stats = svc.poll()
        got = state_to_numpy(svc.current())
        cold = pmgr.restore({"params": steps.state_specs(pm)["params"]},
                            device=CPU, parts=("params",), step=20)
    finally:
        pmgr.close()
    assert {k: stats[k] for k in SWAP_COUNTS} == \
        {k: jstats[k] for k in SWAP_COUNTS}
    assert stats["units_scattered"] > 0
    assert [p for p, _ in flatten_with_paths(want)] == \
        [p for p, _ in flatten_with_paths(got)]
    for (p, w), (_, g) in zip(flatten_with_paths(want),
                              flatten_with_paths(got)):
        assert w.tobytes() == g.tobytes(), p
    for (p, x), (_, y) in zip(flatten_with_paths(svc.current()),
                              flatten_with_paths(cold["params"])):
        assert torch.equal(x, y), p


# ------------------------------------------------------------- end to end
def test_train_fail_resume_and_serve_hot_swap(tmp_path):
    """The trainer on the reduced Mamba config: overlapped topk_delta saves,
    a failure at step 7 with event 6 in flight, resume from the step-4
    merge to 8; then ``serve`` cold-loads step 4, hot-swaps to 8 and
    generates the tokens of a server cold-loaded at 8."""
    kw = dict(arch=ARCH, total_steps=8, batch=2, seq_len=24, seed=0,
              ckpt_interval=2, device="cpu", policy_name="topk_delta",
              ckpt_spread_steps=2, ckpt_dir=str(tmp_path / "run"))
    ref = train(**{**kw, "ckpt_dir": str(tmp_path / "ref"),
                   "ckpt_interval": 9, "ckpt_spread_steps": 0})
    with pytest.raises(SimulatedFailure) as e:
        train(fail_at=7, **kw)
    assert [ev["step"] for ev in e.value.save_events] == [2, 4]
    assert (tmp_path / "run" / "LATEST").read_text().strip() == "4"
    res = train(resume=True, **kw)
    assert res["restore_stats"]["step"] == 4
    assert [s for s, _ in res["losses"]] == [4, 5, 6, 7]
    want = dict(ref["losses"])
    for step, loss in res["losses"]:
        assert np.isfinite(loss) and abs(loss - want[step]) < 0.05, step
    skw = dict(arch=ARCH, batch=2, prompt_len=9, new_tokens=3,
               from_ckpt=str(tmp_path / "run"), device="cpu")
    hot = serve(from_step=4, hot_swap=True, swap_wait=0.0, **skw)
    cold = serve(**skw)
    assert hot["restore"]["step"] == 4 and hot["swap"]["step_to"] == 8
    assert hot["served_step"] == cold["served_step"] == 8
    assert hot["tokens_digest"] == cold["tokens_digest"]


def test_serve_random_weights_end_to_end():
    kw = dict(arch=ARCH, batch=2, prompt_len=33, new_tokens=4, seed=0,
              device="cpu")
    r1, r2 = serve(**kw), serve(**kw)
    assert r1["tokens_digest"] == r2["tokens_digest"]
    assert len(r1["sample_tokens"]) == 4
    assert all(0 <= t < 512 for t in r1["sample_tokens"])


@pytest.mark.parametrize("family", ["moe", "encdec", "vlm"])
def test_other_families_are_not_ported(family):
    """The hybrid family is ported (tests/test_torch_hybrid.py) and so is
    MoE (tests/test_torch_moe.py): a small MoE config builds and runs a
    forward.  Enc-dec and the VLM still raise, naming ROADMAP A5."""
    from repro_torch.configs.base import (EncDecConfig, ModelConfig,
                                          MoEConfig, VLMConfig)

    extra = {"moe": {"moe": MoEConfig(num_experts=4, top_k=2,
                                      d_ff_expert=64)},
             "encdec": {"encdec": EncDecConfig()},
             "vlm": {"vlm": VLMConfig()}}[family]
    cfg = ModelConfig(name=f"{family}-like", family=family, num_layers=2,
                      d_model=64, num_heads=2, num_kv_heads=2, d_ff=128,
                      vocab_size=64, **extra)
    if family != "moe":
        with pytest.raises(NotImplementedError, match="A5"):
            build_model(cfg)
        return
    model = build_model(cfg)
    params = model.init(0, torch.device("cpu"), dtype=torch.bfloat16)
    tokens = torch.randint(0, 64, (2, 16), dtype=torch.int32)
    with torch.no_grad():
        loss, metrics = model.loss(params, {"tokens": tokens})
        logits = model.logits(params, tokens)
    assert tuple(logits.shape) == (2, 16, 64)
    assert torch.isfinite(logits).all() and torch.isfinite(loss)
    assert float(metrics["aux_loss"]) > 0
