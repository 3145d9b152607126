"""The port's hybrid LM (hybrid family, zamba2-2.7b reduced: 6 layers,
shared period 3, so two groups share one attention block) against the
JAX package's ``HybridLM``: structure, groups and layer units, loss and
logits, prefill and its cache (the Mamba2 layers' and each shared
invocation's), decode, a 5-step training trajectory, the checkpoint store
written by both packages, and the trainer and server end to end on the
CPU.

JAX-initialized params reach the port through numpy
(``repro_torch.convert``).  Tolerances are those of
``tests/test_torch_mamba.py`` (bf16 activations, float32 state,
statistics and logits): logits within 0.02, loss within 2e-3, the decode
state within 0.02, the bf16 conv window within 0.05; every step of a
decode teacher-forced on JAX's tokens within 0.06, one port decode step
against the port's prefill of the longer prompt within 0.06 (5 chained
steps: 0.1); over 5 train steps every loss within 5e-3 and every global
grad norm within 1%.  One bound is new: the shared invocations' bf16 k/v
cache within 0.08, four bf16 ulps at its largest magnitude (~3.4 in the
reduced model; the second group's inputs carry three Mamba2 layers' bf16
differences, which leave 0.0625 there, against the conv window's 0.05 at
one layer).  Everything checkpointed is compared byte for byte.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.saver import CheckpointManager as JaxManager
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
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core.layer_registry import LayerRegistry
from repro_torch.core.policies import make_policy
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch import steps
from repro_torch.launch.serve import serve
from repro_torch.launch.train import SimulatedFailure, train
from repro_torch.models import build_model
from repro_torch.models.mamba_lm import HybridLM
from repro_torch.optim import build_group_spec, decay_mask

torch.set_num_threads(1)

ARCH = "zamba2-2.7b"
CPU = torch.device("cpu")
BB = 4096       # fingerprint block bytes
T, B = 40, 2


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


def _units(model):
    return [(u.name, u.path, u.index, u.kind) for u in model.layer_units()]


def _pad_jax_cache(cache, extra):
    """The JAX server's ``_pad_cache_to``: the shared k/v grown by
    ``extra`` zero positions (the Mamba2 caches do not grow)."""
    pad = ((0, 0), (0, 0), (0, extra), (0, 0), (0, 0))
    return {"blocks": cache["blocks"],
            "shared": jax.tree.map(lambda t: jnp.pad(t, pad),
                                   cache["shared"])}


def test_structure_matches(pair):
    jm, pm, st = pair
    assert isinstance(pm, HybridLM)
    jflat = [(p, tuple(a.shape)) for p, a in flatten_with_paths(st["params"])]
    pflat = [(p, tuple(s.shape))
             for p, s in flatten_with_paths(pm.param_specs())]
    assert pflat == jflat
    units = _units(pm)
    assert units == _units(jm)
    # shared_attn sits just before lm_head, as JAX's units.insert(-1, ...)
    assert [u[0] for u in units[-3:]] == ["final_norm", "shared_attn",
                                          "lm_head"]
    assert units[-2] == ("shared_attn", ("shared",), None, "aux")
    pg = build_group_spec(pm, weight_decay=0.1).groups
    jg = jax_group_spec(jm, weight_decay=0.1).groups
    assert [(g.index, g.unit, g.decay, g.paths, g.weight_decay) for g in pg] \
        == [(g.index, g.unit, g.decay, g.paths, g.weight_decay) for g in jg]
    assert flatten_with_paths(decay_mask(pm)) == [
        (p, bool(v)) for p, v in flatten_with_paths(jax_decay_mask(jm))]
    assert (pm.period, pm.n_groups) == (3, 2) == (
        jm.cfg.hybrid.shared_period, jm._n_groups)


def test_full_config_units_and_param_count():
    """The published config: 54 layers in 9 groups of 6, the unit list of
    the JAX model, and its parameter count (JAX's shapes by
    ``eval_shape``, nothing allocated)."""
    cfg = get_config(ARCH)
    pm = build_model(cfg)
    jm = jax_build_model(jax_get_config(ARCH))
    assert (pm.period, pm.n_groups) == (6, 9)
    assert _units(pm) == _units(jm)
    assert len(_units(pm)) == 54 + 4
    jshapes = jax.eval_shape(jm.init, jax.random.key(0))
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jshapes))
    sizes = {p: int(np.prod(s.shape))
             for p, s in flatten_with_paths(pm.param_specs())}
    assert sum(sizes.values()) == want
    assert sizes["shared/attn/wq"] == 2 * 2560 * 32 * 80


@pytest.mark.parametrize("layers", [4, 7, 9])
def test_depth_not_a_multiple_of_the_period_raises(layers):
    cfg = get_config(ARCH).replace(num_layers=layers)
    with pytest.raises(ValueError, match=f"{layers} layers .* 6"):
        build_model(cfg)


def test_logits_and_loss_match(pair):
    jm, pm, st = pair
    batch = SyntheticTokens(vocab_size=512, batch=2, seq_len=64,
                            seed=1).peek(0)
    params = jax.tree.map(jnp.asarray, st["params"])
    jloss = float(jm.loss(params, batch)[0])
    jl, _ = jm.prefill(params, {"tokens": jnp.asarray(batch["tokens"])})
    pst = state_from_numpy(st, "cpu")
    tokens = torch.from_numpy(batch["tokens"])
    with torch.no_grad():
        plogits = pm.logits(pst["params"], tokens)
        ploss = float(pm.loss(pst["params"], {"tokens": tokens})[0])
    assert plogits.dtype == torch.float32
    assert tuple(plogits.shape) == (2, 64, 512)
    # the JAX HybridLM's full-sequence logits are its loss path; its
    # prefill gives the last position's
    np.testing.assert_allclose(plogits[:, -1].numpy(), np.asarray(jl),
                               rtol=0, atol=0.02)
    assert abs(ploss - jloss) < 2e-3


def test_prefill_cache_and_decode_track_jax(pair):
    """Prefill logits and the cache (Mamba2 states and conv windows, the
    shared invocations' k/v), then 5 decode steps teacher-forced on JAX's
    greedy tokens."""
    jm, pm, st = pair
    jp = jax.tree.map(jnp.asarray, st["params"])
    pp = state_from_numpy(st, "cpu")["params"]
    toks = np.random.RandomState(0).randint(0, 512, (B, T)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    pl, pc = pm.prefill(pp, {"tokens": torch.from_numpy(toks)},
                        cache_len=T + 5)
    spec = pm.cache_spec(B, T + 5)
    for part in ("blocks", "shared"):
        for name, s in spec[part].items():
            assert tuple(pc[part][name].shape) == s.shape
            assert pc[part][name].dtype == s.dtype
    for name in ("state", "conv"):
        assert tuple(pc["blocks"][name].shape) == jc["blocks"][name].shape
    for name in ("k", "v"):
        got = pc["shared"][name]
        assert tuple(got.shape) == (2, B, T + 5, 2, 32)
        assert tuple(got[:, :, :T].shape) == jc["shared"][name].shape
        assert not got[:, :, T:].any()
        assert _err(got[:, :, :T].float().numpy(),
                    jnp.asarray(jc["shared"][name], jnp.float32)) < 0.08
    assert _err(pl.numpy(), jl) < 0.02
    assert _err(pc["blocks"]["state"].numpy(), jc["blocks"]["state"]) < 0.02
    assert _err(pc["blocks"]["conv"].float().numpy(),
                jnp.asarray(jc["blocks"]["conv"], jnp.float32)) < 0.05
    jc = _pad_jax_cache(jc, 5)
    for i in range(5):
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)[:, None]
        jl, jc = jm.decode_step(jp, jc, {"tokens": jnp.asarray(tok),
                                         "pos": jnp.int32(T + i)})
        pl, pc = pm.decode_step(pp, pc, {"tokens": torch.from_numpy(tok),
                                         "pos": T + i})
        assert _err(pl.numpy(), jl) < 0.06, i


@pytest.mark.parametrize("n_extra,tol", [(1, 0.06), (5, 0.1)])
def test_decode_matches_prefill_of_the_longer_prompt(pair, n_extra, tol):
    _, pm, st = pair
    pp = state_from_numpy(st, "cpu")["params"]
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, 512, (B, T + n_extra)).astype(np.int32))
    _, cache = pm.prefill(pp, {"tokens": toks[:, :T]},
                          cache_len=T + n_extra)
    for i in range(n_extra):
        ld, cache = pm.decode_step(pp, cache, {"tokens": toks[:, T + i:][:, :1],
                                               "pos": T + i})
    lf, _ = pm.prefill(pp, {"tokens": toks})
    assert _err(ld.numpy(), lf.numpy()) < tol


def test_float32_decode_continues_the_prefill(pair):
    """Computing in float32 (what chip_smoke checks at full depth), one
    decode step gives the prefill of the longer prompt to float32
    rounding: the step continues the Mamba2 states and conv windows and
    attends over the shared invocations' cached keys and its own."""
    _, pm, st = pair
    pm = build_model(pm.cfg, compute_dtype=torch.float32)
    pp = state_from_numpy(st, "cpu")["opt"]["master"]
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, 512, (B, T + 1)).astype(np.int32))
    _, cache = pm.prefill(pp, {"tokens": toks[:, :T]}, cache_len=T + 1)
    assert cache["shared"]["k"].dtype == torch.float32
    ld, _ = pm.decode_step(pp, cache, {"tokens": toks[:, T:], "pos": T})
    lf, _ = pm.prefill(pp, {"tokens": toks})
    assert _err(ld.numpy(), lf.numpy()) < 1e-4


def test_decode_past_the_cache_raises(pair):
    """A cache allocated at the prompt's length has no room for the next
    token's k/v: the step raises rather than attend without them."""
    _, pm, st = pair
    pp = state_from_numpy(st, "cpu")["params"]
    toks = torch.zeros((B, 8), dtype=torch.int32)
    _, cache = pm.prefill(pp, {"tokens": toks})
    with pytest.raises(ValueError, match="past a cache of 8"):
        pm.decode_step(pp, cache, {"tokens": toks[:, :1], "pos": 8})


def test_decode_updates_the_cache_in_place(pair):
    _, pm, st = pair
    pp = state_from_numpy(st, "cpu")["params"]
    toks = torch.ones((B, 8), dtype=torch.int32)
    _, cache = pm.prefill(pp, {"tokens": toks}, cache_len=9)
    before = {p: {k: t.clone() for k, t in c.items()}
              for p, c in cache.items()}
    _, out = pm.decode_step(pp, cache, {"tokens": toks[:, :1], "pos": 8})
    for part in ("blocks", "shared"):
        for name, t in cache[part].items():
            assert out[part][name] is t
    assert not torch.equal(cache["blocks"]["state"],
                           before["blocks"]["state"])
    assert torch.equal(cache["shared"]["k"][:, :, :8],
                       before["shared"]["k"][:, :, :8])
    assert cache["shared"]["k"][:, :, 8].any()


def test_prefill_and_decode_reach_each_kernel_wrapper(pair, monkeypatch):
    """Prefill reaches ``ssd_scan`` once per Mamba2 layer and
    ``flash_attention`` once per shared invocation, a decode step
    ``flash_attention`` once per invocation; training reaches neither."""
    from repro_torch.models import attention, ssm

    _, pm, st = pair
    pp = state_from_numpy(st, "cpu")["params"]
    calls = {"ssd": 0, "flash": 0}

    def spy(name, real):
        def call(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        return call

    monkeypatch.setattr(ssm, "ssd_scan", spy("ssd", ssd.ssd_scan))
    monkeypatch.setattr(attention, "flash_attention",
                        spy("flash", fa.flash_attention))
    toks = torch.zeros((B, 8), dtype=torch.int32)
    _, cache = pm.prefill(pp, {"tokens": toks}, cache_len=9)
    assert calls == {"ssd": pm.cfg.num_layers, "flash": pm.n_groups}
    pm.decode_step(pp, cache, {"tokens": toks[:, :1], "pos": 8})
    assert calls == {"ssd": pm.cfg.num_layers, "flash": 2 * pm.n_groups}
    with torch.no_grad():
        pm.loss(pp, {"tokens": toks})
    assert calls == {"ssd": pm.cfg.num_layers, "flash": 2 * pm.n_groups}


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
    # the shared block's norms (Adam moves them by ~lr a step)
    for name in ("ln1", "ln2"):
        np.testing.assert_allclose(
            ps["opt"]["master"]["shared"][name].numpy(),
            np.asarray(js["opt"]["master"]["shared"][name]),
            rtol=0, atol=1e-3)


# ---------------------------------------------------------- checkpoint store
def _perturb(np_state):
    """A copy with a few elements of block_001's in-projection and of the
    shared block's query projection changed (block deltas in a block unit
    and in the aux unit that every group reads)."""
    out = jax.tree.map(np.array, np_state)
    for tree in (out["params"], out["opt"]["master"], out["opt"]["m"]):
        for w in (tree["blocks"]["mixer"]["w_x"][1],
                  tree["shared"]["attn"]["wq"]):
            w.flat[:3] = (w.flat[:3].astype(np.float32) + 0.5).astype(w.dtype)
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
    both packages: equal manifests and byte-identical objects, the
    shared_attn unit among them."""
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
        m1 = pmgr.manifests.load(1)
        assert sorted(m1.entries["shared_attn"]) == ["opt", "weights"]
        if policy == "full":
            m3 = pmgr.manifests.load(3)
            assert m3.entries["shared_attn"]["weights"].stored == "delta"
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


# ------------------------------------------------------------- end to end
def test_train_fail_resume_and_serve_hot_swap(tmp_path):
    """The trainer on the reduced hybrid: sync ``full`` saves every 2
    steps, a failure at step 5, the resume from step 4 repeating the
    uninterrupted run's losses; then ``serve`` cold-loads step 4,
    hot-swaps to 6 and generates the tokens of a server cold-loaded at
    6."""
    kw = dict(arch=ARCH, total_steps=6, batch=2, seq_len=24, seed=0,
              ckpt_interval=2, device="cpu", policy_name="full",
              ckpt_async=False, ckpt_dir=str(tmp_path / "run"))
    ref = train(**{**kw, "ckpt_dir": str(tmp_path / "ref"),
                   "ckpt_interval": 7})
    with pytest.raises(SimulatedFailure) as e:
        train(fail_at=5, **kw)
    assert [ev["step"] for ev in e.value.save_events] == [2, 4]
    res = train(resume=True, **kw)
    assert res["restore_stats"]["step"] == 4
    assert [s for s, _ in res["losses"]] == [4, 5]
    want = dict(ref["losses"])
    for step, loss in res["losses"]:
        assert abs(loss - want[step]) < 1e-4, step
    skw = dict(arch=ARCH, batch=2, prompt_len=9, new_tokens=3,
               from_ckpt=str(tmp_path / "run"), device="cpu")
    hot = serve(from_step=4, hot_swap=True, swap_wait=0.0, **skw)
    cold = serve(**skw)
    assert hot["restore"]["step"] == 4 and hot["swap"]["step_to"] == 6
    assert hot["served_step"] == cold["served_step"] == 6
    assert hot["tokens_digest"] == cold["tokens_digest"]


def test_serve_random_weights_end_to_end():
    kw = dict(arch=ARCH, batch=2, prompt_len=33, new_tokens=4, seed=0,
              device="cpu")
    r1, r2 = serve(**kw), serve(**kw)
    assert r1["tokens_digest"] == r2["tokens_digest"]
    assert len(r1["sample_tokens"]) == 4
    assert all(0 <= t < 512 for t in r1["sample_tokens"])
