"""The port's MoE family (``repro_torch/models/moe.py``, the decoder's
``dense_first_0`` and MoE blocks) against the JAX package on the CPU:
DeepSeek-V2-Lite (MLA + fine-grained MoE, first layer dense) and Arctic
(GQA + MoE beside a dense residual MLP), reduced.

- Configs equal JAX's field for field; structure, units and the full
  parameter count equal JAX's (by specs, nothing allocated).
- Routing equals JAX's exactly from the same logits, equal logits
  included (``jax.lax.top_k`` puts the lower index first).  Slots, the
  ``keep`` mask (the dispatch tensor) equal JAX's exactly and the combine
  weights within one bf16 ulp (each side's float32 softmax), at dropping
  capacity factors 1.0 and 0.5; the aux loss within 1e-6 relative.
- ``moe_forward`` / ``moe_decode_forward`` on JAX's inputs and params
  within two bf16 ulps of each of JAX's outputs plus one ulp of the
  largest (``_close``: the outputs are bf16 sums of the routed and the
  shared or residual experts, ~20 at most on these unit-variance inputs,
  where an ulp is 0.125, and a sum that cancels keeps its terms' error).
- The whole model: logits within 0.02 and loss within 2e-3 (as
  ``tests/test_torch_hybrid.py``); the prefill cache, teacher-forced
  decode and decode against a longer prefill, a 5-step trajectory.

Routing flips.  A layer's router logits are bf16 values rounded from
float32 sums; the two packages sum in other orders, and their bf16 hidden
states differ by an ulp here and there, so a token whose k-th and
(k+1)-th probabilities nearly tie can pick another expert in one package
(a few of ~100 tokens over 3 layers).  Where the whole model is compared
token by token (the prefill cache), both packages' choices are recorded
layer by layer; a token is excluded from the comparison of the layers
after its first differing choice, the test requires every differing
choice to be such a near tie (a probability gap under 0.02 on the port's
side) and at most 5% of the tokens to differ, and holds every other row
within 0.08 (four bf16 ulps at the cache's largest magnitudes, as the
hybrid's k/v).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.models.moe as jax_moe
from repro.configs import get_config as jax_get_config
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.data.synthetic import SyntheticTokens
from repro.launch import steps as jax_steps
from repro.launch.serve import _pad_cache_to
from repro.models import build_model as jax_build_model
from repro.models.modules import ParamBuilder
from repro_torch.checkpoint.serial import flatten_with_paths
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.convert import state_from_numpy
from repro_torch.launch import steps
from repro_torch.models import build_model
from repro_torch.models import moe as port_moe
from repro_torch.models.transformer import DecoderLM

torch.set_num_threads(2)

DS = "deepseek-v2-lite-16b"
ARCTIC = "arctic-480b"
CPU = torch.device("cpu")
T, B = 40, 2


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


def _close(got, want):
    """Within two bf16 ulps of each value (relative 2**-7) plus one ulp of
    the largest (2**-8 of the largest magnitude)."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               rtol=2.0 ** -7,
                               atol=2.0 ** -8 * float(np.abs(want).max()))


def _units(model):
    return [(u.name, u.path, u.index, u.kind) for u in model.layer_units()]


def _make_pair(arch):
    jm = jax_build_model(jax_get_config(arch, reduced=True))
    pm = build_model(get_config(arch, reduced=True))
    st = jax.tree.map(np.asarray, jax_steps.init_state(jm,
                                                       jax.random.key(0)))
    return arch, jm, pm, st


@pytest.fixture(scope="module", params=[DS, ARCTIC])
def pair(request):
    return _make_pair(request.param)


@pytest.fixture(scope="module")
def ds_pair():
    return _make_pair(DS)


# ------------------------------------------------------------- structure
@pytest.mark.parametrize("arch", [DS, ARCTIC])
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_equal_jax_field_for_field(arch, reduced):
    jc = jax_get_config(arch, reduced=reduced)
    pc = get_config(arch, reduced=reduced)
    want = jc.model_dump()
    got = dataclasses.asdict(pc)
    assert got == want


@pytest.mark.parametrize("arch,n_params,units", [(DS, 15_706_484_224, 30),
                                                 (ARCTIC, 476_850_275_328,
                                                  38)])
def test_full_config_units_and_param_count(arch, n_params, units):
    """The published configs: JAX's unit list and parameter count (JAX's
    shapes by ``eval_shape``, nothing allocated)."""
    pm = build_model(get_config(arch))
    jm = jax_build_model(jax_get_config(arch))
    assert isinstance(pm, DecoderLM)
    assert _units(pm) == _units(jm)
    assert len(_units(pm)) == units
    jshapes = jax.eval_shape(jm.init, jax.random.key(0))
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jshapes))
    got = sum(int(np.prod(s.shape))
              for _, s in flatten_with_paths(pm.param_specs()))
    assert got == want == n_params


def test_deepseek_units_and_block_sizes():
    """``block_000`` is the unstacked first dense layer (no index); one
    MoE block holds 584,847,872 parameters (its optimizer object, master,
    m and v in float32, is 7.02 GB: over msgpack's 2**32 - 1-byte bin)."""
    pm = build_model(get_config(DS))
    units = _units(pm)
    assert units[1] == ("block_000", ("dense_first_0",), None, "block")
    assert units[2] == ("block_001", ("blocks",), 0, "block")
    assert units[-3] == ("block_026", ("blocks",), 25, "block")
    specs = pm.param_specs()
    per_block = sum(int(np.prod(s.shape[1:]))
                    for _, s in flatten_with_paths(specs["blocks"]))
    assert per_block == 584_847_872
    assert per_block * 12 > 2 ** 32 - 1 > per_block * 12 // 4
    assert specs["dense_first_0"]["mlp"]["w_gate"].shape == (2048, 10944)


def test_structure_matches(pair):
    _, jm, pm, st = pair
    jflat = [(p, tuple(a.shape)) for p, a in flatten_with_paths(st["params"])]
    pflat = [(p, tuple(s.shape))
             for p, s in flatten_with_paths(pm.param_specs())]
    assert pflat == jflat
    assert _units(pm) == _units(jm)


# --------------------------------------------------------------- routing
def _jax_route(logits, k):
    probs = jax.nn.softmax(jnp.asarray(logits, jnp.float32), axis=-1)
    gate_vals, idx = jax.lax.top_k(probs, k)
    gate_vals = gate_vals / jnp.clip(
        jnp.sum(gate_vals, axis=-1, keepdims=True), 1e-9)
    return np.asarray(probs), np.asarray(gate_vals), np.asarray(idx)


@pytest.mark.parametrize("e,k", [(64, 6), (4, 2), (8, 3)])
def test_routing_equals_jax_with_planted_ties(e, k):
    """Equal bf16 logits (ties at and across the k-th place, whole rows
    equal): the port picks JAX's experts in JAX's order."""
    rng = np.random.RandomState(e + k)
    logits = rng.randn(2, 50, e).astype(ml_dtypes.bfloat16)
    # ties: copy values onto other experts of the same token
    for t in range(50):
        row = logits[0, t]
        order = np.argsort(-row.astype(np.float32), kind="stable")
        row[order[k]] = row[order[k - 1]]          # a tie at the k-th place
        row[rng.randint(e)] = row[order[0]]        # a tie at the top
    logits[1, :5] = logits[1, 5]                   # whole rows equal
    logits[1, 6, :] = logits[1, 6, 0]              # every expert equal
    lf = logits.astype(np.float32)
    want_p, want_g, want_i = _jax_route(lf, k)
    probs, gates, idx = port_moe.route(torch.from_numpy(lf), k)
    np.testing.assert_array_equal(idx.numpy(), want_i)
    np.testing.assert_allclose(gates.numpy(), want_g, rtol=1e-6, atol=0)
    np.testing.assert_allclose(probs.numpy(), want_p, rtol=1e-6, atol=0)
    # the planted ties break the way JAX breaks them: lower index first
    assert (np.diff(want_i[1, 6]) > 0).all()


def _spy_jax(monkeypatch):
    """Record the JAX MoE's router logits, top-k and dispatch/combine
    tensors."""
    rec = {"logits": [], "topk": [], "einsum": []}
    real_softmax, real_topk, real_einsum = (jax.nn.softmax, jax.lax.top_k,
                                            jnp.einsum)

    def softmax(x, *a, **kw):
        rec["logits"].append(np.asarray(x, np.float32))
        return real_softmax(x, *a, **kw)

    def top_k(x, k):
        out = real_topk(x, k)
        rec["topk"].append(tuple(np.asarray(o) for o in out))
        return out

    def einsum(spec, *ops, **kw):
        out = real_einsum(spec, *ops, **kw)
        if spec == "gtke,gtkc->gtec":
            rec["einsum"].append(np.asarray(out, np.float32))
        return out

    monkeypatch.setattr(jax.nn, "softmax", softmax)
    monkeypatch.setattr(jax.lax, "top_k", top_k)
    monkeypatch.setattr(jax_moe.jnp, "einsum", einsum)
    return rec


def _moe_params(cfg, seed):
    b = ParamBuilder(jax.random.key(seed))
    jax_moe.init_moe(b, cfg)
    return jax.tree.map(np.asarray, b.params)


def _moe_cfg(arch, cf):
    jc = jax_get_config(arch, reduced=True)
    jc = jc.model_copy(update={"moe": jc.moe.model_copy(
        update={"capacity_factor": cf, "num_experts": 8, "top_k": 2})})
    pc = get_config(arch, reduced=True)
    pc = pc.replace(moe=dataclasses.replace(pc.moe, capacity_factor=cf,
                                            num_experts=8, top_k=2))
    return jc, pc


@pytest.mark.parametrize("arch", [DS, ARCTIC])
@pytest.mark.parametrize("cf", [1.0, 0.5])
def test_slots_keep_combine_and_aux_equal_jax(monkeypatch, arch, cf):
    """At a dropping capacity factor: from JAX's router logits the port's
    experts, slots and drops give JAX's dispatch tensor exactly and its
    combine tensor within one bf16 ulp; the aux loss within 1e-6
    relative; and tokens are dropped (the test bites)."""
    jc, pc = _moe_cfg(arch, cf)
    p = _moe_params(jc, 3)
    x = np.random.RandomState(4).randn(2, 64, jc.d_model).astype(
        ml_dtypes.bfloat16)
    rec = _spy_jax(monkeypatch)
    _, jaux = jax_moe.moe_forward(jax.tree.map(jnp.asarray, p),
                                  jnp.asarray(x), jc)
    disp, comb = rec["einsum"]
    logits = torch.from_numpy(rec["logits"][0].copy())
    m = pc.moe
    probs, gates, idx = port_moe.route(logits, m.top_k)
    np.testing.assert_array_equal(idx.numpy(), rec["topk"][0][1])
    cap = port_moe.capacity(64, m)
    assert cap == disp.shape[-1]
    slot, keep, counts = port_moe.slots(idx, m.num_experts, cap)
    assert not keep.all() and keep.any()
    g_, t_, k_ = idx.shape
    got_d = np.zeros(disp.shape, np.float32)
    got_c = np.zeros(comb.shape, np.float32)
    w = (gates * keep).to(torch.bfloat16).float().numpy()
    for g in range(g_):
        for t in range(t_):
            for kk in range(k_):
                if keep[g, t, kk]:
                    e, c = int(idx[g, t, kk]), int(slot[g, t, kk])
                    got_d[g, t, e, c] = 1.0
                    got_c[g, t, e, c] = w[g, t, kk]
    np.testing.assert_array_equal(got_d, disp)
    np.testing.assert_allclose(got_c, comb, rtol=2.0 ** -8, atol=0)
    assert counts.sum() == g_ * t_ * k_
    aux = port_moe.aux_loss(probs, idx, m)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)


@pytest.mark.parametrize("arch", [DS, ARCTIC])
@pytest.mark.parametrize("cf", [8.0, 1.0, 0.5])
def test_moe_forward_matches_jax(monkeypatch, arch, cf):
    """``moe_forward`` on JAX's bf16 inputs and params: the same experts
    chosen (the port's own router logits), outputs within ``_close``, aux
    within 1e-5 relative; shared experts (DeepSeek) and the dense residual
    (Arctic) included."""
    jc, pc = _moe_cfg(arch, cf)
    p = _moe_params(jc, 5)
    x = np.random.RandomState(6).randn(2, 48, jc.d_model).astype(
        ml_dtypes.bfloat16)
    rec = _spy_jax(monkeypatch)
    jout, jaux = jax_moe.moe_forward(jax.tree.map(jnp.asarray, p),
                                     jnp.asarray(x), jc)
    seen = []
    real_route = port_moe.route
    monkeypatch.setattr(port_moe, "route",
                        lambda lg, k: seen.append(real_route(lg, k))
                        or seen[-1])
    pout, paux = port_moe.moe_forward(state_from_numpy(p, "cpu"),
                                      torch.from_numpy(
                                          x.view(np.uint16)).view(
                                              torch.bfloat16), pc)
    np.testing.assert_array_equal(seen[0][2].numpy(), rec["topk"][0][1])
    assert pout.dtype == torch.bfloat16 and pout.shape == x.shape
    _close(pout.float().numpy(), jnp.asarray(jout, jnp.float32))
    assert float(paux) == pytest.approx(float(jaux), rel=1e-5)
    assert ("wd_gate" in p) == (arch == ARCTIC)
    assert ("ws_gate" in p) == (arch == DS)


@pytest.mark.parametrize("arch", [DS, ARCTIC])
def test_moe_decode_forward_matches_jax(arch):
    """A single token per row takes every expert densely in both
    packages; outputs within ``_close``, aux 0."""
    jc, pc = _moe_cfg(arch, 1.25)
    p = _moe_params(jc, 7)
    x = np.random.RandomState(8).randn(4, 1, jc.d_model).astype(
        ml_dtypes.bfloat16)
    jout, jaux = jax_moe.moe_forward(jax.tree.map(jnp.asarray, p),
                                     jnp.asarray(x), jc)
    pout, paux = port_moe.moe_forward(
        state_from_numpy(p, "cpu"),
        torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16), pc)
    _close(pout.float().numpy(), jnp.asarray(jout, jnp.float32))
    assert float(paux) == float(jaux) == 0.0


def test_capacity_rule_equals_jax():
    m = get_config(DS).moe
    jm_ = jax_get_config(DS).moe
    for t in (1, 7, 64, 1024, 1025):
        for cf in (0.5, 1.0, 1.25, 64 / 6, 8.0):
            assert port_moe.capacity(t, dataclasses.replace(
                m, capacity_factor=cf)) == jax_moe._capacity(
                t, jm_.model_copy(update={"capacity_factor": cf}))


# ------------------------------------------------------------ whole model
def test_logits_and_loss_match(pair):
    _, jm, pm, st = pair
    batch = SyntheticTokens(vocab_size=512, batch=2, seq_len=64,
                            seed=1).peek(0)
    params = jax.tree.map(jnp.asarray, st["params"])
    jloss, jmet = jm.loss(params, batch)
    jl, _ = jm.prefill(params, {"tokens": jnp.asarray(batch["tokens"])})
    pst = state_from_numpy(st, "cpu")
    tokens = torch.from_numpy(batch["tokens"])
    with torch.no_grad():
        plogits = pm.logits(pst["params"], tokens)
        ploss, pmet = pm.loss(pst["params"], {"tokens": tokens})
    assert plogits.dtype == torch.float32
    assert tuple(plogits.shape) == (2, 64, 512)
    np.testing.assert_allclose(plogits[:, -1].numpy(), np.asarray(jl),
                               rtol=0, atol=0.02)
    assert abs(float(ploss) - float(jloss)) < 2e-3
    assert float(pmet["aux_loss"]) > 0
    assert float(pmet["aux_loss"]) == pytest.approx(
        float(jmet["aux_loss"]), rel=1e-2)
    assert float(ploss) == pytest.approx(
        float(pmet["ce"]) + float(pmet["aux_loss"]), rel=1e-6)


def _record_choices(monkeypatch):
    """Both packages' expert choices, one (G, T, K) array a MoE call."""
    rec = {"jax": [], "port": []}
    real_topk = jax.lax.top_k
    real_route = port_moe.route

    def top_k(x, k):
        out = real_topk(x, k)
        rec["jax"].append((np.asarray(out[1]), np.asarray(x)))
        return out

    def route(lg, k):
        out = real_route(lg, k)
        rec["port"].append((out[2].numpy(), out[0].numpy()))
        return out

    monkeypatch.setattr(jax.lax, "top_k", top_k)
    monkeypatch.setattr(port_moe, "route", route)
    return rec


def _tainted(rec, k, rows):
    """Per MoE call, per batch row, the first token from which on the two
    packages' states may differ by a routing flip: a token whose choice
    differs first (asserted to be a near tie on the port's side: the
    k-th and (k+1)-th probabilities within 0.02), and every later token
    of its row in the calls after it (they attend to it)."""
    taint = [np.inf] * rows
    out = []
    for li, ((ji, _), (pi, pp)) in enumerate(zip(rec["jax"], rec["port"])):
        assert ji.shape == pi.shape
        out.append(list(taint))    # before this call's flips
        new = list(taint)
        diff = np.argwhere((np.sort(ji, -1) != np.sort(pi, -1)).any(-1))
        for g, t in diff:
            if t >= taint[g]:
                continue
            srt = np.sort(pp[g, t])[::-1]
            assert srt[k - 1] - srt[k] < 0.02, (li, g, t, srt)
            new[g] = min(new[g], t)
        taint = new
    out.append(taint)
    return out


def test_prefill_cache_matches_jax(monkeypatch, pair):
    """The prefill cache of every layer (``dense_first_0``, the stacked
    blocks): its tree, shapes and dtypes, the tail past the prompt zero,
    and every row within 0.08 of JAX's but those of tokens after a
    routing flip at a near tie (see the module doc)."""
    arch, jm, pm, st = pair
    jp = jax.tree.map(jnp.asarray, st["params"])
    pp = state_from_numpy(st, "cpu")["params"]
    toks = np.random.RandomState(0).randint(0, 512, (B, T)).astype(np.int32)
    rec = _record_choices(monkeypatch)
    with jax.disable_jit():    # the scan's body eagerly: choices concrete
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    pl, pc = pm.prefill(pp, {"tokens": torch.from_numpy(toks)},
                        cache_len=T + 5)
    assert len(rec["jax"]) == len(rec["port"]) == pm.n_stacked
    taint = _tainted(rec, pm.cfg.moe.top_k, B)
    compared = 0
    assert sorted(pc) == sorted(jc)
    spec = pm.cache_spec(B, T + 5)
    for part in pc:
        for name, s in spec[part].items():
            got = pc[part][name]
            assert tuple(got.shape) == s.shape and got.dtype == s.dtype
            want = np.asarray(jc[part][name], np.float32)
            got = got.float().numpy()
            stacked = part == "blocks"
            seq_axis = 2 if stacked else 1
            assert not np.take(got, range(T, T + 5), axis=seq_axis).any()
            got = np.take(got, range(T), axis=seq_axis)
            assert got.shape == want.shape
            if not stacked:
                assert _err(got, want) < 0.08
                continue
            for layer in range(want.shape[0]):
                # the stacked layer's entries come from the hidden states
                # after the MoE calls of the stacked layers before it
                for g in range(B):
                    end = int(min(taint[layer][g], T))
                    compared += end
                    assert _err(got[layer, g, :end], want[layer, g, :end]) \
                        < 0.08, (part, name, layer, g)
    # most of the stacked cache is compared
    assert compared > 0.8 * len(pc["blocks"]) * pm.n_stacked * B * T
    assert _err(pl.numpy(), jl) < 0.02


def test_teacher_forced_decode_tracks_jax(pair):
    """Prefill, then 5 decode steps teacher-forced on JAX's greedy tokens,
    the JAX cache grown by its server's ``_pad_cache_to``: logits within
    0.06 at every step."""
    _, jm, pm, st = pair
    jp = jax.tree.map(jnp.asarray, st["params"])
    pp = state_from_numpy(st, "cpu")["params"]
    toks = np.random.RandomState(0).randint(0, 512, (B, T)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    pl, pc = pm.prefill(pp, {"tokens": torch.from_numpy(toks)},
                        cache_len=T + 5)
    jc = _pad_cache_to(jc, jm, B, T + 5)
    for i in range(5):
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)[:, None]
        jl, jc = jm.decode_step(jp, jc, {"tokens": jnp.asarray(tok),
                                         "pos": jnp.int32(T + i)})
        pl, pc = pm.decode_step(pp, pc, {"tokens": torch.from_numpy(tok),
                                         "pos": T + i})
        assert _err(pl.numpy(), jl) < 0.06, i


@pytest.mark.parametrize("n_extra,tol", [(1, 0.06), (5, 0.1)])
def test_decode_matches_prefill_of_the_longer_prompt(pair, n_extra, tol):
    """The reduced configs drop no token (capacity factor 8.0), so one
    decode step (every expert densely; for MLA the absorbed form over the
    latent cache) continues the prefill."""
    _, _, pm, st = pair
    pp = state_from_numpy(st, "cpu")["params"]
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, 512, (B, T + n_extra)).astype(np.int32))
    _, cache = pm.prefill(pp, {"tokens": toks[:, :T]},
                          cache_len=T + n_extra)
    for i in range(n_extra):
        ld, cache = pm.decode_step(pp, cache, {
            "tokens": toks[:, T + i:][:, :1], "pos": T + i})
    lf, _ = pm.prefill(pp, {"tokens": toks})
    assert _err(ld.numpy(), lf.numpy()) < tol


def test_float32_decode_continues_the_prefill(pair):
    _, _, pm, st = pair
    pm = build_model(pm.cfg, compute_dtype=torch.float32)
    pp = state_from_numpy(st, "cpu")["opt"]["master"]
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, 512, (B, T + 1)).astype(np.int32))
    _, cache = pm.prefill(pp, {"tokens": toks[:, :T]}, cache_len=T + 1)
    for part in cache.values():
        assert all(t.dtype == torch.float32 for t in part.values())
    ld, _ = pm.decode_step(pp, cache, {"tokens": toks[:, T:], "pos": T})
    lf, _ = pm.prefill(pp, {"tokens": toks})
    assert _err(ld.numpy(), lf.numpy()) < 1e-4


def test_decode_past_the_cache_raises(pair):
    _, _, pm, st = pair
    pp = state_from_numpy(st, "cpu")["params"]
    toks = torch.zeros((B, 8), dtype=torch.int32)
    _, cache = pm.prefill(pp, {"tokens": toks})
    with pytest.raises(ValueError, match="past a cache of 8"):
        pm.decode_step(pp, cache, {"tokens": toks[:, :1], "pos": 8})


def _every_expert(arch):
    """The reduced config with every token routed to every expert: no
    choice can flip, so the trajectories meet the hybrid's bounds."""
    jc = jax_get_config(arch, reduced=True)
    jc = jc.model_copy(update={"moe": jc.moe.model_copy(
        update={"top_k": jc.moe.num_experts})})
    pc = get_config(arch, reduced=True)
    pc = pc.replace(moe=dataclasses.replace(pc.moe,
                                            top_k=pc.moe.num_experts))
    return jax_build_model(jc), build_model(pc)


@pytest.mark.parametrize("routing", ["every_expert", "published"])
def test_five_train_steps_track_jax(pair, routing):
    """Five steps at lr 3e-3 from JAX's initial state.  Routed to every
    expert (no choice can flip): every loss within 5e-3, the aux loss
    within 1e-3 relative and the global grad norm within 1% (the hybrid's
    bounds), the router's master within 2.5e-3.  The published top-k: every
    loss within 0.02 (the logits' bound) and the grad norm within 10% (a
    token whose choice flips at a near tie sends other gradients back; the
    first step's embedding gradients already differ by ~1%, and the flips
    grow with the states' drift)."""
    arch, jm, pm, st = pair
    if routing == "every_expert":
        jm, pm = _every_expert(arch)
        loss_tol, aux_rel, gn_rel = 5e-3, 1e-3, 1e-2
    else:
        loss_tol, aux_rel, gn_rel = 0.02, 0.1, 0.1
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
        assert abs(float(pmet["loss"]) - float(jmet["loss"])) < loss_tol, i
        assert float(pmet["aux_loss"].detach()) == pytest.approx(
            float(jmet["aux_loss"]), rel=aux_rel)
        assert float(pmet["grad_norm"]) == pytest.approx(
            float(jmet["grad_norm"]), rel=gn_rel)
    assert int(ps["step"]) == int(js["step"]) == 5
    if routing == "every_expert":
        # the router moves (the gates' and the aux loss's gradients reach
        # it) as in JAX: by up to ~1e-2 in 5 Adam steps (the sum of the
        # step sizes), within a quarter of that of JAX's (Adam's
        # normalisation magnifies the gradients' differences near zero)
        got = ps["opt"]["master"]["blocks"]["moe"]["router"].numpy()
        want = np.asarray(js["opt"]["master"]["blocks"]["moe"]["router"])
        moved = np.abs(want - st["opt"]["master"]["blocks"]["moe"]["router"])
        assert moved.max() > 9e-3
        np.testing.assert_allclose(got, want, rtol=0, atol=2.5e-3)


def test_prefill_and_decode_reach_flash_attention(pair, monkeypatch):
    """Prefill and every decode step reach ``flash_attention`` once per
    layer (MLA: the latent-expanded prefill and the absorbed decode);
    training reaches it never."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention

    _, _, pm, st = pair
    pp = state_from_numpy(st, "cpu")["params"]
    calls = []
    real = fa.flash_attention

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), tuple(v.shape),
                      kw.get("scale")))
        return real(q, k, v, **kw)

    monkeypatch.setattr(attention, "flash_attention", spy)
    toks = torch.zeros((B, 8), dtype=torch.int32)
    n = pm.cfg.num_layers
    _, cache = pm.prefill(pp, {"tokens": toks}, cache_len=9)
    assert len(calls) == n
    pm.decode_step(pp, cache, {"tokens": toks[:, :1], "pos": 8})
    assert len(calls) == 2 * n
    with torch.no_grad():
        pm.loss(pp, {"tokens": toks})
    assert len(calls) == 2 * n
    if pm.cfg.mla is not None:
        m = pm.cfg.mla
        h = pm.cfg.num_heads
        dqk = m.qk_nope_head_dim + m.qk_rope_head_dim
        r = m.kv_lora_rank + m.qk_rope_head_dim
        assert calls[0] == ((B, 8, h, dqk), (B, 8, h, dqk),
                            (B, 8, h, m.v_head_dim), None)
        assert calls[-1] == ((B, 1, h, r), (B, 9, 1, r),
                             (B, 9, 1, m.kv_lora_rank), dqk ** -0.5)


def test_mla_decode_reads_the_cache_rows_in_place(ds_pair):
    """The MLA cache is two views of one row buffer: a decode step writes
    one row and the kernel's K and V are views of it (no copy); a cache
    whose parts lie apart is refused."""
    from repro_torch.models.attention import mla_rows

    _, _, pm, st = ds_pair
    pp = state_from_numpy(st, "cpu")["params"]
    toks = torch.ones((B, 8), dtype=torch.int32)
    _, cache = pm.prefill(pp, {"tokens": toks}, cache_len=9)
    blocks = cache["blocks"]
    rows = mla_rows({k: v[0] for k, v in blocks.items()})
    assert rows.data_ptr() == blocks["latent"].data_ptr()
    r = pm.cfg.mla.kv_lora_rank
    before = rows.clone()
    _, out = pm.decode_step(pp, cache, {"tokens": toks[:, :1], "pos": 8})
    assert out["blocks"]["latent"] is blocks["latent"]
    assert torch.equal(rows[:, :8], before[:, :8])
    assert rows[:, 8, :r].any() and rows[:, 8, r:].any()
    # a cache whose parts lie apart (JAX's layout) would cost a copy of
    # every row at every step: refused
    sep = {k: v[0].clone() for k, v in blocks.items()}
    with pytest.raises(ValueError, match="one row buffer"):
        mla_rows(sep)
