"""Dense model and train step of the port against the JAX package, with
JAX-initialized params handed over through numpy (``repro_torch.convert``).

Tolerances (bf16 activations, float32 statistics and logits): logits
within 0.02 absolute (a few bf16 ulps at |logit| < 1), loss within 2e-3,
and over 5 train steps on SyntheticTokens batches every loss within 5e-3
and every global grad norm within 1% of the JAX trajectory.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.data.synthetic import SyntheticTokens
from repro.launch import steps as jax_steps
from repro.models import build_model as jax_build_model
from repro.optim.groups import build_group_spec as jax_group_spec
from repro.optim.groups import decay_mask as jax_decay_mask
from repro_torch.checkpoint.serial import flatten_with_paths
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.convert import state_from_numpy
from repro_torch.launch import steps
from repro_torch.models import build_model
from repro_torch.optim import build_group_spec, decay_mask

# The suite runs in several worker processes at once: one intra-op
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

ARCHS = ["llama3.2-3b", "yi-9b"]  # tied and untied embeddings


def _pair(arch):
    jm = jax_build_model(jax_get_config(arch, reduced=True))
    pm = build_model(get_config(arch, reduced=True))
    st = jax.tree.map(np.asarray, jax_steps.init_state(jm,
                                                       jax.random.key(0)))
    return jm, pm, st


@pytest.mark.parametrize("arch", ARCHS)
def test_structure_matches(arch):
    jm, pm, st = _pair(arch)
    jflat = [(p, tuple(a.shape)) for p, a in flatten_with_paths(st["params"])]
    pflat = [(p, tuple(s.shape))
             for p, s in flatten_with_paths(pm.param_specs())]
    assert pflat == jflat
    assert ([(u.name, u.path, u.index, u.kind) for u in pm.layer_units()]
            == [(u.name, u.path, u.index, u.kind) for u in jm.layer_units()])
    pg = build_group_spec(pm, weight_decay=0.1).groups
    jg = jax_group_spec(jm, weight_decay=0.1).groups
    assert [(g.index, g.unit, g.decay, g.paths, g.weight_decay) for g in pg] \
        == [(g.index, g.unit, g.decay, g.paths, g.weight_decay) for g in jg]
    assert flatten_with_paths(decay_mask(pm)) == [
        (p, bool(v)) for p, v in flatten_with_paths(jax_decay_mask(jm))]


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_and_loss_match(arch):
    jm, pm, st = _pair(arch)
    batch = SyntheticTokens(vocab_size=512, batch=2, seq_len=64,
                            seed=1).peek(0)
    params = jax.tree.map(jnp.asarray, st["params"])
    h, pos = jm._embed(params, batch)
    h, _ = jm._backbone_train(params, h, pos)
    jlogits = np.asarray(jm._logits(params, h))
    jloss = float(jm.loss(params, batch)[0])
    pst = state_from_numpy(st, "cpu")
    tokens = torch.from_numpy(batch["tokens"])
    with torch.no_grad():
        plogits = pm.logits(pst["params"], tokens).numpy()
        ploss = float(pm.loss(pst["params"], {"tokens": tokens})[0])
    assert plogits.dtype == np.float32
    np.testing.assert_allclose(plogits, jlogits, rtol=0, atol=0.02)
    assert abs(ploss - jloss) < 2e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_five_train_steps_track_jax(arch):
    jm, pm, st = _pair(arch)
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
        assert pmet["lr"] == pytest.approx(float(jmet["lr"]), rel=1e-6)
    assert int(ps["step"]) == int(js["step"]) == 5
    np.testing.assert_allclose(
        ps["opt"]["master"]["final_norm"]["scale"].numpy(),
        np.asarray(js["opt"]["master"]["final_norm"]["scale"]),
        rtol=0, atol=1e-3)


def test_remat_does_not_change_the_loss():
    pm = build_model(get_config("yi-9b", reduced=True))
    pm_nr = build_model(get_config("yi-9b", reduced=True).replace(
        remat="none"))
    st = steps.init_state(pm, 0, torch.device("cpu"))
    tokens = torch.from_numpy(SyntheticTokens(vocab_size=512, batch=2,
                                              seq_len=32).peek(0)["tokens"])
    grads = []
    for model in (pm, pm_nr):
        for p in jax.tree.leaves(st["params"]):
            p.requires_grad_(True)
            p.grad = None
        loss, _ = model.loss(st["params"], {"tokens": tokens})
        loss.backward()
        grads.append(st["params"]["blocks"]["attn"]["wq"].grad.clone())
    assert torch.equal(grads[0], grads[1])
