"""The port's drift tracker and ``topk_delta`` policy against the JAX
package's, on the same JAX-initialised parameters (crossed to the port
through numpy, ``repro_torch.convert``).

Scores are ratios of float32 sums of squares taken in another order in
each package, so they agree to rtol 1e-4 (the drifts below move each
norm by ~1%, far above float32 rounding of the sums); an unchanged unit
scores exactly 0 in both.  Policy selections are compared exactly.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import LayerRegistry as JaxRegistry
from repro.core.delta import DeltaTracker as JaxTracker
from repro.core.policies import PolicyContext as JaxContext
from repro.core.policies import make_policy as jax_make_policy
from repro.launch import steps as jax_steps
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.convert import state_from_numpy
from repro_torch.core.delta import DeltaTracker
from repro_torch.core.layer_registry import LayerRegistry
from repro_torch.core.policies import PolicyContext, make_policy
from repro_torch.kernels.block_fp import fingerprint_tree, tree_to_host
from repro_torch.models import build_model

# The suite runs in several worker processes at once: one intra-op
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

SCORE_RTOL = 1e-4


def _sides(arch):
    jmodel = jax_build_model(jax_get_config(arch, reduced=True))
    model = build_model(get_config(arch, reduced=True))
    params = jax.tree.map(
        np.asarray, jax_steps.init_state(jmodel, jax.random.key(3))["params"])
    return jmodel, JaxRegistry(jmodel), model, LayerRegistry(model), params


def _drifted(params, how):
    """A copy of numpy params: the stacked block of index 1 scaled by 1.01
    ("scale"), its first row sign-flipped ("flip"), and the embedding
    scaled by 1.03."""
    out = jax.tree.map(np.array, params)
    for leaf in jax.tree.leaves(out["blocks"]):
        if how == "scale":
            leaf[1] = (leaf[1].astype(np.float32) * 1.01).astype(leaf.dtype)
        else:
            leaf[1] = -leaf[1]
    for leaf in jax.tree.leaves(out["embed"]):
        leaf[...] = (leaf.astype(np.float32) * 1.03).astype(leaf.dtype)
    return out


@pytest.mark.parametrize("arch", ["llama3.2-3b", "yi-9b"])
@pytest.mark.parametrize("how", ["scale", "flip"])
def test_scores_match_jax(arch, how):
    jmodel, jreg, model, reg, p0 = _sides(arch)
    p1 = _drifted(p0, how)
    jt, pt = JaxTracker(jreg), DeltaTracker(reg)
    jt.reset(p0)
    pt.reset(state_from_numpy(p0, "cpu"))
    js = jt.scores(p1)
    ps = pt.scores(state_from_numpy(p1, "cpu"))
    assert sorted(js) == sorted(ps) == sorted(reg.unit_names())
    for name in ps:
        np.testing.assert_allclose(ps[name], js[name], rtol=SCORE_RTOL,
                                   atol=0, err_msg=name)
    # untouched units score exactly 0, in both packages
    changed = {"block_001", "embed"}
    for name in set(ps) - changed:
        assert ps[name] == 0.0 == js[name], name
    for name in changed:
        assert ps[name] > 0.0
    if how == "flip":
        # a norm-preserving change is seen only by the dirty-fraction term
        assert 0 < ps["block_001"] < 1e-6


def test_reference_lifecycle():
    """mark_saved advances the saved units' references; set_reference
    takes snapshot fingerprints (host tables) as the overlapped saver
    hands them over."""
    _, _, model, reg, p0 = _sides("llama3.2-3b")
    t0 = state_from_numpy(p0, "cpu")
    t1 = state_from_numpy(_drifted(p0, "scale"), "cpu")
    tr = DeltaTracker(reg)
    tr.reset(t0)
    assert tr.scores(t1)["block_001"] > 0
    tr.mark_saved(t1, ["block_001"])
    s = tr.scores(t1)
    assert s["block_001"] == 0.0 and s["embed"] > 0
    snap = tree_to_host(fingerprint_tree(reg.extract_unit(t1, "embed")))
    tr.set_reference("embed", snap)
    assert tr.scores(t1)["embed"] == 0.0


def _policies(arch):
    jmodel = jax_build_model(jax_get_config(arch, reduced=True))
    model = build_model(get_config(arch, reduced=True))
    return (jax_make_policy("topk_delta", jmodel.layer_units()),
            make_policy("topk_delta", model.layer_units()))


@pytest.mark.parametrize("arch", ["llama3.2-3b", "yi-9b"])
@pytest.mark.parametrize("seed", range(4))
def test_topk_delta_selects_like_jax(arch, seed):
    jp, pp = _policies(arch)
    rs = np.random.RandomState(seed)
    names = pp.all_units()
    # well separated scores, built in a shuffled order
    vals = rs.permutation(len(names)).astype(float) * 0.1 + 0.05
    scores = {n: float(v) for n, v in zip(rs.permutation(names), vals)}
    for idx in range(3):
        want = jp.select(JaxContext(event_index=idx, step=10 * idx,
                                    drift_scores=scores))
        got = pp.select(PolicyContext(event_index=idx, step=10 * idx,
                                      drift_scores=scores))
        assert got == want
        k = max(1, int(len(pp.blocks) * 0.5))
        assert got[k:] == pp.aux
        ranked = sorted(pp.blocks, key=lambda b: -scores[b])
        assert got[:k] == ranked[:k]


def test_topk_delta_ties_and_fallback():
    jp, pp = _policies("yi-9b")
    # no scores: parity, like the JAX policy
    for idx in range(2):
        for scores in (None, {}):
            assert pp.select(PolicyContext(idx, 0, scores)) == \
                jp.select(JaxContext(idx, 0, scores))
    # all tied: registry block order, whatever order the dict was built in
    tied = {b: 1.0 for b in reversed(pp.blocks)}
    k = max(1, int(len(pp.blocks) * 0.5))
    assert pp.select(PolicyContext(0, 0, tied))[:k] == pp.blocks[:k]
    assert pp.select(PolicyContext(0, 0, tied)) == \
        jp.select(JaxContext(0, 0, tied))
