"""fused_adamw in the port against the JAX package: the plain PyTorch
version (what CPU tensors run) against the Pallas kernel in interpret mode
and against ``optim/adamw.adamw_update``, over several steps, with weight
decay on and off.

Tolerances: master/m/v are float32 results of the same formula evaluated
with another operation order (rtol 1e-5, atol 1e-7 — a few ulp); the bf16
params must equal bf16(master) exactly and the JAX params within one bf16
ulp (rtol 2**-7).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.fused_adamw import fused_adamw as jax_fused_adamw
from repro.optim.adamw import AdamWConfig, adamw_update
from repro_torch.kernels.fused_adamw import fused_adamw, fused_adamw_plain

# The suite runs in several worker processes at once: one intra-op
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-7
B1, B2, EPS = 0.9, 0.95, 1e-8


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    master = (rng.standard_normal(shape) * 0.02).astype(np.float32)
    m = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
    v = (rng.rand(*shape) * 1e-6).astype(np.float32)
    return master, m, v


def _grad(shape, seed):
    rng = np.random.RandomState(1000 + seed)
    return (rng.standard_normal(shape) * 1e-2).astype(ml_dtypes.bfloat16)


def _t(a):
    a = np.ascontiguousarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("shape", [(37,), (16, 33), (4, 8, 5), (256,)])
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_plain_matches_pallas_over_steps(shape, wd):
    master, m, v = _inputs(shape, seed=len(shape))
    tm, tmm, tv = _t(master), _t(m), _t(v)
    tp = tm.to(torch.bfloat16)
    jm, jmm, jv = jnp.asarray(master), jnp.asarray(m), jnp.asarray(v)
    one = torch.ones(1)
    for step in range(3):
        g = _grad(shape, step)
        lr = 1e-3 * (step + 1)
        fused_adamw([_t(g)], [tm], [tmm], [tv], [tp], [wd], lr=lr, b1=B1,
                    b2=B2, eps=EPS, step=step, gscale=one)
        jp, jm, jmm, jv = jax_fused_adamw(jnp.asarray(g), jm, jmm, jv,
                                          lr=lr, step=step, b1=B1, b2=B2,
                                          eps=EPS, wd=wd, interpret=True)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), RTOL, ATOL)
        np.testing.assert_allclose(tmm.numpy(), np.asarray(jmm), RTOL, ATOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), RTOL, ATOL)
        assert torch.equal(tp, tm.to(torch.bfloat16))
        np.testing.assert_allclose(tp.to(torch.float32).numpy(),
                                   np.asarray(jp).astype(np.float32),
                                   rtol=2**-7, atol=0)


def test_multi_leaf_unit_matches_adamw_update_with_clip():
    """A unit of leaves with per-leaf weight decay and a clip factor folded
    in, against the JAX package's jnp update on pre-scaled grads."""
    shapes = {"w": (8, 12), "ln": (12,), "u": (3, 4, 5)}
    decay = {"w": True, "ln": False, "u": True}
    cfg = AdamWConfig(b1=B1, b2=B2, eps=EPS, weight_decay=0.1)
    scale = np.float32(0.37)
    state = {k: _inputs(s, seed=i) for i, (k, s) in enumerate(shapes.items())}
    opt = {"master": {k: jnp.asarray(v[0]) for k, v in state.items()},
           "m": {k: jnp.asarray(v[1]) for k, v in state.items()},
           "v": {k: jnp.asarray(v[2]) for k, v in state.items()}}
    keys = list(shapes)
    tmaster = [_t(state[k][0]) for k in keys]
    tm = [_t(state[k][1]) for k in keys]
    tv = [_t(state[k][2]) for k in keys]
    tp = [x.to(torch.bfloat16) for x in tmaster]
    wds = [0.1 if decay[k] else 0.0 for k in keys]
    for step in range(4):
        grads = {k: _grad(s, 10 * step + i)
                 for i, (k, s) in enumerate(shapes.items())}
        lr = 5e-4
        fused_adamw([_t(grads[k]) for k in keys], tmaster, tm, tv, tp, wds,
                    lr=lr, b1=B1, b2=B2, eps=EPS, step=step,
                    gscale=torch.tensor([float(scale)]))
        jg = {k: jnp.asarray(g).astype(jnp.float32) * scale
              for k, g in grads.items()}
        jp, opt = adamw_update(jg, opt, lr=jnp.float32(lr),
                               step=jnp.int32(step), cfg=cfg,
                               decay_mask=decay)
        for i, k in enumerate(keys):
            np.testing.assert_allclose(tmaster[i].numpy(),
                                       np.asarray(opt["master"][k]),
                                       RTOL, ATOL)
            np.testing.assert_allclose(tm[i].numpy(), np.asarray(opt["m"][k]),
                                       RTOL, ATOL)
            np.testing.assert_allclose(tv[i].numpy(), np.asarray(opt["v"][k]),
                                       RTOL, ATOL)


def test_plain_version_accepts_float32_grads():
    master, m, v = _inputs((50,), seed=3)
    g = np.asarray(_grad((50,), 3)).astype(np.float32)
    a = [_t(master), _t(m), _t(v)]
    b = [_t(master), _t(m), _t(v)]
    pa = a[0].to(torch.bfloat16)
    pb = b[0].to(torch.bfloat16)
    one = torch.ones(1)
    kw = dict(lr=1e-3, b1=B1, b2=B2, eps=EPS, step=0, gscale=one)
    fused_adamw_plain([_t(g)], [a[0]], [a[1]], [a[2]], [pa], [0.1], **kw)
    fused_adamw_plain([_t(g).to(torch.bfloat16)], [b[0]], [b[1]], [b[2]],
                      [pb], [0.1], **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)  # g is exactly bf16-representable
    assert jax.default_backend() == "cpu"
