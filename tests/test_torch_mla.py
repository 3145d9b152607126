"""Multi-head latent attention of the port (``repro_torch/models/
attention.py``: ``mla_forward``, its cache) and ``flash_attention`` at
split head dims (Dv != Dqk, a softmax scale of the caller's) against the
JAX package on the CPU, at the reduced DeepSeek-V2-Lite's sizes (Dqk 48 /
Dv 32 at prefill, 80 / 64 in the absorbed decode) and at full width's
(192 / 128, 576 / 512) for the plain version.

Tolerances: the plain version in float32 within 5e-5 of a float64 numpy
oracle and of JAX's ``attend`` (float32 sums of up to 576 products;
scores reach ~70 at scale 1); in bf16 within two bf16 ulps of each value
plus one ulp of the largest output (``_bf16_close``).  ``mla_forward`` at
prefill within ``_bf16_close`` (outputs up to ~8, where an ulp is
0.03).  The absorbed decode within 0.06: the JAX package rounds the
softmax weights to bf16 before ``w . latent`` (``attention.py:309``),
the kernel and its plain version keep them in float32, which moves a
context vector by up to half a bf16 ulp of the weights times the
latent's magnitude (~4 here), and ``w_uv`` and ``wo`` carry it on.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attn
from repro.models.modules import ParamBuilder
from repro_torch.configs import get_config
from repro_torch.convert import state_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as port_attn
from repro_torch.models.model_api import TensorSpec

torch.set_num_threads(2)

DS = "deepseek-v2-lite-16b"


def _t(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _oracle(q, k, v, causal, scale):
    """float64 attention: q (B,Sq,H,Dqk), k (B,Sk,G,Dqk), v (B,Sk,G,Dv)."""
    q, k, v = (np.asarray(x, np.float64) for x in (q, k, v))
    b, sq, h, _ = q.shape
    g = k.shape[2]
    r = h // g
    qg = q.reshape(b, sq, g, r, -1)
    s = np.einsum("bqgrd,bkgd->bgrqk", qg, k) * scale
    if causal:
        mask = np.arange(sq)[:, None] < np.arange(k.shape[1])[None, :]
        s = np.where(mask, -np.inf, s)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    out = np.einsum("bgrqk,bkgd->bqgrd", p, v)
    return out.reshape(b, sq, h, v.shape[-1])


def _inputs(seed, b, sq, sk, h, g, dqk, dv, dtype):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, sq, h, dqk).astype(dtype)
    k = rng.randn(b, sk, g, dqk).astype(dtype)
    v = rng.randn(b, sk, g, dv).astype(dtype)
    return q, k, v


def _bf16_close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               rtol=2.0 ** -7,
                               atol=2.0 ** -8 * float(np.abs(want).max()))


SPLIT = [  # (B, Sq, Sk, H, G, Dqk, Dv, causal)
    (2, 40, 40, 4, 4, 48, 32, True),        # reduced MLA prefill
    (2, 1, 41, 4, 1, 80, 64, False),        # reduced absorbed decode
    (1, 64, 64, 16, 16, 192, 128, True),    # full-width MLA prefill
    (2, 1, 70, 16, 1, 576, 512, False),     # full-width absorbed decode
    (1, 30, 50, 8, 2, 48, 32, False),       # GQA, Sq < Sk
]


@pytest.mark.parametrize("case", SPLIT, ids=[f"{c[5]}-{c[6]}-{c[1]}x{c[2]}"
                                             for c in SPLIT])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_split_head_dims_match_jax_attend_and_oracle(case, dtype):
    """Dv != Dqk at the default scale (Dqk ** -0.5): JAX's ``attend`` (the
    model's path; top-left causal) and the float64 oracle."""
    b, sq, sk, h, g, dqk, dv, causal = case
    npdt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    q, k, v = _inputs(sum(case), b, sq, sk, h, g, dqk, dv, npdt)
    got = fa.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert tuple(got.shape) == (b, sq, h, dv)
    assert got.dtype == (torch.float32 if dtype == "float32"
                         else torch.bfloat16)
    jout = jax_attn.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal)
    want64 = _oracle(q, k, v, causal, dqk ** -0.5)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(jout),
                                   rtol=0, atol=5e-5)
        np.testing.assert_allclose(got.numpy(), want64, rtol=0, atol=5e-5)
    else:
        _bf16_close(got.float().numpy(), jnp.asarray(jout, jnp.float32))
        _bf16_close(got.float().numpy(), want64)


@pytest.mark.parametrize("scale", [192 ** -0.5, 0.05, 1.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_scale_argument(scale, dtype):
    """``scale=`` replaces Dqk ** -0.5 (the absorbed decode's 192 ** -0.5
    over 576 columns), held to the float64 oracle at that scale."""
    npdt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    q, k, v = _inputs(11, 2, 1, 70, 16, 1, 576, 512, npdt)
    got = fa.flash_attention(_t(q), _t(k), _t(v), causal=False, scale=scale)
    want = _oracle(q, k, v, False, np.float32(scale))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-5)
    else:
        _bf16_close(got.float().numpy(), want)
    default = fa.flash_attention(_t(q), _t(k), _t(v), causal=False)
    same = fa.flash_attention(_t(q), _t(k), _t(v), causal=False,
                              scale=576 ** -0.5)
    assert torch.equal(default, same)


def test_wrapper_head_dim_table():
    """Every route takes the symmetric head dims; MLA's split pairs go
    where the model sends them: (192, 128) prefill and float32, (576, 512)
    decode and float32."""
    ops = fa.ops
    for route in ops.ROUTES:
        for d in ops.HEAD_DIMS:
            assert ops.takes_head_dims(route, d, d)
    assert ops.takes_head_dims("prefill", 192, 128)
    assert ops.takes_head_dims("f32", 192, 128)
    assert ops.takes_head_dims("decode", 576, 512)
    assert ops.takes_head_dims("f32", 576, 512)
    assert not ops.takes_head_dims("decode", 192, 128)
    assert not ops.takes_head_dims("prefill", 576, 512)
    assert not ops.takes_head_dims("prefill", 48, 32)   # reduced: CPU only
    assert ops._SCALES[192] == np.float32(192 ** -0.5)


def test_shapes_are_checked():
    q = torch.zeros(1, 4, 2, 48)
    with pytest.raises(ValueError, match="Dv"):
        fa.flash_attention(q, torch.zeros(1, 4, 2, 48),
                           torch.zeros(1, 5, 2, 32))
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, torch.zeros(1, 4, 2, 40),
                           torch.zeros(1, 4, 2, 32))
    with pytest.raises(ValueError, match="CUDA"):
        fa.ops.launch(q, torch.zeros(1, 4, 2, 48), torch.zeros(1, 4, 2, 32),
                      True, "prefill")


# --------------------------------------------------------- mla_forward
@pytest.fixture(scope="module")
def mla():
    jc = jax_get_config(DS, reduced=True)
    pc = get_config(DS, reduced=True)
    b = ParamBuilder(jax.random.key(3))
    jax_attn.init_mla(b, jc)
    p = jax.tree.map(np.asarray, b.params)
    return jc, pc, p


def _x(seed, s, d=128):
    return (np.random.RandomState(seed).randn(2, s, d) * 0.5).astype(
        ml_dtypes.bfloat16)


def test_mla_leaves_and_cache_spec_match_jax(mla):
    jc, pc, p = mla
    leaves = port_attn.mla_leaves(pc)
    assert {k: v[0] for k, v in leaves.items()} == {
        k: tuple(a.shape) for k, a in p.items()}
    jspec = jax_attn.mla_cache_spec(jc, 2, 9)
    pspec = port_attn.mla_cache_spec(pc, 2, 9, torch.bfloat16)
    assert {k: tuple(s.shape) for k, s in jspec.items()} == {
        k: s.shape for k, s in pspec.items()}
    assert all(isinstance(s, TensorSpec) for s in pspec.values())
    cache = port_attn.mla_cache(pc, (3,), 2, 9, torch.bfloat16,
                                torch.device("cpu"))
    assert tuple(cache["latent"].shape) == (3, 2, 9, 64)
    assert tuple(cache["rope"].shape) == (3, 2, 9, 16)
    assert cache["rope"].data_ptr() == cache["latent"].data_ptr() + 128


@pytest.mark.parametrize("return_kv", [False, True])
def test_mla_prefill_matches_jax(mla, return_kv):
    """Training (``attend``) and prefill (``flash_attention``'s plain
    version at Dqk 48 / Dv 32): the output, the latent and the RoPE key
    within ``_bf16_close``."""
    jc, pc, p = mla
    x = _x(1, 24)
    pos = np.arange(24)
    jy, jkv = jax_attn.mla_forward(jax.tree.map(jnp.asarray, p),
                                   jnp.asarray(x), jc,
                                   positions=jnp.asarray(pos),
                                   return_kv=True)
    py, pkv = port_attn.mla_forward(state_from_numpy(p, "cpu"), _t(x), pc,
                                    positions=torch.from_numpy(pos),
                                    return_kv=return_kv)
    assert py.dtype == torch.bfloat16 and tuple(py.shape) == x.shape
    _bf16_close(py.float().numpy(), jnp.asarray(jy, jnp.float32))
    if return_kv:
        for name in ("latent", "rope"):
            _bf16_close(pkv[name].float().numpy(),
                        jnp.asarray(jkv[name], jnp.float32))
    else:
        assert pkv is None


def test_mla_absorbed_decode_matches_jax(mla):
    """Prefill 24 tokens, then one absorbed decode step at position 24
    over a cache of 26 rows in both packages: the output within 0.06 (see
    the module doc), the written row within two bf16 ulps, the rows past
    it untouched."""
    jc, pc, p = mla
    x = _x(2, 25)
    pos = np.arange(25)
    jp = jax.tree.map(jnp.asarray, p)
    pp = state_from_numpy(p, "cpu")
    _, jkv = jax_attn.mla_forward(jp, jnp.asarray(x[:, :24]), jc,
                                  positions=jnp.asarray(pos[:24]),
                                  return_kv=True)
    jcache = {k: jnp.pad(v, ((0, 0), (0, 2), (0, 0)))
              for k, v in jkv.items()}
    jy, jnew = jax_attn.mla_forward(jp, jnp.asarray(x[:, 24:]), jc,
                                    positions=jnp.asarray(pos[24:]),
                                    cache=jcache, cache_pos=jnp.int32(24))
    cache = port_attn.mla_cache(pc, (), 2, 26, torch.bfloat16,
                                torch.device("cpu"))
    _, pkv = port_attn.mla_forward(pp, _t(x[:, :24]), pc,
                                   positions=torch.arange(24),
                                   return_kv=True)
    for k in ("latent", "rope"):
        cache[k][:, :24] = pkv[k]
    py, out = port_attn.mla_forward(pp, _t(x[:, 24:]), pc,
                                    positions=torch.tensor([24]),
                                    cache=cache, cache_pos=24)
    assert out is cache
    assert float(np.abs(py.float().numpy()
                        - np.asarray(jy, np.float32)).max()) < 0.06
    for k in ("latent", "rope"):
        _bf16_close(cache[k][:, 24].float().numpy(),
                    jnp.asarray(jnew[k][:, 24], jnp.float32))
        assert not cache[k][:, 25].any()


def test_mla_decode_past_the_cache_raises(mla):
    _, pc, p = mla
    cache = port_attn.mla_cache(pc, (), 2, 4, torch.bfloat16,
                                torch.device("cpu"))
    with pytest.raises(ValueError, match="past a cache of 4"):
        port_attn.mla_forward(state_from_numpy(p, "cpu"), _t(_x(3, 1)), pc,
                              positions=torch.tensor([4]), cache=cache,
                              cache_pos=4)
