"""The port's flash attention (its plain version, which CPU tensors take)
against the JAX package's Pallas kernel run in interpret mode, its oracle
and the JAX model's decode attention.

Inputs come from numpy with a seed and go to both packages (bf16 as the
same bits).  Tolerances: bf16 atol = rtol = 2e-2 and float32 2e-5, as the
JAX package's kernel tests hold its Pallas kernel: both compute one float32
function, summed in another order.  The causal mask of the kernels is
top-left (query i sees keys 0..i), the oracle ``attention_ref`` masks
bottom-right, so causal results are held against the oracle only at
``Sq == Sk``.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models.attention import attend as jax_attend
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.attention import attend

torch.set_num_threads(1)

TOL = {"bfloat16": 2e-2, "float32": 2e-5}


def _inputs(seed, b, sq, sk, h, g, d, dtype):
    rs = np.random.RandomState(seed)
    arrs = [rs.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, sk, g, d), (b, sk, g, d))]
    if dtype == "bfloat16":
        arrs = [a.astype(ml_dtypes.bfloat16) for a in arrs]
    return arrs


def _to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _port(q, k, v, causal):
    out = fa.flash_attention(_to_torch(q), _to_torch(k), _to_torch(v),
                             causal=causal)
    return out.to(torch.float32).numpy()


def _close(got, want, dtype):
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


# the shapes of tests/test_kernels.py's flash-attention sweep
@pytest.mark.parametrize("b,s,h,g,d,blk,dtype", [
    (1, 128, 4, 4, 64, 64, "bfloat16"),
    (2, 128, 4, 2, 64, 32, "bfloat16"),
    (1, 256, 8, 1, 128, 128, "bfloat16"),
    (2, 64, 2, 2, 32, 64, "float32"),
])
def test_plain_matches_pallas_kernel_causal(b, s, h, g, d, blk, dtype):
    q, k, v = _inputs(s + h, b, s, s, h, g, d, dtype)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True, block_q=blk, block_k=blk, interpret=True)
    _close(_port(q, k, v, True), want, dtype)
    # Sq == Sk: the oracle's bottom-right mask is the top-left one
    _close(_port(q, k, v, True),
           attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=True), dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_plain_matches_pallas_kernel_non_causal_cross_len(dtype):
    q, k, v = _inputs(0, 2, 64, 192, 4, 2, 64, dtype)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=False, block_q=64, block_k=64, interpret=True)
    _close(_port(q, k, v, False), want, dtype)
    _close(_port(q, k, v, False),
           attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=False), dtype)


@pytest.mark.parametrize("sq,sk", [(32, 128), (64, 96)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_causal_short_query_is_top_left(sq, sk, dtype):
    """Causal with Sq < Sk: query i sees keys 0..i, as the Pallas kernel
    masks (its oracle would let it see keys 0..i + Sk - Sq)."""
    q, k, v = _inputs(3, 1, sq, sk, 4, 2, 64, dtype)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True, block_q=32, block_k=32, interpret=True)
    got = _port(q, k, v, True)
    _close(got, want, dtype)
    # the first query attends to key 0 alone: it returns v[:, 0]
    np.testing.assert_allclose(
        got[:, 0], np.repeat(np.asarray(v[:, 0], np.float32), 2, axis=1),
        atol=TOL[dtype], rtol=TOL[dtype])


def test_plain_matches_pallas_kernel_property_sweep():
    rs = np.random.RandomState(11)
    for i in range(5):
        d = int(rs.choice([32, 64]))
        g = int(rs.choice([1, 2, 4]))
        h = g * int(rs.choice([1, 2]))
        s = int(rs.choice([64, 128]))
        b = int(rs.randint(1, 3))
        q, k, v = _inputs(100 + i, b, s, s, h, g, d, "bfloat16")
        want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=True, block_q=32, block_k=32, interpret=True)
        np.testing.assert_allclose(_port(q, k, v, True),
                                   np.asarray(want, np.float32), atol=3e-2,
                                   rtol=3e-2)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("pos", [0, 37, 63])
def test_decode_on_a_cache_prefix_matches_the_jax_model(dtype, pos):
    """Decode: one query over the first pos + 1 positions of a cache (a
    strided view of it, no copy) against the JAX model's attend over the
    whole padded cache with ``k_valid = pos + 1``.  The JAX jnp path rounds
    the scaled q and the softmax weights to bf16, the kernel's function
    keeps them in float32: bf16 within 2e-2, float32 within 2e-5."""
    b, s, h, g, d = 2, 64, 8, 2, 64
    q, kc, vc = _inputs(pos, b, 1, s, h, g, d, dtype)
    want = jax_attend(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                      causal=False, k_valid=pos + 1)
    cache = torch.stack([_to_torch(kc), _to_torch(vc)], dim=2)
    k, v = cache[:, :pos + 1, 0], cache[:, :pos + 1, 1]
    assert not k.is_contiguous()
    got = fa.flash_attention(_to_torch(q), k, v, causal=False)
    _close(got.to(torch.float32).numpy(), want, dtype)


def test_model_attend_k_valid_matches_jax():
    """The port's plain ``attend`` (the training path) with ``k_valid``
    against the JAX model's, float32."""
    q, k, v = _inputs(5, 2, 4, 32, 4, 2, 32, "float32")
    want = jax_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=True, q_offset=20, k_valid=24)
    got = attend(torch.from_numpy(q), torch.from_numpy(k),
                 torch.from_numpy(v), causal=True, q_offset=20, k_valid=24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_cpu_tensors_never_launch_the_kernel():
    q, k, v = (_to_torch(a) for a in _inputs(1, 1, 8, 8, 4, 2, 64,
                                             "bfloat16"))
    before = fa.KERNEL.launches
    out = fa.flash_attention(q, k, v, causal=True)
    assert fa.KERNEL.launches == before
    assert out.dtype == torch.bfloat16 and out.shape == q.shape


@pytest.mark.parametrize("shapes", [
    ((1, 8, 4, 64), (1, 8, 3, 64)),     # H % G != 0
    ((1, 8, 4, 64), (2, 8, 2, 64)),     # batch differs
    ((1, 8, 4, 64), (1, 8, 2, 32)),     # head dim differs
    ((1, 8, 4, 64), (1, 0, 2, 64)),     # no keys
])
def test_wrapper_rejects_mismatched_shapes(shapes):
    qs, ks = shapes
    with pytest.raises(ValueError):
        fa.flash_attention(torch.zeros(qs), torch.zeros(ks), torch.zeros(ks))
