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


# ---------------------------------------------------------------------------
# The CUDA kernel's design on the CPU: its numerics (the prefill route's
# P.V on bf16 tensor cores) and its split-K decode route, as models held
# against attention_plain.

MAIN_RTOL, MAIN_ATOL, MAIN_MISMATCH = 2.0 ** -6, 1e-5, 0.01  # chip_smoke's


def _two_ulp_check(got, want):
    """chip_smoke.py's serve-shape check: each element within two bf16 ulps
    of attention_plain's (|d| <= 2**-6 |want| + 1e-5), at most 1% of the
    elements differing at all.  Returns (worst share of limit, mismatch
    share, passes)."""
    g, w = got.float(), want.float()
    worst = ((g - w).abs() / (MAIN_RTOL * w.abs() + MAIN_ATOL)).max().item()
    mismatch = (g != w).float().mean().item()
    return worst, mismatch, worst <= 1.0 and mismatch <= MAIN_MISMATCH


def _round_tf32(x):
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tiled_kernel_model(q, k, v, p_as, tile=64):
    """The prefill kernel's arithmetic: an online softmax over key tiles
    with float32 scores of the bf16 operands, the scale applied to the
    scores after q.k, the causal mask top-left, and p entering P.V as
    ``p_as`` says: "f32", "hi+lo" (bf16(p) and bf16(p - bf16(p)), two
    products), "tf32" or "bf16".  Products of bf16-exact factors summed in
    float32, as the tensor cores do."""
    b, sq, h, d = q.shape
    sk, g = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, sq, g, h // g, d)
    kf, vf = k.float(), v.float()
    m = torch.full((b, g, h // g, sq), fa.NEG_INF)
    den = torch.zeros_like(m)
    acc = torch.zeros(b, g, h // g, sq, d)
    q_pos = torch.arange(sq)
    for k0 in range(0, sk, tile):
        kt, vt = kf[:, k0:k0 + tile], vf[:, k0:k0 + tile]
        s = torch.einsum("bqgrd,bkgd->bgrqk", qf, kt) * fa.softmax_scale(d)
        k_pos = torch.arange(k0, k0 + kt.shape[1])
        s = s.masked_fill(q_pos[:, None] < k_pos[None, :], fa.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        den = den * alpha + p.sum(-1)
        m = m_new
        if p_as == "hi+lo":
            hi = p.to(torch.bfloat16).float()
            parts = [hi, (p - hi).to(torch.bfloat16).float()]
        elif p_as == "tf32":
            parts = [_round_tf32(p)]
        elif p_as == "bf16":
            parts = [p.to(torch.bfloat16).float()]
        else:
            parts = [p]
        pv = sum(torch.einsum("bgrqk,bkgd->bgrqd", x, vt) for x in parts)
        acc = acc * alpha[..., None] + pv
    out = acc / den.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


@pytest.mark.parametrize("p_as,passes", [
    ("f32", True), ("hi+lo", True), ("tf32", False), ("bf16", False)])
def test_p_needs_16_bits_to_pass_the_two_ulp_check(p_as, passes):
    """Why the prefill route splits p into bf16 hi + lo: with p rounded to
    bf16 (as SDPA does) or to TF32, the output leaves two bf16 ulps of
    attention_plain on many elements; hi + lo keeps it as float32 p does."""
    q, k, v = (_to_torch(a) for a in _inputs(21, 1, 256, 256, 4, 1, 64,
                                             "bfloat16"))
    want = fa.attention_plain(q, k, v, causal=True)
    worst, mismatch, ok = _two_ulp_check(
        _tiled_kernel_model(q, k, v, p_as), want)
    assert ok == passes, (p_as, worst, mismatch)
    if passes:
        assert worst < 0.75 and mismatch < 0.005
    else:
        assert worst > 2.0 and mismatch > 0.02


def _split_k_model(q, k, v, causal, split_len):
    """The decode route: each slice of ``split_len`` keys gives (m, l, acc)
    in float32, a second pass merges them:
    out = sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s, 1e-30)."""
    b, sq, h, d = q.shape
    sk, g = k.shape[1], k.shape[2]
    qs = q.float().reshape(b, sq, g, h // g, d) * fa.softmax_scale(d)
    parts = []
    for k0 in range(0, sk, split_len):
        kt, vt = k[:, k0:k0 + split_len].float(), v[:, k0:k0 + split_len]
        s = torch.einsum("bqgrd,bkgd->bgrqk", qs, kt)
        if causal:
            k_pos = torch.arange(k0, k0 + kt.shape[1])
            s = s.masked_fill(torch.arange(sq)[:, None] < k_pos[None, :],
                              fa.NEG_INF)
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        if causal:   # masked keys weigh 0 even where the whole slice is
            p = p.masked_fill(s <= fa.NEG_INF, 0.0)
        parts.append((m, p.sum(-1),
                      torch.einsum("bgrqk,bkgd->bgrqd", p, vt.float())))
    big = torch.stack([m for m, _, _ in parts]).amax(0)
    wts = [torch.exp(m - big) for m, _, _ in parts]
    den = sum(w * l for w, (_, l, _) in zip(wts, parts))
    acc = sum(w[..., None] * a for w, (_, _, a) in zip(wts, parts))
    out = acc / den.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


@pytest.mark.parametrize("sq,sk,split_len,causal", [
    (1, 200, 256, False),    # one slice
    (1, 1088, 64, False),    # many slices (17)
    (3, 1000, 128, False),   # a ragged last slice (1000 = 7 x 128 + 104)
    (1, 40, 64, False),      # Sk shorter than one slice
    (5, 300, 64, True),      # causal, short queries: most slices masked
])
def test_split_k_model_matches_plain(sq, sk, split_len, causal):
    q, k, v = (_to_torch(a) for a in _inputs(sk, 2, sq, sk, 8, 2, 64,
                                             "float32"))
    got = _split_k_model(q, k, v, causal, split_len)
    want = fa.attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("batch,sq,h,g,sk", [
    (8, 1, 32, 4, 1088),     # the Yi-9B serve decode step
    (8, 1, 32, 4, 1152),
    (1, 1, 8, 8, 1),
    (2, 7, 32, 1, 4097),
    (1, 3, 4, 2, 100),
    (64, 1, 32, 4, 2000),    # many rows already: one slice each
])
def test_decode_split_covers_every_key_once(batch, sq, h, g, sk):
    split, n = fa.ops.decode_split(batch, sq, h, g, sk, 132)
    assert split % fa.ops.DECODE_CHUNK == 0
    assert split >= fa.ops.DECODE_MIN_SPLIT
    slices = [range(i * split, min(sk, (i + 1) * split)) for i in range(n)]
    assert all(len(s) > 0 for s in slices)              # no empty slice
    assert sorted(x for s in slices for x in s) == list(range(sk))


def test_decode_split_fills_the_card_at_the_serve_shape():
    split, n = fa.ops.decode_split(8, 1, 32, 4, 1088, 132)
    ctas = fa.ops.decode_rows(8, 1, 32, 4) * n
    assert ctas >= 2 * 132, (split, n, ctas)
    assert (split, n, ctas) == (128, 9, 288)


@pytest.mark.parametrize("dtype,sq,route", [
    (torch.float32, 1, "f32"), (torch.float32, 1024, "f32"),
    (torch.bfloat16, 1, "decode"),
    (torch.bfloat16, fa.ops.PREFILL_MIN_QUERIES - 1, "decode"),
    (torch.bfloat16, fa.ops.PREFILL_MIN_QUERIES, "prefill"),
    (torch.bfloat16, 1024, "prefill"),
])
def test_route_follows_dtype_and_query_count(dtype, sq, route):
    assert fa.ops.pick_route(dtype, sq) == route
