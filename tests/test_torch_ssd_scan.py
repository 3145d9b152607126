"""The port's SSD chunk scan (its plain version, which CPU tensors take and
the model trains through) against the JAX package's Pallas kernel run in
interpret mode, its per-step recurrence oracle and the JAX model's
``ssd_chunked``.

Inputs come from numpy with a seed and go to both packages.  B and C go to
the port with their G groups and to the JAX functions repeated per head
(what the JAX model's ``_broadcast_groups`` gives).  Tolerances: float32
within atol = rtol = 1e-4, as the JAX package's kernel tests hold its
Pallas kernel (one float32 function summed in another order); bf16 y
within 2e-2 (a few bf16 ulps at |y| < 4); gradients within 1e-4 relative
to the largest one.

The CUDA kernel's bf16 route feeds its float32 operands (the decayed
scores m, the carried state and the weighted x) to bf16 tensor cores as
three bf16 pieces.  Here an emulation of that arithmetic, written apart
from the port (numpy, bf16 pieces, products summed in float32), is held to
the JAX package's functions within 1e-4 and to the plain version within
5e-7 of its largest |y|, a bound that two pieces miss (their ~3e-6 at
these sizes) and three meet (~1e-7).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_ref
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.models.ssm import ssd_chunked
from repro_torch.kernels import ssd_scan as ssd

torch.set_num_threads(1)

TOL = 1e-4


def _inputs(seed, b, s, h, g, p, n, dtype="float32"):
    rs = np.random.RandomState(seed)
    xs = (rs.standard_normal((b, s, h, p)) * 0.5).astype(np.float32)
    dt = np.logaddexp(rs.standard_normal((b, s, h)), 0).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 4.0, h)).astype(np.float32)
    bs = (rs.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    cs = (rs.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    if dtype == "bfloat16":
        xs, bs, cs = (a.astype(ml_dtypes.bfloat16) for a in (xs, bs, cs))
    return xs, dt, a_log, bs, cs


def _to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _per_head(t, h):
    """(B,S,G,N) -> (B,S,H,N): the JAX model's head broadcast."""
    return np.repeat(t, h // t.shape[2], axis=2)


def _port(xs, dt, a_log, bs, cs, chunk):
    y, fin = ssd.ssd_scan(*(_to_torch(a) for a in (xs, dt, a_log, bs, cs)),
                          chunk)
    return y.to(torch.float32).numpy(), fin.numpy()


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# the shapes of tests/test_kernels.py's SSD sweep
@pytest.mark.parametrize("b,s,h,p,n,q", [
    (2, 64, 4, 16, 16, 16),
    (1, 128, 2, 32, 64, 32),
    (1, 96, 3, 8, 8, 32),
])
def test_plain_matches_pallas_kernel_and_recurrence(b, s, h, p, n, q):
    xs, dt, a_log, bs, cs = _inputs(s + p, b, s, h, h, p, n)
    y, fin = _port(xs, dt, a_log, bs, cs, q)
    jy, jfin = jax_ssd_scan(*map(jnp.asarray, (xs, dt, a_log, bs, cs)),
                            chunk=q, interpret=True)
    _close(y, jy)
    _close(fin, jfin)
    ry, rfin = ssd_ref(*map(jnp.asarray, (xs, dt, a_log, bs, cs)))
    _close(y, ry)
    _close(fin, rfin)


@pytest.mark.parametrize("b,s,h,g,p,n,q", [
    (2, 80, 2, 2, 16, 24, 32),     # tests/test_kernels.py: S % Q != 0
    (1, 37, 4, 4, 8, 8, 5),        # odd Q, ragged tail of 2
    (2, 33, 4, 1, 16, 16, 33),     # Q = S, odd, one group
    (1, 70, 6, 3, 8, 16, 16),      # G = 3 < H = 6, ragged tail
    (1, 1, 2, 1, 8, 8, 1),         # a single step
])
def test_ragged_and_grouped_match_ssd_chunked(b, s, h, g, p, n, q):
    """Any S, any Q <= S, G groups read per head: the JAX model's
    ``ssd_chunked`` (dt = 0 padding) on per-head B and C, and the
    recurrence oracle."""
    xs, dt, a_log, bs, cs = _inputs(s * 7 + g, b, s, h, g, p, n)
    y, fin = _port(xs, dt, a_log, bs, cs, q)
    jargs = (xs, dt, a_log, _per_head(bs, h), _per_head(cs, h))
    jy, jfin = ssd_chunked(*map(jnp.asarray, jargs), q)
    _close(y, jy)
    _close(fin, jfin, 2e-4)
    ry, rfin = ssd_ref(*map(jnp.asarray, jargs))
    _close(y, ry)
    _close(fin, rfin, 2e-4)


def test_bf16_inputs_match_ssd_chunked():
    """bf16 x, B and C (the model's prefill types): y in bf16 within a few
    ulps of the JAX model's, the final state float32 within 1e-4."""
    h, g = 4, 2
    xs, dt, a_log, bs, cs = _inputs(5, 2, 96, h, g, 16, 16, "bfloat16")
    y, fin = _port(xs, dt, a_log, bs, cs, 32)
    jy, jfin = ssd_chunked(*map(jnp.asarray, (
        xs, dt, a_log, _per_head(bs, h), _per_head(cs, h))), 32)
    assert jy.dtype == jnp.bfloat16
    _close(y, jy, 2e-2)
    _close(fin, jfin)


def test_gradients_match_jax():
    """The model trains through the plain version: its autograd gradients
    equal jax.grad of ``ssd_chunked`` on the same loss."""
    h, g, q = 4, 2, 16
    xs, dt, a_log, bs, cs = _inputs(9, 2, 40, h, g, 8, 8)
    w = np.random.RandomState(1).standard_normal(xs.shape).astype(np.float32)
    wf = np.random.RandomState(2).standard_normal(
        (2, h, 8, 8)).astype(np.float32)

    def jloss(xs, dt, a_log, bs, cs):
        y, fin = ssd_chunked(xs, dt, a_log, jnp.repeat(bs, h // g, axis=2),
                             jnp.repeat(cs, h // g, axis=2), q)
        return jnp.sum(y * w) + jnp.sum(fin * wf)

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (xs, dt, a_log, bs, cs)))
    ts = [torch.from_numpy(a.copy()).requires_grad_(True)
          for a in (xs, dt, a_log, bs, cs)]
    y, fin = ssd.ssd_scan_plain(*ts, q)
    ((y * torch.from_numpy(w)).sum()
     + (fin * torch.from_numpy(wf)).sum()).backward()
    for name, t, want in zip(("xs", "dt", "a_log", "bs", "cs"), ts, jg):
        want = np.asarray(want)
        scale = np.abs(want).max()
        np.testing.assert_allclose(t.grad.numpy() / scale, want / scale,
                                   atol=1e-4, rtol=0, err_msg=name)


def _pieces(v, k):
    """k bf16 pieces of float32 values: p1 = bf16(v), p2 = bf16(v - p1),
    ... (each difference exact in float32), as float32 arrays."""
    out, r = [], np.asarray(v, np.float32)
    for _ in range(k):
        p = r.astype(ml_dtypes.bfloat16).astype(np.float32)
        out.append(p)
        r = r - p
    return out


@pytest.mark.parametrize("lo,hi", [(-30, -20), (-20, -10), (-10, 0),
                                   (0, 3)])
def test_three_bf16_pieces_sum_to_the_float32_value(lo, hi):
    """The split the bf16 route applies to its float32 operands: three
    pieces hold all 24 bits of a float32 exactly, over the magnitudes m,
    the state and w x take (1e-30 to 1e3, both signs); two do not."""
    rs = np.random.RandomState(lo + 40)
    mag = 10.0 ** rs.uniform(lo, hi, 20000)
    v = (mag * rs.choice([-1.0, 1.0], mag.size)).astype(np.float32)
    three = _pieces(v, 3)
    assert all(np.all(np.isfinite(p)) for p in three)
    got = three[0].astype(np.float64) + three[1] + three[2]
    np.testing.assert_array_equal(got, v.astype(np.float64))
    two = _pieces(v, 2)
    assert np.any(two[0].astype(np.float64) + two[1] != v)


def _pdot(a, b, k, split_a):
    """a @ b with the float32 operand (a if split_a, else b) as k bf16
    pieces: bf16 x bf16 products summed in float32, piece by piece."""
    if split_a:
        return sum(p @ b for p in _pieces(a, k)).astype(np.float32)
    return sum(a @ p for p in _pieces(b, k)).astype(np.float32)


def _emulate_bf16_route(xs, dt, a_log, bs, cs, q, k):
    """The bf16 route's arithmetic per (b, h) and chunk, with m, the
    entering state and w x as k bf16 pieces; x, B, C are bf16 values.  L
    comes from torch.cumsum, as the plain version takes it on this
    device (the kernel's serial float32 sum equals it on the card)."""
    b, s, h, p = xs.shape
    g, n = bs.shape[2:]
    f = np.float32
    y = np.zeros((b, s, h, p), f)
    fin = np.zeros((b, h, p, n), f)
    for bi in range(b):
        for hi in range(h):
            gi = hi // (h // g)
            a = -np.exp(f(a_log[hi]))
            st = np.zeros((p, n), f)
            for c0 in range(0, s, q):
                x = xs[bi, c0:c0 + q, hi].astype(f)
                bb = bs[bi, c0:c0 + q, gi].astype(f)
                cc = cs[bi, c0:c0 + q, gi].astype(f)
                d = dt[bi, c0:c0 + q, hi]
                lc = torch.cumsum(torch.from_numpy(d * a), 0).numpy()
                causal = np.tril(np.ones((len(lc), len(lc)), bool))
                rel = np.minimum(lc[:, None] - lc[None], 0)
                m = np.where(causal, (cc @ bb.T) * np.exp(rel), 0) * d
                y[bi, c0:c0 + q, hi] = (
                    _pdot(cc, st.T, k, False) * np.exp(lc)[:, None]
                    + _pdot(m.astype(f), x, k, True))
                w = np.exp(lc[-1] - lc) * d
                st = st * np.exp(lc[-1]) + _pdot((w[:, None] * x).T, bb, k,
                                                 True)
            fin[bi, hi] = st
    return y, fin


@pytest.mark.parametrize("b,s,h,g,p,n,q", [
    (1, 128, 2, 1, 32, 64, 64),
    (2, 96, 4, 2, 16, 32, 32),
])
def test_bf16_route_arithmetic_emulated(b, s, h, g, p, n, q):
    """Three pieces: within 1e-4 of the JAX package's oracle and Pallas
    kernel (interpret mode), and within 5e-7 of the plain version's
    largest |y|; two pieces miss the 5e-7."""
    xs, dt, a_log, bs, cs = _inputs(s + n, b, s, h, g, p, n, "bfloat16")
    y3, fin3 = _emulate_bf16_route(xs, dt, a_log, bs, cs, q, 3)
    y2, _ = _emulate_bf16_route(xs, dt, a_log, bs, cs, q, 2)
    f32 = [a.astype(np.float32) for a in (xs, dt, a_log, bs, cs)]
    py, pfin = ssd.ssd_scan_plain(*(torch.from_numpy(a) for a in f32), q)
    py, pfin = py.numpy(), pfin.numpy()
    scale = np.abs(py).max()
    assert np.abs(y3 - py).max() <= 5e-7 * scale
    assert np.abs(y2 - py).max() > 5e-7 * scale
    assert np.abs(fin3 - pfin).max() <= 5e-7 * np.abs(pfin).max()
    jargs = (f32[0], f32[1], f32[2], _per_head(f32[3], h),
             _per_head(f32[4], h))
    jy, jfin = jax_ssd_scan(*map(jnp.asarray, jargs), chunk=q,
                            interpret=True)
    _close(y3, jy)
    _close(fin3, jfin)
    ry, rfin = ssd_ref(*map(jnp.asarray, jargs))
    _close(y3, ry)
    _close(fin3, rfin)


def test_bf16_route_scratch():
    # the bf16 route's scratch: per-chunk f32 states, their bf16 pieces
    # (three of P x N) and L, for NC = ceil(S / Q) chunks
    nc = 5
    want = 8 * 32 * nc * (64 * 128 * 4 + 3 * 64 * 128 * 2 + 256 * 4)
    assert ssd.ops.scratch_bytes(8, 1025, 32, 256) == want


def test_launch_rejects_an_unknown_route():
    args = [_to_torch(a) for a in _inputs(1, 1, 20, 2, 1, 64, 128)]
    with pytest.raises(ValueError, match="no route 'tf32'"):
        ssd.ops.launch(*args, 8, "tf32")


def test_launch_takes_cuda_tensors_only():
    args = [_to_torch(a) for a in _inputs(1, 1, 20, 2, 1, 64, 128,
                                          "bfloat16")]
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ops.launch(*args, 8, "bf16")


def test_cpu_tensors_never_launch_the_kernel():
    args = [_to_torch(a) for a in _inputs(1, 1, 20, 2, 1, 64, 128)]
    before = ssd.KERNEL.launches
    y, fin = ssd.ssd_scan(*args, 8)
    assert ssd.KERNEL.launches == before
    assert y.shape == (1, 20, 2, 64) and fin.shape == (1, 2, 64, 128)
    assert y.dtype == torch.float32 and fin.dtype == torch.float32


@pytest.mark.parametrize("shapes", [
    ((1, 8, 4, 16), (1, 8, 4), (4,), (1, 8, 3, 16)),    # H % G != 0
    ((1, 8, 4, 16), (1, 8, 2), (4,), (1, 8, 2, 16)),    # dt heads differ
    ((1, 8, 4, 16), (1, 8, 4), (3,), (1, 8, 2, 16)),    # a_log heads differ
    ((1, 8, 4, 16), (1, 8, 4), (4,), (2, 8, 2, 16)),    # batch differs
    ((1, 0, 4, 16), (1, 0, 4), (4,), (1, 0, 2, 16)),    # no steps
])
def test_wrapper_rejects_mismatched_shapes(shapes):
    xs, dt, al, bs = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError):
        ssd.ssd_scan(xs, dt, al, bs, bs, 4)


def test_wrapper_rejects_other_devices():
    xs, dt, al, bs = (torch.zeros(s, device="meta") for s in (
        (1, 8, 4, 16), (1, 8, 4), (4,), (1, 8, 2, 16)))
    with pytest.raises(ValueError, match="does not run on"):
        ssd.ssd_scan(xs, dt, al, bs, bs, 4)
