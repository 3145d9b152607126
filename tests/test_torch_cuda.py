"""The port's CUDA kernels against their plain versions on the card.

These need a CUDA device and nvcc: they carry the ``cuda`` marker and skip
elsewhere.  On a machine with the card run them with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Tolerances: fingerprint pairs exact; sums of squares rtol 1e-5 (blocks of
at most 1024 elements); AdamW float32 state rtol 1e-5 / atol 1e-7;
block_gather's indices, block bytes and counts exact, and its sums of
squares bit-equal to block_fp's (the same device code); flash_attention
(every route: bf16 prefill, bf16 split-K decode, float32) within atol =
rtol = 2e-2 in bf16 and 2e-5 in float32 of its plain version (one float32
function summed in another order), and at Yi-9B's heads within two bf16
ulps of it per element with at most 1% of the elements differing;
ssd_scan's bf16 y (through the wrapper, which takes the CUDA-core f32
route, and through the tensor-core bf16 route) within two bf16 ulps of
its plain version's per element (|d| <= 2**-6 |want| + 1e-5) with at most
1% of the elements differing at all, the check of chip_smoke.py's serve
shapes, which a plain version that rounds its decayed scores to bf16
fails; its float32 y within 1e-4 (the JAX package's kernel-test bound),
its float32 final state within 1e-4 of the plain version's largest
magnitude, two launches bitwise equal, and each route launching its own
kernels;
quantize and dequantize bitwise equal to their plain versions (q of a NaN
block aside: its int8 cast is platform-defined), and an int8 save's
objects on the card byte-identical to the CPU path's.
"""
import numpy as np
import pytest
import torch

from repro_torch.dtypes import byte_view
from repro_torch.kernels import block_fp as bfp
from repro_torch.kernels import block_gather as bg
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_adamw as fadam
from repro_torch.kernels import quantize as qz
from repro_torch.kernels import ssd_scan as ssd

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.int32, torch.uint8, torch.bool])
def test_block_fp_kernel_matches_plain(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(0)
    leaves = []
    for n in (1, 255, 1000, 4097):
        x = torch.randn(n, generator=g, device=dev) * 100
        leaves.append(x > 0 if dtype == torch.bool else x.to(dtype))
    fp, ss, nbs = bfp.fingerprint_unit(leaves, 1024)
    lo = 0
    for x, nb in zip(leaves, nbs):
        pfp, pss = bfp.fingerprint_plain(x, 1024)
        assert torch.equal(fp[lo:lo + nb], pfp)
        host = bfp.fingerprint_bytes(byte_view(x).cpu().numpy().tobytes(),
                                     1024)
        np.testing.assert_array_equal(
            fp[lo:lo + nb].cpu().numpy().view(np.uint32), host)
        torch.testing.assert_close(ss[lo:lo + nb], pss, rtol=1e-5, atol=0)
        lo += nb


def test_fused_adamw_kernel_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    shapes = [(1000,), (33, 17), (4096,)]
    mk = [[torch.randn(s, generator=g, device=dev) * 0.02 for s in shapes]
          for _ in range(2)]
    master, m = mk
    v = [torch.rand(s, generator=g, device=dev) * 1e-6 for s in shapes]
    grads = [(torch.randn(s, generator=g, device=dev) * 1e-3).to(
        torch.bfloat16) for s in shapes]
    params = [x.to(torch.bfloat16) for x in master]
    ref = [[x.clone() for x in t] for t in (params, master, m, v)]
    wds = [0.1, 0.0, 0.1]
    kw = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, step=2,
              gscale=torch.tensor([0.5], device=dev))
    before = fadam.KERNEL.launches
    fadam.fused_adamw(grads, master, m, v, params, wds, **kw)
    assert fadam.KERNEL.launches == before + 1
    fadam.fused_adamw_plain(grads, ref[1], ref[2], ref[3], ref[0], wds, **kw)
    for got, want in zip(master + m + v, ref[1] + ref[2] + ref[3]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
    for p, ma in zip(params, master):
        assert torch.equal(p, ma.to(torch.bfloat16))


def test_units_with_more_leaves_than_one_launch_takes(dev):
    """Units past a kernel's leaf-table size go out in several launches
    and still match the plain versions."""
    g = torch.Generator(device=dev).manual_seed(2)
    n = max(bfp.ops.MAX_LEAVES, fadam.ops.MAX_LEAVES) + 5
    xs = [torch.randn(100 + 37 * i, generator=g, device=dev)
          for i in range(n)]
    before = bfp.KERNEL.launches
    fp, ss, nbs = bfp.fingerprint_unit(xs, 1024)
    assert bfp.KERNEL.launches - before == -(-n // bfp.ops.MAX_LEAVES)
    plain = [bfp.fingerprint_plain(x, 1024) for x in xs]
    assert torch.equal(fp, torch.cat([p[0] for p in plain]))
    torch.testing.assert_close(ss, torch.cat([p[1] for p in plain]),
                               rtol=1e-5, atol=0)
    master = [x * 0.01 for x in xs]
    m = [torch.zeros_like(x) for x in xs]
    v = [torch.zeros_like(x) for x in xs]
    params = [x.to(torch.bfloat16) for x in master]
    grads = [(x * 1e-3).to(torch.bfloat16) for x in xs]
    ref = [[x.clone() for x in t] for t in (params, master, m, v)]
    kw = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, step=0,
              gscale=torch.ones(1, device=dev))
    before = fadam.KERNEL.launches
    fadam.fused_adamw(grads, master, m, v, params, [0.1] * n, **kw)
    assert fadam.KERNEL.launches - before == -(-n // fadam.ops.MAX_LEAVES)
    fadam.fused_adamw_plain(grads, ref[1], ref[2], ref[3], ref[0],
                            [0.1] * n, **kw)
    for got, want in zip(master + m + v, ref[1] + ref[2] + ref[3]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)


def _gather_cases(dev):
    """(leaves, refs, capacities) covering every dtype block_fp takes,
    ragged tails, a 2-byte-aligned leaf, an empty leaf, a clean leaf, a
    leaf with no reference and an overflowing capacity."""
    g = torch.Generator(device=dev).manual_seed(4)
    bb = 1024
    leaves, refs, caps = [], [], []
    for dtype in (torch.float32, torch.bfloat16, torch.float16, torch.int32,
                  torch.uint8, torch.int8, torch.int16, torch.int64,
                  torch.float64, torch.bool):
        base = torch.randn(3001, generator=g, device=dev) * 100
        base = base > 0 if dtype == torch.bool else base.to(dtype)
        cur = base.clone()
        cur[::700] = cur[::700] == 0 if dtype == torch.bool else cur[::700] + 1
        leaves.append(cur)
        refs.append(bfp.fingerprint_plain(base, bb)[0])
        caps.append(8)
    odd = (torch.randn(20_001, generator=g, device=dev)).to(torch.bfloat16)
    leaves.append(odd[1:])                       # 2-byte aligned
    refs.append(None)
    caps.append(64)
    leaves.append(torch.zeros(0, device=dev))    # empty: one zero block
    refs.append(None)
    caps.append(1)
    clean = torch.randn(5000, generator=g, device=dev)
    leaves.append(clean)
    refs.append(bfp.fingerprint_plain(clean, bb)[0])
    caps.append(4)
    over = torch.randn(8192, generator=g, device=dev)
    ref = bfp.fingerprint_plain(over, bb)[0]
    over = over.clone()
    over[::256] += 1                             # every block dirty
    leaves.append(over)
    refs.append(ref)
    caps.append(1)                               # count 32 > capacity 1
    return leaves, refs, caps, bb


def test_block_gather_kernel_matches_plain(dev):
    leaves, refs, caps, bb = _gather_cases(dev)
    # one launch per 32 leaves: repeat the cases past one leaf table
    leaves, refs, caps = leaves * 3, refs * 3, caps * 3
    before = bg.KERNEL.launches
    got = bg.gather_tree_dirty(leaves, refs, caps, block_bytes=bb)
    torch.cuda.synchronize()
    assert bg.KERNEL.launches - before == -(-len(leaves) // bg.MAX_LEAVES)
    fp, ss, _ = bfp.fingerprint_unit(leaves, bb)
    lo = 0
    for x, r, c, k in zip(leaves, refs, caps, got):
        p = bg.gather_dirty_plain(x, r, capacity=k.capacity, block_bytes=bb)
        assert torch.equal(k.fp, p.fp)
        assert torch.equal(k.idx, p.idx)
        assert int(k.count) == int(p.count)
        assert torch.equal(k.block_bytes(), p.block_bytes())
        host = bg.gather_dirty_oracle(
            byte_view(x).cpu().numpy(), None if r is None else
            r.cpu().numpy().view(np.uint32), capacity=k.capacity,
            block_bytes=bb)
        assert np.array_equal(k.idx.cpu().numpy(), host[1])
        assert int(k.count) == host[3]
        nb = k.fp.shape[0]
        assert torch.equal(k.sumsq, ss[lo:lo + nb])
        torch.testing.assert_close(k.sumsq, p.sumsq, rtol=1e-5, atol=0)
        lo += nb
    assert int(got[-1].count) == 32 and got[-1].idx.tolist() == [0]
    assert int(got[-2].count) == 0 and got[-2].idx.tolist() == [-1] * 4


@pytest.mark.parametrize("b,sq,sk,h,g,d,causal,dtype", [
    (2, 128, 128, 8, 2, 128, True, torch.bfloat16),     # causal Sq == Sk
    (2, 64, 200, 8, 4, 64, True, torch.float32),        # top-left Sq < Sk
    (2, 96, 160, 4, 2, 128, False, torch.bfloat16),     # non-causal
    (1, 77, 77, 4, 1, 64, True, torch.bfloat16),        # ragged Sk, G = 1
    (2, 130, 130, 4, 4, 64, True, torch.float32),       # G = H
    (1, 70, 70, 32, 1, 128, True, torch.float32),       # 32 heads on 1
])
def test_flash_attention_kernel_matches_plain(dev, b, sq, sk, h, g, d,
                                              causal, dtype):
    gen = torch.Generator(device=dev).manual_seed(sq + sk)
    q = torch.randn(b, sq, h, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, sk, g, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, sk, g, d, generator=gen, device=dev).to(dtype)
    before = fa.KERNEL.launches
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.KERNEL.launches == before + 1
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), fa.attention_plain(
        q, k, v, causal=causal).float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_decode_on_a_strided_cache_view(dev, dtype):
    gen = torch.Generator(device=dev).manual_seed(3)
    cache = torch.randn(2, 300, 2, 2, 128, generator=gen,
                        device=dev).to(dtype)
    q = torch.randn(2, 1, 8, 128, generator=gen, device=dev).to(dtype)
    k, v = cache[:, :213, 0], cache[:, :213, 1]
    got = fa.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), fa.attention_plain(
        q, k, v, causal=False).float(), atol=tol, rtol=tol)


_T = fa.ops.PREFILL_MIN_QUERIES


# (B, Sq, Sk, H, G, D, causal, dtype, the route the wrapper must pick)
@pytest.mark.parametrize("b,sq,sk,h,g,d,causal,dtype,route", [
    (2, _T - 1, 300, 32, 4, 128, False, torch.bfloat16, "decode"),
    (2, _T, 300, 32, 4, 128, False, torch.bfloat16, "prefill"),
    (2, _T - 1, 300, 32, 4, 128, True, torch.bfloat16, "decode"),
    (2, _T, 300, 32, 4, 128, True, torch.bfloat16, "prefill"),
    (1, 200, 200, 8, 2, 64, True, torch.bfloat16, "prefill"),     # D 64
    (1, _T - 1, 500, 8, 2, 64, False, torch.bfloat16, "decode"),  # D 64
    (2, 150, 150, 8, 1, 128, True, torch.bfloat16, "prefill"),    # G = 1
    (2, _T - 1, 333, 8, 1, 128, False, torch.bfloat16, "decode"),  # G = 1
    (1, 130, 130, 4, 4, 128, True, torch.bfloat16, "prefill"),    # G = H
    (1, _T - 1, 130, 4, 4, 128, False, torch.bfloat16, "decode"),  # G = H
    (1, 77, 201, 4, 2, 128, True, torch.bfloat16, "prefill"),     # ragged
    (1, 77, 201, 4, 2, 128, False, torch.bfloat16, "prefill"),    # Sq < Sk
    (2, 1, 1, 32, 4, 128, False, torch.bfloat16, "decode"),       # Sk = 1
    (1, 100, 1, 8, 2, 128, True, torch.bfloat16, "prefill"),      # Sk = 1
    (1, 1, 4097, 32, 4, 128, False, torch.bfloat16, "decode"),    # Sk 4097
    (1, 70, 4097, 8, 2, 64, False, torch.bfloat16, "prefill"),    # Sk 4097
    (2, 70, 70, 32, 4, 128, True, torch.float32, "f32"),
    (2, 1, 213, 8, 2, 64, False, torch.float32, "f32"),
])
def test_flash_attention_every_route_on_a_cache_view(dev, b, sq, sk, h, g, d,
                                                     causal, dtype, route):
    """Each route against attention_plain at its edges, reading k and v as
    strided views of one cache (as a decode step does); one C entry call,
    so one launch, per wrapper call."""
    assert fa.ops.pick_route(dtype, sq) == route
    gen = torch.Generator(device=dev).manual_seed(sq * 7 + sk)
    q = torch.randn(b, sq, h, d, generator=gen, device=dev).to(dtype)
    cache = torch.randn(b, sk + 3, 2, g, d, generator=gen,
                        device=dev).to(dtype)
    k, v = cache[:, :sk, 0], cache[:, :sk, 1]
    before = fa.KERNEL.launches
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.KERNEL.launches == before + 1
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), fa.attention_plain(
        q, k, v, causal=causal).float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("b,sq,sk,causal,route", [
    (2, 512, 512, True, "prefill"), (8, 1, 1088, False, "decode")])
def test_flash_attention_within_two_ulps_of_plain(dev, b, sq, sk, causal,
                                                  route):
    """chip_smoke.py's serve-shape check at Yi-9B's heads: every element
    within two bf16 ulps of attention_plain (|d| <= 2**-6 |want| + 1e-5),
    at most 1% of the elements differing at all."""
    gen = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn(b, sq, 32, 128, generator=gen, device=dev).to(
        torch.bfloat16)
    k, v = (torch.randn(b, sk, 4, 128, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    assert fa.ops.pick_route(q.dtype, sq) == route
    got = fa.flash_attention(q, k, v, causal=causal).float()
    want = fa.attention_plain(q, k, v, causal=causal).float()
    limit = 2.0 ** -6 * want.abs() + 1e-5
    assert ((got - want).abs() <= limit).all()
    assert (got != want).float().mean().item() <= 0.01


@pytest.mark.parametrize("route", ["prefill", "decode", "f32"])
def test_flash_attention_launch_counts_one_per_call_on_each_route(dev,
                                                                  route):
    dtype = torch.float32 if route == "f32" else torch.bfloat16
    q = torch.randn(1, 16, 8, 64, device=dev).to(dtype)
    k = torch.randn(1, 40, 2, 64, device=dev).to(dtype)
    before = fa.KERNEL.launches
    for _ in range(3):
        fa.ops.launch(q, k, k, True, route)
    torch.cuda.synchronize()
    assert fa.KERNEL.launches == before + 3
    with pytest.raises(TypeError):
        fa.ops.launch(q.float() if dtype != torch.float32 else q.bfloat16(),
                      k, k, True, route)


def test_flash_attention_kernel_rejects_what_it_does_not_take(dev):
    q = torch.zeros(1, 4, 2, 96, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q[:, :, :1], q[:, :, :1])
    q = torch.zeros(1, 4, 2, 64, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q[:, :, :1], q[:, :, :1])


def _ssd_inputs(dev, b, s, h, g, dtype, seed, views):
    """x, B, C as the model passes them (views of one conv output row) or
    contiguous; dt = softplus(randn); A_log = log(linspace(1, 16, H))."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    p, n = ssd.ops.HEAD_DIM, ssd.ops.STATE_DIM
    if views:
        conv = (torch.randn(b, s, h * p + 2 * g * n, generator=gen,
                            device=dev) * 0.5).to(dtype)
        xs = conv[..., :h * p].unflatten(-1, (h, p))
        bs = conv[..., h * p:h * p + g * n].unflatten(-1, (g, n))
        cs = conv[..., h * p + g * n:].unflatten(-1, (g, n))
    else:
        xs, bs, cs = ((torch.randn(b, s, k, d, generator=gen, device=dev)
                       * 0.5).to(dtype) for k, d in ((h, p), (g, n), (g, n)))
    dt = torch.logaddexp(torch.randn(b, s, h, generator=gen, device=dev),
                         torch.zeros((), device=dev))
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device=dev))
    return xs, dt, a_log, bs, cs


def _kernel_names(fn) -> list:
    """Names of the device kernels one call of ``fn`` launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA]


# The kernels each route launches, in order: the bf16 route's three
# tensor-core kernels, and the f32 route's one CUDA-core kernel (one
# instantiation per input dtype).
SSD_ROUTE_KERNELS = {
    "bf16": ["ssd_chunk_state_kernel", "ssd_state_pass_kernel",
             "ssd_chunk_out_kernel"],
    "f32": ["ssd_scan_kernel<"],
}


# route None: the wrapper (which takes the f32 route for every dtype);
# "bf16": the bf16 route, named through ops.launch
@pytest.mark.parametrize("b,s,h,g,q,dtype,views,route", [
    (2, 512, 8, 1, 256, torch.bfloat16, True, None),    # full chunks, G = 1
    (2, 512, 8, 1, 256, torch.bfloat16, True, "bf16"),
    (1, 1025, 4, 1, 256, torch.bfloat16, False, None),  # ragged S = 4 x 256
    (1, 1025, 4, 1, 256, torch.bfloat16, False, "bf16"),  # + 1
    (2, 300, 4, 4, 37, torch.float32, True, None),      # odd Q, G = H
    (1, 200, 8, 2, 64, torch.float32, False, None),     # G = 2, ragged S
    (3, 100, 32, 1, 100, torch.bfloat16, True, None),   # Q = S, 32 heads
    (3, 100, 32, 1, 100, torch.bfloat16, True, "bf16"),
    (2, 77, 4, 4, 256, torch.float32, False, None),     # S < Q
    (2, 256, 8, 8, 128, torch.bfloat16, True, None),    # G = H
    (2, 256, 8, 8, 128, torch.bfloat16, True, "bf16"),
    (1, 64, 2, 1, 1, torch.float32, True, None),        # Q = 1
    (8, 1024, 32, 1, 256, torch.bfloat16, True, None),  # the serve prefill
    (8, 1024, 32, 1, 256, torch.bfloat16, True, "bf16"),
    (1, 4096, 32, 1, 256, torch.bfloat16, True, None),  # batch 1 x 4096
    (1, 4096, 32, 1, 256, torch.bfloat16, True, "bf16"),
    (2, 77, 4, 4, 256, torch.bfloat16, False, "bf16"),  # S < Q
    (1, 300, 4, 2, 37, torch.bfloat16, True, "bf16"),   # S % Q != 0, odd Q
    (2, 333, 4, 1, 256, torch.float32, True, None),     # ragged S
])
def test_ssd_scan_kernel_matches_plain(dev, b, s, h, g, q, dtype, views,
                                       route):
    args = _ssd_inputs(dev, b, s, h, g, dtype, s + q, views)
    if route is None:
        call, route = (lambda: ssd.ssd_scan(*args, q)), "f32"
    else:
        call = lambda: ssd.ops.launch(*args, q, route)  # noqa: E731
    before = ssd.KERNEL.launches
    y, fin = call()
    y2, fin2 = call()
    torch.cuda.synchronize()
    assert ssd.KERNEL.launches == before + 2
    assert torch.equal(y, y2) and torch.equal(fin, fin2)
    names = _kernel_names(call)
    wants = SSD_ROUTE_KERNELS[route]
    assert len(names) == len(wants) and all(
        w in n for w, n in zip(wants, names)), names
    want_y, want_fin = ssd.ssd_scan_plain(*args, q)
    assert y.dtype == dtype and fin.dtype == torch.float32
    if dtype == torch.bfloat16:
        d = (y.float() - want_y.float()).abs()
        assert (d <= 2.0 ** -6 * want_y.float().abs() + 1e-5).all()
        assert (d > 0).float().mean() <= 0.01
    else:
        torch.testing.assert_close(y, want_y, atol=1e-4, rtol=1e-4)
    assert (fin - want_fin).abs().max() <= 1e-4 * want_fin.abs().max()


def test_ssd_scan_routes_agree_on_one_input(dev):
    """The f32 route reads bf16 inputs as their float32 values (bitwise
    the same result as on float32 copies), and the bf16 route computes
    the same function: y within two bf16 ulps, states within 1e-4."""
    args = _ssd_inputs(dev, 2, 600, 8, 1, torch.bfloat16, 5, True)
    f32 = [a.float() for a in args]
    y, fin = ssd.ops.launch(*args, 256, "bf16")
    yf, finf = ssd.ops.launch(*f32, 256, "f32")
    yb, finb = ssd.ops.launch(*args, 256, "f32")
    assert torch.equal(yb, yf.to(torch.bfloat16)) and torch.equal(finb, finf)
    d = (y.float() - yf).abs()
    assert (d <= 2.0 ** -6 * yf.abs() + 1e-5).all()
    assert (fin - finf).abs().max() <= 1e-4 * finf.abs().max()
    with pytest.raises(TypeError):
        ssd.ops.launch(*f32, 256, "bf16")


def test_ssd_scan_kernel_rejects_what_it_does_not_take(dev):
    xs, dt, a_log, bs, cs = _ssd_inputs(dev, 1, 16, 2, 1, torch.bfloat16, 0,
                                        False)
    with pytest.raises(ValueError, match="chunks of at most"):
        ssd.ssd_scan(xs, dt, a_log, bs, cs, 300)
    with pytest.raises(TypeError):
        ssd.ssd_scan(xs.half(), dt, a_log, bs.half(), cs.half(), 8)
    with pytest.raises(ValueError, match="P 64 and N 128"):
        ssd.ssd_scan(xs[..., :32], dt, a_log, bs, cs, 8)


def _scales_equal(a, b) -> bool:
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and torch.equal(
        a[~na].view(torch.int32), b[~nb].view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_kernels_match_plain_bitwise(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(3)
    sizes = (1, 255, 256, 257, 64 * 256 + 3, 1000)
    leaves = [(torch.randn(n, generator=g, device=dev) * 3).to(dtype)
              for n in sizes]
    special = torch.randn(4 * 256, generator=g, device=dev)
    special[:256] = 0                       # all-zero block: scale 1
    special[256:512] = (torch.arange(256, device=dev) % 64) - 31.5  # ties
    special[256] = 127.0
    special[512:768] *= 1e-40               # denormals
    special[800] = float("nan")             # NaN block: scale only
    odd = (torch.randn(1001, generator=g, device=dev) * 3).to(dtype)
    leaves.append(odd[1:])                  # starts off 16 bytes
    leaves.append(special.to(dtype))
    before = (qz.QUANTIZE.launches, qz.DEQUANTIZE.launches)
    unit = qz.quantize_unit(leaves)
    torch.cuda.synchronize()
    assert qz.QUANTIZE.launches == before[0] + 1
    for i, x in enumerate(leaves):
        q, s = qz.quantize_plain(x)
        finite = ~torch.isnan(s.reshape(-1))
        assert torch.equal(unit.q(i)[finite], q[finite])
        assert _scales_equal(unit.scales(i), s)
    outs = [torch.empty(x.numel() + 1, dtype=dtype, device=dev)[
        i % 2:i % 2 + x.numel()] for i, x in enumerate(leaves)]
    qz.dequantize_unit([(unit.q(i), unit.scales(i))
                        for i in range(len(leaves) - 1)], outs[:-1])
    torch.cuda.synchronize()
    assert qz.DEQUANTIZE.launches == before[1] + 1
    for i, o in enumerate(outs[:-1]):
        want = qz.dequantize_plain(unit.q(i), unit.scales(i), o.numel(),
                                   dtype)
        assert torch.equal(o.view(torch.uint8) if dtype == torch.float32
                           else o.view(torch.int16),
                           want.view(torch.uint8) if dtype == torch.float32
                           else want.view(torch.int16))


def test_quantize_kernels_take_more_leaves_than_one_table(dev):
    leaves = [torch.randn(300 + i, device=dev) for i in range(qz.MAX_LEAVES
                                                              + 5)]
    before = qz.QUANTIZE.launches
    unit = qz.quantize_unit(leaves)
    torch.cuda.synchronize()
    assert qz.QUANTIZE.launches == before + 2
    for i, x in enumerate(leaves):
        q, s = qz.quantize_plain(x)
        assert torch.equal(unit.q(i), q) and torch.equal(unit.scales(i), s)
    outs = [torch.empty_like(x, dtype=torch.float16) for x in leaves]
    qz.dequantize_unit([(unit.q(i), unit.scales(i))
                        for i in range(len(leaves))], outs)
    for i, o in enumerate(outs):
        assert torch.equal(o, qz.dequantize_plain(unit.q(i), unit.scales(i),
                                                  o.numel(), o.dtype))


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def test_int8_save_moves_records_and_restores_on_the_card(dev, tmp_path):
    from repro_torch.checkpoint.saver import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core.layer_registry import LayerRegistry
    from repro_torch.core.policies import make_policy
    from repro_torch.launch import steps
    from repro_torch.models import build_model

    model = build_model(get_config("yi-9b", reduced=True))
    reg = LayerRegistry(model)
    # one state, made on the CPU (the init draws per device) and copied
    cpu_state = steps.init_state(model, 0, torch.device("cpu"))
    state = {k: (v if k == "step" else _to(v, dev))
             for k, v in cpu_state.items()}
    mgrs = {}
    for where, st in (("card", state), ("cpu", cpu_state)):
        mgrs[where] = CheckpointManager(
            tmp_path / where, reg, make_policy("full", model.layer_units()),
            async_save=False, codec="int8")
        mgrs[where].save(st, step=1)
    # the card's objects are the CPU path's, byte for byte
    for p in sorted((tmp_path / "card" / "objects").glob("*/*.chunk")):
        other = tmp_path / "cpu" / "objects" / p.parent.name / p.name
        assert other.read_bytes() == p.read_bytes()
    assert mgrs["card"].last_save_stats["d2h_bytes"] \
        == mgrs["cpu"].last_save_stats["d2h_bytes"]
    got = mgrs["card"].restore(steps.state_specs(model), device=dev)
    want = mgrs["cpu"].restore(steps.state_specs(model),
                               device=torch.device("cpu"))
    from repro_torch.checkpoint.serial import flatten_with_paths
    for part in ("params", "opt"):
        for (p, x), (_, y) in zip(flatten_with_paths(got[part]),
                                  flatten_with_paths(want[part])):
            assert torch.equal(byte_view(x).cpu(), byte_view(y)), p
    for m in mgrs.values():
        m.close()
