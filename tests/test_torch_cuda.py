"""The port's CUDA kernels against their plain versions on the card.

These need a CUDA device and nvcc: they carry the ``cuda`` marker and skip
elsewhere.  On a machine with the card run them with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Tolerances: fingerprint pairs exact; sums of squares rtol 1e-5 (blocks of
at most 1024 elements); AdamW float32 state rtol 1e-5 / atol 1e-7;
block_gather's indices, block bytes and counts exact, and its sums of
squares bit-equal to block_fp's (the same device code).
"""
import numpy as np
import pytest
import torch

from repro_torch.dtypes import byte_view
from repro_torch.kernels import block_fp as bfp
from repro_torch.kernels import block_gather as bg
from repro_torch.kernels import fused_adamw as fadam

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
