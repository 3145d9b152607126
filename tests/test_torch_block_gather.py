"""block_gather in the port against the JAX package: the plain PyTorch
version (what CPU tensors run) against the Pallas kernel in interpret mode
(``repro.kernels.block_gather.gather_dirty(..., interpret=True)``) and the
numpy oracles of both packages, on the same numpy inputs.

Every compared output is integer or byte data (fingerprint pairs, indices,
block bytes, counts), so every comparison is exact.  The advisory float32
sums of squares are held against the port's own ``block_fp`` (bit-exact:
the same plain reduction) and against the Pallas kernel at rtol 1e-5
(another summation order, blocks of at most 1024 elements).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from proptest import cases

from repro.kernels.block_fp.ref import fingerprint_bytes
from repro.kernels.block_gather import gather_dirty as jax_gather_dirty
from repro.kernels.block_gather import gather_dirty_oracle as jax_oracle
from repro_torch.convert import state_from_numpy
from repro_torch.kernels import block_fp as bfp
from repro_torch.kernels.block_gather import (gather_dirty,
                                              gather_dirty_oracle,
                                              gather_dirty_plain,
                                              gather_tree_dirty,
                                              round_capacity)

# The suite runs in several worker processes at once: one intra-op
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

BB = 1024  # small blocks so modest arrays span many of them
SS_RTOL = 1e-5


def _drift(a: np.ndarray, flat_positions):
    """Bump a handful of elements; returns the drifted copy."""
    b = a.copy()
    fl = b.reshape(-1)
    for p in flat_positions:
        q = fl[p % fl.size]
        fl[p % fl.size] = (q + 1).astype(b.dtype) if b.dtype != np.bool_ \
            else ~q
    return b


def _u8(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


def _check(cur, base, *, capacity, bb=BB, pallas=True):
    """The port's gather must equal the oracles and (where the JAX wrapper
    takes the dtype) the interpreted Pallas kernel, bit for bit."""
    ref_fp = fingerprint_bytes(np.ascontiguousarray(base).tobytes(), bb)
    res = gather_dirty(state_from_numpy(cur, "cpu"), ref_fp,
                       capacity=capacity, block_bytes=bb)
    fp, idx, out, count = jax_oracle(cur, ref_fp, capacity=res.capacity,
                                     block_bytes=bb)
    mine = gather_dirty_oracle(cur, ref_fp, capacity=res.capacity,
                               block_bytes=bb)
    got_fp = res.fp.numpy().view(np.uint32)
    for want in ((fp, idx, out, count), mine):
        np.testing.assert_array_equal(got_fp, want[0])
        np.testing.assert_array_equal(res.idx.numpy(), want[1])
        assert int(res.count) == want[3]
        np.testing.assert_array_equal(_u8(res.block_bytes().numpy()), _u8(want[2]))
    # sums of squares: exactly block_fp's, so tracker scores agree
    _, bss = bfp.block_fingerprint(state_from_numpy(cur, "cpu"),
                                   block_bytes=bb)
    assert torch.equal(res.sumsq, bss)
    if pallas:
        j = jax_gather_dirty(jnp.asarray(cur), ref_fp, capacity=capacity,
                             block_bytes=bb, interpret=True)
        assert j.capacity == res.capacity
        np.testing.assert_array_equal(got_fp, np.asarray(j.fp))
        np.testing.assert_array_equal(res.idx.numpy(), np.asarray(j.idx))
        assert int(res.count) == int(j.count)
        np.testing.assert_array_equal(_u8(res.block_bytes().numpy()),
                                      _u8(j.blocks))
        np.testing.assert_allclose(res.sumsq.numpy(), np.asarray(j.sumsq),
                                   rtol=SS_RTOL, atol=0)
    return res, count


def _array(dtype, shape, seed):
    rs = np.random.RandomState(seed)
    if dtype == "bfloat16":
        return rs.standard_normal(shape).astype(ml_dtypes.bfloat16)
    if dtype == "bool":
        return rs.rand(*shape) < 0.5
    return (rs.standard_normal(shape) * 100).astype(dtype)


@pytest.mark.parametrize("dtype,shape", [
    ("float32", (5000,)),
    ("float16", (300, 7)),            # non-block-multiple, 2-byte dtype
    ("float32", (4, 33, 9)),          # ragged 3D
    ("int32", (64, 64)),
    ("int8", (123,)),                 # 1-byte dtype
    ("int16", (700,)),                # 2-byte integer
    ("bfloat16", (3000,)),
    ("bool", (4000,)),
    ("uint8", (2049,)),
    ("float64", (333,)),              # 8-byte dtype
])
def test_plain_matches_pallas_and_oracles(dtype, shape):
    base = _array(dtype, shape, seed=sum(shape))
    cur = _drift(base, [0, 7, base.size // 2, base.size - 1])
    # the JAX wrapper's Pallas path takes no 8-byte dtype under 32-bit jax
    _check(cur, base, capacity=8, pallas=dtype != "float64")


def test_clean_input_gathers_nothing():
    a = np.arange(9000, dtype=np.float32)
    res, count = _check(a, a, capacity=4)
    assert count == 0
    assert np.all(res.idx.numpy() == -1)
    assert not res.block_bytes().numpy().any()


def test_capacity_overflow_is_detectable_and_prefix_valid():
    """The misprediction contract: count is authoritative past capacity,
    the first `capacity` dirty blocks are still exact and ascending."""
    rs = np.random.RandomState(3)
    base = rs.standard_normal(64 * (BB // 4)).astype(np.float32)
    cur = _drift(base, [i * (BB // 4) for i in range(0, 64, 2)])  # 32 dirty
    res, count = _check(cur, base, capacity=8)
    assert count == 32 > res.capacity == 8
    np.testing.assert_array_equal(res.idx.numpy(), np.arange(0, 16, 2))


def test_no_reference_means_all_dirty():
    a = np.random.RandomState(1).standard_normal(4096).astype(np.float32)
    x = state_from_numpy(a, "cpu")
    nb = -(-a.nbytes // BB)
    for ref in (None, np.zeros((nb + 3, 2), np.uint32)):  # meta change
        res = gather_dirty(x, ref, capacity=nb, block_bytes=BB)
        fp, idx, out, count = jax_oracle(a, ref, capacity=nb,
                                         block_bytes=BB)
        assert int(res.count) == count == nb
        np.testing.assert_array_equal(res.idx.numpy(), np.arange(nb))
        np.testing.assert_array_equal(_u8(res.block_bytes().numpy()), _u8(out))


def test_empty_leaf_and_device_fp_reference():
    """An empty leaf is one zero block; a reference given as the device
    table (int32 bits) of ``block_fp`` works like the host table."""
    empty = torch.zeros(0)
    res = gather_dirty(empty, None, capacity=1, block_bytes=BB)
    assert int(res.count) == 1 and res.idx.tolist() == [0]
    assert not res.block_bytes().numpy().any()
    a = np.random.RandomState(2).standard_normal(3000).astype(np.float32)
    dev_ref, _ = bfp.block_fingerprint(state_from_numpy(a, "cpu"),
                                       block_bytes=BB)
    cur = _drift(a, [2000])
    res = gather_dirty(state_from_numpy(cur, "cpu"), dev_ref, capacity=2,
                       block_bytes=BB)
    # element 2000 of a float32 leaf is byte 8000: block 7 of 1 KiB blocks
    assert int(res.count) == 1 and res.idx.tolist() == [7, -1]


def test_property_sweep():
    def gen(rs):
        dtype = rs.choice(["float32", "float16", "int32"])
        n = int(rs.randint(1, 12000))
        nd = int(rs.randint(0, 10))
        cap = int(rs.randint(1, 16))
        bb = int(rs.choice([256, 1024]))
        seed = int(rs.randint(0, 2 ** 31))
        return dtype, n, nd, cap, bb, seed

    for dtype, n, nd, cap, bb, seed in cases(12, gen):
        rs = np.random.RandomState(seed)
        base = (rs.standard_normal(n) * 50).astype(dtype)
        cur = _drift(base, list(rs.randint(0, n, size=nd)))
        _check(cur, base, capacity=cap, bb=bb)


def test_tree_gather_matches_per_leaf():
    rs = np.random.RandomState(11)
    bases = [rs.standard_normal(3000).astype(np.float32),
             rs.standard_normal((70, 40)).astype(np.float32),
             rs.standard_normal(10).astype(ml_dtypes.bfloat16)]
    curs = [_drift(bases[0], [5]), _drift(bases[1], [100, 2000]),
            bases[2]]
    refs = [fingerprint_bytes(b.tobytes(), BB) for b in bases]
    results = gather_tree_dirty([state_from_numpy(c, "cpu") for c in curs],
                                refs, [4, 4, 1], block_bytes=BB)
    for cur, ref, res in zip(curs, refs, results):
        fp, idx, out, count = jax_oracle(cur, ref, capacity=res.capacity,
                                         block_bytes=BB)
        np.testing.assert_array_equal(res.fp.numpy().view(np.uint32), fp)
        np.testing.assert_array_equal(res.idx.numpy(), idx)
        assert int(res.count) == count
        np.testing.assert_array_equal(_u8(res.block_bytes().numpy()), _u8(out))
    assert [int(r.count) for r in results] == [1, 2, 0]


def test_plain_version_takes_exact_capacity():
    a = torch.arange(4096, dtype=torch.float32)
    res = gather_dirty_plain(a, None, capacity=3, block_bytes=BB)
    assert res.capacity == 3 and int(res.count) == 16
    with pytest.raises(ValueError):
        gather_dirty_plain(a, None, capacity=0, block_bytes=BB)


def test_quantize_composition_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="quantize"):
        gather_dirty(torch.zeros(10), None, capacity=1, block_bytes=BB,
                     quantize_int8=True)


@pytest.mark.parametrize("n,nb,want", [
    (0, 64, 1), (1, 64, 1), (3, 64, 4), (33, 64, 64), (500, 64, 64),
    (5, 6, 6),                           # pow2 clamp to n_blocks
])
def test_round_capacity(n, nb, want):
    assert round_capacity(n, nb) == want


def test_round_capacity_variants_are_logarithmic():
    caps = {round_capacity(n, 4096) for n in range(1, 4097)}
    assert len(caps) <= 13
