"""block_fp in the port against the JAX package: the plain PyTorch version
(what CPU tensors run) against the Pallas kernel in interpret mode and the
numpy oracle.

Fingerprint pairs must be exactly equal.  The float32 sum of squares is
advisory and summed in another order: rtol 1e-5 for blocks of at most 1024
elements.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.block_fp import block_fingerprint as jax_block_fp
from repro.kernels.block_fp import fingerprint_bytes as jax_fp_bytes
from repro.kernels.block_fp import fingerprint_tree as jax_fp_tree
from repro.kernels.block_fp import gather_blocks as jax_gather
from repro_torch.convert import state_from_numpy
from repro_torch.kernels import block_fp as bfp

# The suite runs in several worker processes at once: one intra-op
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

SS_RTOL = 1e-5


def _array(dtype: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    if dtype == "bfloat16":
        return rng.standard_normal(n).astype(ml_dtypes.bfloat16)
    if dtype == "float32":
        return rng.standard_normal(n).astype(np.float32)
    if dtype == "int32":
        return rng.randint(-2**31, 2**31 - 1, n, dtype=np.int64).astype(
            np.int32)
    if dtype == "uint8":
        return rng.randint(0, 256, n).astype(np.uint8)
    if dtype == "bool":
        return rng.rand(n) < 0.5
    raise ValueError(dtype)


CASES = [(dt, n, bb)
         for dt in ("bfloat16", "float32", "int32", "uint8", "bool")
         for n, bb in ((1, 256), (255, 256), (1000, 256), (4097, 1024),
                       (3 * 256, 1024))]


@pytest.mark.parametrize("dtype,n,bb", CASES)
def test_plain_matches_pallas_and_oracle(dtype, n, bb):
    arr = _array(dtype, n, seed=n)
    x = state_from_numpy(arr, "cpu")
    fp, ss = bfp.block_fingerprint(x, block_bytes=bb)
    got = fp.numpy().view(np.uint32)
    jfp, jss = jax_block_fp(jnp.asarray(arr), block_bytes=bb,
                            interpret=True)
    np.testing.assert_array_equal(got, np.asarray(jfp))
    raw = np.ascontiguousarray(arr).view(np.uint8).tobytes()
    np.testing.assert_array_equal(got, jax_fp_bytes(raw, bb))
    np.testing.assert_array_equal(got, bfp.fingerprint_bytes(raw, bb))
    np.testing.assert_allclose(ss.numpy(), np.asarray(jss), rtol=SS_RTOL)


def test_fingerprint_tree_matches_jax():
    """A multi-leaf unit: paths, dtype strings, byte lengths and pairs
    agree with the JAX package's fingerprint_tree."""
    tree = {"w": _array("bfloat16", 777, 1).reshape(7, 111),
            "b": {"z": _array("float32", 300, 2),
                  "a": _array("int32", 65, 3)},
            "mask": _array("bool", 1001, 4),
            "q": _array("uint8", 5, 5)}
    bb = 512
    mine = bfp.fingerprint_tree(state_from_numpy(tree, "cpu"), block_bytes=bb)
    theirs = jax_fp_tree(jax.tree.map(jnp.asarray, tree), block_bytes=bb,
                         interpret=True)
    assert [l.path for l in mine] == [l.path for l in theirs]
    assert [l.dtype for l in mine] == [l.dtype for l in theirs]
    assert [l.nbytes for l in mine] == [l.nbytes for l in theirs]
    assert [tuple(l.shape) for l in mine] == [tuple(l.shape) for l in theirs]
    host = bfp.tree_to_host(mine)
    for a, b in zip(host, theirs):
        np.testing.assert_array_equal(a.fp, np.asarray(b.fp))
        np.testing.assert_allclose(a.sumsq, np.asarray(b.sumsq),
                                   rtol=SS_RTOL)
    # leaves_match against device vectors and reloaded host tables
    assert bfp.leaves_match(mine, mine)
    assert bfp.leaves_match(mine, host)
    bumped = [bfp.LeafFP(**{**vars(h), "fp": h.fp.copy()}) for h in host]
    bumped[2].fp[0, 1] ^= 1
    assert not bfp.leaves_match(mine, bumped)


@pytest.mark.parametrize("n,idx", [(1000, [0, 3]), (1024, [1, 2]),
                                   (999, [3]), (10, [0])])
def test_gather_blocks_matches_jax(n, idx):
    arr = _array("bfloat16", n, seed=7)
    bb = 512
    got = bfp.gather_blocks(state_from_numpy(arr, "cpu"), np.array(idx),
                            block_bytes=bb)
    want = np.asarray(jax_gather(jnp.asarray(arr), np.array(idx),
                                 block_bytes=bb))
    assert got.numpy().tobytes() == want.tobytes()


def test_dirty_blocks_from_fingerprints():
    arr = _array("float32", 1000, seed=9)
    a = bfp.tree_to_host(bfp.fingerprint_tree(
        {"x": torch.from_numpy(arr.copy())}, block_bytes=256))[0]
    arr[130] += 1.0  # block 2 of 4 (64 floats per block)
    b = bfp.tree_to_host(bfp.fingerprint_tree(
        {"x": torch.from_numpy(arr)}, block_bytes=256))[0]
    np.testing.assert_array_equal(bfp.dirty_block_indices(b, a), [2])


def test_non_cpu_non_cuda_tensor_raises():
    """No silent fallback: a tensor that is neither on the CPU nor on a
    CUDA device is refused, not routed to the plain version."""
    x = torch.empty(16, device="meta")
    with pytest.raises(ValueError):
        bfp.fingerprint_unit([x], 64)
