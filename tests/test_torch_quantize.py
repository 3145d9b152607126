"""The int8 codec's quantize/dequantize in the port against the JAX package:
the plain PyTorch versions (what CPU tensors run) against the numpy codec
(``repro.checkpoint.workers.quantize_int8``/``dequantize_int8``) and the
Pallas kernels in interpret mode (``repro.kernels.quantize``), on the same
numpy inputs.

Tolerances: against the numpy codec, bitwise (q, scales, and the
dequantized float32 and bfloat16 values, bf16 rounded by ``ml_dtypes``):
the port computes numpy's float32 arithmetic, ``amax / 127`` and
``x / scale`` by division.  Against the Pallas kernel, scales within one
float32 ulp, and q equal in every block whose scale is equal: that kernel
computes ``amax * (1/127)``, a multiply by a rounded reciprocal, which is
one ulp off the division in some blocks (its own test compares scales at
rtol 1e-6); in those blocks a quotient can fall on the other side of a
rounding edge (bf16 inputs, whose few mantissa bits put quotients near
k + 0.5, show it), so q there is within 1.  The Pallas wrapper takes
``nb <= 64`` blocks or a multiple of 64, so its cases are sized so.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.workers import dequantize_int8, quantize_int8
from repro.kernels.quantize import dequantize as jax_dequantize
from repro.kernels.quantize import quantize as jax_quantize
from repro_torch.kernels import quantize as qz

# The suite runs in several worker processes at once: one intra-op
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

BF16 = ml_dtypes.bfloat16


def _special(n_blocks_random: int, seed: int) -> np.ndarray:
    """Random blocks, then: all zero; half-way ties (amax 127: scale 1);
    +-amax with a value just past it (the clip edge); f32 denormals; a
    denormal amax whose quotient underflows (scale 1 in numpy)."""
    rng = np.random.RandomState(seed)
    k = np.arange(256, dtype=np.float32)
    ties = (k % 64) - np.float32(31.5)
    ties[0], ties[1] = 127.0, -126.5
    clip = np.where(k % 2 == 0, 3.0, -3.0).astype(np.float32)
    clip[5] = np.float32(-3.0000002)
    denorm = ((k - 128) * np.float32(1e-41)).astype(np.float32)
    under = np.zeros(256, np.float32)
    under[7] = np.float32(1e-44)
    rand = (rng.randn(256 * n_blocks_random) * 3).astype(np.float32)
    return np.concatenate([rand, np.zeros(256, np.float32), ties, clip,
                           denorm, under])


CASES = [("n1", 1), ("n255", 255), ("n256", 256), ("n257", 257),
         ("n64x256+3", 64 * 256 + 3), ("special", None)]


def _input(case, dtype, seed=0):
    name, n = case
    if n is None:
        x = _special(3, seed)
    else:
        x = (np.random.RandomState(seed + n).randn(n) * 3).astype(np.float32)
    return x.astype(BF16) if dtype == "bfloat16" else x


def _torch(x: np.ndarray) -> torch.Tensor:
    if x.dtype == BF16:
        return torch.from_numpy(x.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(x.copy())


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_versions_equal_the_numpy_codec_bitwise(case, dtype):
    x = _input(case, dtype)
    q, s = qz.quantize_plain(_torch(x))
    qn, sn = quantize_int8(x)
    assert q.shape == (qz.n_quant_blocks(x.size), 256)
    assert s.shape == (qz.n_quant_blocks(x.size), 1)
    np.testing.assert_array_equal(_bits(q.numpy().reshape(-1)), _bits(qn))
    np.testing.assert_array_equal(_bits(s.numpy().reshape(-1)), _bits(sn))
    want = dequantize_int8(qn, sn, x.size)
    got = qz.dequantize_plain(q, s, x.size, torch.float32)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    got_bf = qz.dequantize_plain(q, s, x.size, torch.bfloat16)
    np.testing.assert_array_equal(_bits(got_bf.view(torch.uint16).numpy()),
                                  _bits(want.astype(BF16)))


def test_nan_and_inf_blocks_give_numpys_scales():
    x = np.ones(3 * 256, np.float32)
    x[10] = np.nan
    x[300] = -np.inf
    q, s = qz.quantize_plain(torch.from_numpy(x))
    _, sn = quantize_int8(x)
    s = s.numpy().reshape(-1)
    assert np.isnan(s[0]) and np.isnan(sn[0])
    assert s[1] == sn[1] == np.inf
    assert s[2] == sn[2] == np.float32(1.0) / np.float32(127.0)
    np.testing.assert_array_equal(q.numpy()[2], np.full(256, 127, np.int8))


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 255, 257, 64 * 256, 128 * 256 - 5,
                               3 * 256 * 5])
def test_plain_versions_track_the_pallas_kernel(n, dtype):
    x = (np.random.RandomState(n).randn(n) * 2).astype(np.float32)
    if dtype == "bfloat16":
        x = x.astype(BF16)
    nb = qz.n_quant_blocks(n)
    assert nb <= 64 or nb % 64 == 0      # what the Pallas wrapper takes
    jq, js = jax_quantize(jnp.asarray(x), interpret=True)
    q, s = qz.quantize_plain(_torch(x))
    ulps = _ulps(s.numpy(), np.asarray(js)).reshape(-1)
    assert ulps.max() <= 1
    same = ulps == 0
    np.testing.assert_array_equal(q.numpy()[same], np.asarray(jq)[same])
    # a one-ulp scale can move a quotient across a rounding edge
    dq = np.abs(q.numpy()[~same].astype(int) - np.asarray(jq)[~same])
    assert dq.size == 0 or dq.max() <= 1
    # dequantize of the same (q, scales) is one float32 multiply in both
    jd = jax_dequantize(jq, js, shape=(n,), interpret=True)
    d = qz.dequantize_plain(torch.from_numpy(np.array(jq)),
                            torch.from_numpy(np.array(js)), n,
                            torch.float32)
    np.testing.assert_array_equal(_bits(d.numpy()), _bits(np.asarray(jd)))


def test_unit_records_lay_out_q_then_scales():
    leaves = [_torch(_input(("a", 1000), "float32")),
              _torch(_input(("b", 300), "bfloat16")),
              torch.zeros(0),
              _torch(_input(("special", None), "float32"))]
    unit = qz.quantize_unit(leaves)
    assert all(off % 16 == 0 for off in unit.offsets)
    for i, x in enumerate(leaves):
        q, s = qz.quantize_plain(x)
        nb = qz.n_quant_blocks(x.numel())
        rec = unit.record(i)
        assert rec.numel() == qz.record_nbytes(x.numel()) == 260 * nb
        assert torch.equal(unit.q(i), q) and torch.equal(unit.scales(i), s)
        assert torch.equal(rec[:256 * nb].view(torch.int8), q.reshape(-1))
        assert torch.equal(rec[256 * nb:].view(torch.float32), s.reshape(-1))
    q, s = qz.quantize(leaves[0])
    assert torch.equal(q, unit.q(0)) and torch.equal(s, unit.scales(0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64])
def test_dequantize_unit_writes_the_leaves_in_place(dtype):
    xs = [torch.from_numpy(_special(2, 3)), torch.randn(700) * 5,
          torch.randn(3, 256)]
    unit = qz.quantize_unit(xs)
    dsts = [torch.full(x.shape, 7.0, dtype=dtype) for x in xs]
    ptrs = [d.data_ptr() for d in dsts]
    qz.dequantize_unit([(unit.q(i), unit.scales(i))
                        for i in range(len(xs))], dsts)
    for i, (x, d) in enumerate(zip(xs, dsts)):
        assert d.data_ptr() == ptrs[i]
        want = dequantize_int8(unit.q(i).numpy().reshape(-1),
                               unit.scales(i).numpy().reshape(-1), x.numel())
        np.testing.assert_array_equal(
            _bits(d.reshape(-1).to(torch.float32).numpy()),
            _bits(torch.from_numpy(want).to(dtype).to(torch.float32)
                  .numpy()))
    out = qz.dequantize(unit.q(1), unit.scales(1), 700, dtype)
    assert torch.equal(out, dsts[1])


def test_wrappers_reject_what_they_do_not_take():
    with pytest.raises(ValueError, match="does not run on meta"):
        qz.quantize_unit([torch.empty(300, device="meta")])
    with pytest.raises(ValueError):
        qz.quantize_unit([])
    q, s = qz.quantize(torch.randn(600))
    with pytest.raises(ValueError, match="does not fit"):
        qz.dequantize_unit([(q, s)], [torch.empty(300)])
    with pytest.raises(ValueError, match="one record per leaf"):
        qz.dequantize_unit([(q, s)], [])


# ---- the kernel launch's host half: the leaf table built from integer
# offsets (pointers compared as integers on the CPU), and the stages its
# first-stage numbers give when walked as the kernel walks them

def _table_leaves(off_dtype):
    """Leaves of mixed sizes in both kernel dtypes, an empty one, and one
    that starts 4 (float32) or 2 (bfloat16) bytes past 16."""
    leaves = []
    for dtype in (torch.float32, torch.bfloat16):
        for n in (1, 255, 256, 257, 64 * 256 + 3):
            leaves.append(torch.randn(n).to(dtype))
    leaves.insert(3, torch.zeros(0))
    base = torch.randn(5 * 256 + 20).to(off_dtype)
    leaves.append(base[1:])
    return leaves


@pytest.mark.parametrize("off_dtype", [torch.float32, torch.bfloat16])
def test_leaf_table_rows_equal_the_record_views(off_dtype):
    leaves = _table_leaves(off_dtype)
    assert leaves[-1].data_ptr() % 16 == leaves[-1].element_size()
    unit = qz.quantize_unit(leaves)
    rows = qz.record_rows(unit, leaves)
    tables = qz.leaf_tables(rows)
    assert len(tables) == 1
    table = tables[0]
    nonempty = [i for i, x in enumerate(leaves) if x.numel()]
    assert len(table.rows) == len(rows) == len(nonempty)
    blocks = stages = 0
    for row, i in zip(table.rows, nonempty):
        x = leaves[i]
        code = 0 if x.dtype == torch.float32 else 1
        assert row == (x.data_ptr(), unit.q(i).data_ptr(),
                       unit.scales(i).data_ptr(), x.numel(), blocks, stages,
                       code)
        blocks += unit.q(i).shape[0]
        stages += qz.leaf_stages(x.numel(), code)
    assert (table.blocks, table.stages) == (blocks, stages)
    # the packed bytes are the kernel's QuantLeaf array (56 bytes a row)
    packed = np.frombuffer(table.packed, np.int64).reshape(-1, 7)
    np.testing.assert_array_equal(
        packed, [[*r[:6], r[6]] for r in table.rows])


def _stage_units():
    sizes_f = [1, 256, 16 * 256, 16 * 256 + 1, 37 * 256 + 5, 3, 0, 300]
    sizes_b = [32 * 256, 32 * 256 - 1, 65 * 256 + 200, 255, 1]
    yield "mixed", [torch.zeros(n) for n in sizes_f] + [
        torch.zeros(n, dtype=torch.bfloat16) for n in sizes_b]
    yield "more than one table", [
        torch.zeros(1 + 97 * i, dtype=torch.bfloat16 if i % 3 else
                    torch.float32) for i in range(qz.MAX_LEAVES + 9)]
    yield "one large leaf", [torch.zeros(1000 * 256 + 17)]


def _stage_span(n, dtype, ls):
    """``(first block, blocks)`` of stage ``ls`` of a leaf, as
    ``stage_span`` in csrc/quantize.cu cuts it."""
    bps, full = qz.stage_blocks(dtype), n // 256
    if ls < -(-full // bps):
        return ls * bps, min(bps, full - ls * bps)
    return full, 1


def _stage_list(table):
    """``(leaf, first block, blocks)`` of every stage of a launch, the
    leaf found as the kernel finds it: a cursor moved forward through the
    table's first stages."""
    leaf, rows = 0, table.rows
    for st in range(table.stages):
        while leaf + 1 < len(rows) and rows[leaf + 1][5] <= st:
            leaf += 1
        _, _, _, n, _, first, dtype = rows[leaf]
        yield (leaf, *_stage_span(n, dtype, st - first))


@pytest.mark.parametrize("name,leaves", list(_stage_units()),
                         ids=[n for n, _ in _stage_units()])
def test_stage_list_covers_every_block_once(name, leaves):
    unit = qz.quantize_unit(leaves)
    tables = qz.leaf_tables(qz.record_rows(unit, leaves))
    assert sum(len(t.rows) for t in tables) == sum(
        1 for x in leaves if x.numel())
    for table in tables:
        assert len(table.rows) <= qz.MAX_LEAVES
        seen = [np.zeros(qz.n_quant_blocks(r[3]), int) for r in table.rows]
        last = 0
        for st, (leaf, b0, nb) in enumerate(_stage_list(table)):
            _, _, _, n, _, first, code = table.rows[leaf]
            assert leaf >= last                   # the cursor moves forward
            last = leaf
            assert first <= st < first + qz.leaf_stages(n, code)
            assert 1 <= nb <= qz.stage_blocks(code)
            assert b0 + nb <= qz.n_quant_blocks(n)  # within its leaf
            if (b0 + nb) * 256 > n:               # the padded tail: alone
                assert nb == 1 and b0 == n // 256
            seen[leaf][b0:b0 + nb] += 1
        assert st + 1 == table.stages
        for s in seen:
            np.testing.assert_array_equal(s, 1)    # each block once
        assert table.blocks == sum(len(s) for s in seen)
