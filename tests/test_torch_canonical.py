"""The canonical save path of the port (``CheckpointManager(fingerprint=
False)``, ``--no-fingerprint``) and its object formats against the JAX
package: the XOR delta codec (XD01), canonical full, delta and int8
objects, mixed fingerprint/canonical stores, restores, hot-swaps and the
trainer.

Both packages get the same train state: JAX-initialized, converted to the
port through numpy, and drifted in a few rows of the embedding by a numpy
``RandomState`` (so later events write XOR deltas against the first
event's full objects).  Stores use 4 KiB fingerprint blocks; the JAX side
runs with ``repro.checkpoint.workers.HAVE_ZSTD`` patched to False, as
tests/test_torch_int8.py does, so its int8 records are not compressed.
Manifests, objects and restored tensors are byte data, so every comparison
of them is exact; the trainers' losses are held to 5e-3 of each other (the
port's train-step tolerance against JAX, tests/test_torch_int8.py).
"""
import shutil
import sys
import threading
import tracemalloc

import jax
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

import repro.checkpoint.workers as jax_workers
from repro.checkpoint.chunk_store import ChunkStore as JaxChunkStore
from repro.checkpoint.chunk_store import ReadSession as JaxReadSession
from repro.checkpoint.saver import CheckpointManager as JaxManager
from repro.checkpoint.serial import ChunkCorruption as JaxChunkCorruption
from repro.checkpoint.swap import WeightService as JaxWeightService
from repro.configs import get_config as jax_get_config
from repro.core import LayerRegistry as JaxRegistry
from repro.core.policies import make_policy as jax_make_policy
from repro.launch import steps as jax_steps
from repro.launch.train import SimulatedFailure as JaxSimulatedFailure
from repro.launch.train import train as jax_train
from repro.models import build_model as jax_build_model
from repro_torch.checkpoint import _msgpack, workers
from repro_torch.checkpoint.chunk_store import (ChunkStore, ReadSession,
                                                content_digest)
from repro_torch.checkpoint.overlap import OverlappedSaver
from repro_torch.checkpoint import restore as restore_mod
from repro_torch.checkpoint.restore import device_materializer
from repro_torch.checkpoint.saver import CheckpointManager
from repro_torch.checkpoint.serial import ChunkCorruption, flatten_with_paths
from repro_torch.checkpoint.swap import WeightService
from repro_torch.configs import get_config
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core.layer_registry import LayerRegistry
from repro_torch.core.policies import make_policy
from repro_torch.launch import steps
from repro_torch.launch.train import SimulatedFailure, train
from repro_torch.models import build_model

# The suite runs in several worker processes at once: one intra-op
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

ARCH = "yi-9b"
BB = 4096
CPU = torch.device("cpu")
GAP = workers.DELTA_MERGE_GAP
STATS = ("written_bytes", "dedup_hits", "delta_chunks", "full_chunks",
         "logical_bytes", "hashed_bytes")


@pytest.fixture(autouse=True)
def _jax_without_zstd(monkeypatch):
    monkeypatch.setattr(jax_workers, "HAVE_ZSTD", False)


@pytest.fixture(scope="module")
def sides():
    jmodel = jax_build_model(jax_get_config(ARCH, reduced=True))
    pmodel = build_model(get_config(ARCH, reduced=True))
    s0 = jax.tree.map(np.asarray,
                      jax_steps.init_state(jmodel, jax.random.key(0)))
    return jmodel, pmodel, s0


def _poke(np_state, seed):
    """A copy of a numpy state with a few elements of one embedding row
    changed in the weights, master and m (an XOR delta of the embed units
    is a few segments)."""
    rng = np.random.RandomState(seed)
    out = jax.tree.map(np.array, np_state)
    row = rng.randint(out["params"]["embed"]["w"].shape[0])
    for tree in (out["params"], out["opt"]["master"], out["opt"]["m"]):
        w = tree["embed"]["w"]
        w[row, :5] = (w[row, :5].astype(np.float32)
                      + rng.rand(5).astype(np.float32)).astype(w.dtype)
    return out


def _states(s0, n):
    """``n`` states: the initial one twice (a re-save), then drifting."""
    out = [s0, s0]
    while len(out) < n:
        out.append(_poke(out[-1], len(out)))
    return out


def _jax_mgr(root, jmodel, *, policy="full", **kw):
    kw = {"codec": "none", "async_save": False, "fingerprint": False, **kw}
    return JaxManager(root, JaxRegistry(jmodel),
                      jax_make_policy(policy, jmodel.layer_units()),
                      fp_block_bytes=BB, **kw)


def _port_mgr(root, pmodel, *, policy="full", **kw):
    kw = {"codec": "none", "async_save": False, "fingerprint": False, **kw}
    return CheckpointManager(root, LayerRegistry(pmodel),
                             make_policy(policy, pmodel.layer_units()),
                             fp_block_bytes=BB, **kw)


def _tree_bytes(root):
    """Every object and manifest file of a store, and LATEST."""
    files = sorted((root / "objects").glob("*/*.chunk")) + sorted(
        (root / "manifests").glob("*")) + [root / "LATEST"]
    return {str(p.relative_to(root)): p.read_bytes() for p in files}


def _formats(root):
    return sorted(workers.parse_envelope(p.read_bytes(), p.stem)["format"]
                  for p in (root / "objects").glob("*/*.chunk"))


def _np(tree):
    return state_to_numpy(tree, bf16_dtype=ml_dtypes.bfloat16)


def _assert_np_equal(a, b):
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, p
        assert x.tobytes() == y.tobytes(), p


# ------------------------------------------------------------ XOR codec
def _check_delta(cur, base, gap, window):
    want = jax_workers.delta_encode(cur, base, gap=gap, compress="none")
    got = workers.delta_encode(cur, base, gap=gap, window=window)
    assert b"".join(bytes(p) for p in got.parts) == want
    assert got.nbytes == len(want)
    assert want[:4] == workers.DELTA_MAGIC and jax_workers.is_delta(want)
    assert bytes(workers.delta_decode(want, base)) == cur
    assert jax_workers.delta_decode(want, base) == cur


@st.composite
def _delta_cases(draw):
    cur = draw(st.binary(max_size=600))
    how = draw(st.sampled_from(["equal", "shorter", "longer", "flips",
                                "random", "empty"]))
    if how == "empty":
        base = b""
    elif how == "random":
        base = draw(st.binary(max_size=600))
    else:
        base = bytearray(cur)
        if how == "shorter":
            base = base[:draw(st.integers(0, len(cur)))]
        elif how == "longer":
            base += draw(st.binary(min_size=1, max_size=80))
        for i in draw(st.lists(st.integers(0, max(len(base) - 1, 0)),
                               max_size=12)):
            if base:
                base[i] ^= draw(st.integers(1, 255))
        base = bytes(base)
    # gaps on either side of 31, where the encoder changes how it finds
    # runs; windows below, at and above its 16-byte blocks
    return (cur, base, draw(st.sampled_from([1, 7, 30, 31, GAP, 100])),
            draw(st.sampled_from([1, 3, 16, 64, 65, 4096])))


@settings(max_examples=300, deadline=None)
@given(_delta_cases())
@example((b"", b"", GAP, 64))
@example((b"", b"\x01\x02", GAP, 64))
def test_delta_codec_is_byte_identical_to_jax(case):
    _check_delta(*case)


@pytest.mark.parametrize("window", [64, 63, 100])
@pytest.mark.parametrize("apart", [GAP - 1, GAP, GAP + 1, GAP + 2])
@pytest.mark.parametrize("first", [62, 63, 64, 65])
def test_runs_apart_across_the_window_edge(window, apart, first):
    """Two differing bytes ``apart`` apart, the first at or around a
    window edge: one segment when apart <= gap, two otherwise, as in
    JAX."""
    cur = bytearray(300)
    cur[first] = 0x11
    cur[first + apart] = 0x22
    cur[first + apart + 3] = 0x33
    _check_delta(bytes(cur), bytes(200), GAP, window)
    body = msgpack.unpackb(b"".join(bytes(p) for p in workers.delta_encode(
        bytes(cur), bytes(300), window=window).parts)[5:], raw=False)
    assert len(body["segs"]) == (1 if apart <= GAP else 2)


def test_a_blob_diffs_as_its_bytes():
    rng = np.random.RandomState(3)
    parts = [rng.randint(0, 256, n).astype(np.uint8).tobytes()
             for n in (5, 70000, 0, 3, 200000)]
    cur = b"".join(parts)
    base = bytearray(cur)
    for i in rng.randint(0, len(cur), 40):
        base[i] ^= 0x5A
    want = jax_workers.delta_encode(cur, bytes(base), compress="none")
    got = workers.delta_encode(_msgpack.Blob(parts), bytes(base),
                               window=1 << 12)
    assert b"".join(bytes(p) for p in got.parts) == want
    # a base in pieces whose edges fall inside windows and segments, and
    # one shorter than ``cur``
    cuts = [0, 7, 4096, 4100, 70001, len(base)]
    pieces = _msgpack.Blob([base[a:b] for a, b in zip(cuts, cuts[1:])])
    got = workers.delta_encode(_msgpack.Blob(parts), pieces, window=1 << 12)
    assert b"".join(bytes(p) for p in got.parts) == want
    assert bytes(workers.delta_decode(want, pieces)) == cur
    short = _msgpack.Blob([base[:3], base[3:90000]])
    got = workers.delta_encode(cur, short, window=1 << 12)
    assert b"".join(bytes(p) for p in got.parts) == jax_workers.delta_encode(
        cur, bytes(base[:90000]), compress="none")
    assert bytes(workers.delta_decode(bytes(b"".join(
        bytes(p) for p in got.parts)), short)) == cur
    assert content_digest(_msgpack.Blob(parts)) == \
        content_digest(cur) == jax_workers.blake2_hex(cur)


def _peak(fn):
    """(result, peak bytes that Python allocated while ``fn`` ran)."""
    tracemalloc.start()
    try:
        out = fn()
        return out, tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()


def test_limit_stops_the_encoder_early_in_bounded_memory():
    """Every byte differs: with ``limit`` the encoder gives up once its
    segments reach it, holding a few windows and no more; without, it
    returns the JAX bytes.  Half the bytes differ, in 64 KiB runs: the
    encoder holds its output and a few windows beside it.  (JAX's encoder
    holds the XOR and 8 bytes per differing byte: 9 * n and 5 * n.)"""
    n, window = 32 << 20, 1 << 20
    cur = np.full(n, 0x55, np.uint8).tobytes()
    base = bytes(n)
    got, peak = _peak(lambda: workers.delta_encode(
        cur, base, window=window, limit=0.9 * n))
    assert got is None
    assert peak < 8 * window
    half = np.zeros(n, np.uint8)
    half.reshape(-1, 1 << 17)[:, :1 << 16] = 0x55
    got, peak = _peak(lambda: workers.delta_encode(
        memoryview(half), base, window=window))
    assert n // 2 < got.nbytes < n // 2 + window
    assert peak - got.nbytes < 8 * window
    small = cur[:5000]
    assert workers.delta_encode(small, base[:5000], limit=5000) is None
    got = workers.delta_encode(small, base[:5000], limit=5100)
    assert b"".join(bytes(p) for p in got.parts) == \
        jax_workers.delta_encode(small, base[:5000], compress="none")


def test_compressed_and_corrupt_deltas_raise(monkeypatch):
    """A zstd-compressed XD01 of the JAX package decodes (the port's own
    zstd decoder) to JAX's bytes; a mangled frame in it, a bad magic and a
    junk body raise."""
    monkeypatch.setattr(jax_workers, "HAVE_ZSTD", True)
    cur, base = b"abcdef" * 50, b"abc"
    blob = jax_workers.delta_encode(cur, base, compress="zstd")
    assert blob[4] == 1
    assert bytes(workers.delta_decode(blob, base)) == \
        jax_workers.delta_decode(blob, base) == cur
    with pytest.raises(ChunkCorruption, match="zstd"):
        workers.delta_decode(blob[:-3], base)
    with pytest.raises(ValueError, match="magic"):
        workers.delta_decode(b"XD02\x00", b"")
    with pytest.raises(ValueError):
        workers.delta_decode(b"XD01\x00junk", b"")


# --------------------------------------------------------------- stores
@pytest.mark.parametrize("async_save", [False, True])
@pytest.mark.parametrize("codec", ["none", "int8"])
def test_canonical_saves_are_byte_identical_to_jax(tmp_path, sides, codec,
                                                   async_save):
    """Eight events (the initial state twice, then drifting embed rows)
    saved with ``fingerprint=False`` by both packages: equal stats per
    event and byte-identical manifests and objects.  Lossless: the embed
    units go full, dedup, four XOR deltas, then rebase to full; int8: never
    a delta."""
    jmodel, pmodel, s0 = sides
    jm = _jax_mgr(tmp_path / "jax", jmodel, codec=codec,
                  async_save=async_save)
    pm = _port_mgr(tmp_path / "port", pmodel, codec=codec,
                   async_save=async_save)
    deltas = []
    for step, s in enumerate(_states(s0, 8), start=1):
        jm.save(s, step=step)
        pm.save(state_from_numpy(s, "cpu"), step=step)
        for k in STATS:
            assert pm.last_save_stats[k] == jm.last_save_stats[k], (step, k)
        assert pm.last_save_stats["dirty_block_frac"] == 1.0
        assert pm.last_save_stats["hashed_bytes"] == \
            pm.last_save_stats["logical_bytes"]
        deltas.append(pm.last_save_stats["delta_chunks"])
    jm.close()
    pm.close()
    assert _tree_bytes(tmp_path / "port") == _tree_bytes(tmp_path / "jax")
    if codec == "none":
        # embed weights and opt: full, dedup, four deltas, rebase, delta
        assert deltas == [0, 0, 2, 2, 2, 2, 0, 2]
        assert "delta" in _formats(tmp_path / "port")
    else:
        assert deltas == [0] * 8
        assert "delta" not in _formats(tmp_path / "port")


def test_the_canonical_int8_save_moves_the_unit_and_its_records(tmp_path,
                                                                sides):
    """The digest is over the lossless bytes, so the whole unit crosses,
    and beside it the quantized leaves' records (what is framed)."""
    from repro_torch.kernels import quantize as qz
    from repro_torch.dtypes import dtype_name

    _, pmodel, s0 = sides
    state = state_from_numpy(s0, "cpu")
    pm = _port_mgr(tmp_path, pmodel, codec="int8")
    pm.save(state, step=1)
    want = 0
    for name in pm.registry.unit_names():
        for tree in (pm.registry.extract_unit(state["params"], name),
                     pm.registry.extract_opt_unit(state["opt"], name)):
            for _, x in flatten_with_paths(tree):
                want += x.numel() * x.element_size()
                if workers.int8_eligible(dtype_name(x.dtype), x.shape):
                    want += qz.record_nbytes(x.numel())
    assert pm.last_save_stats["d2h_bytes"] == want
    pm.close()


def test_mixed_stores_are_byte_identical_to_jax(tmp_path, sides):
    """fp events, then canonical ones (XOR deltas whose bases are fp
    objects, their tables checked first), then fp again (full: a canonical
    entry has no table to compare), across manager restarts: both packages
    write the same bytes, and each restores the other's store."""
    jmodel, pmodel, s0 = sides
    states = _states(s0, 7)
    plan = [(True, 1), (True, 2), (True, 3), (False, 4), (False, 5),
            (True, 6), (True, 7)]
    for pkg in ("jax", "port"):
        mgr, fp = None, None
        for fingerprint, step in plan:
            if fingerprint != fp:
                if mgr is not None:
                    mgr.close()
                make = _jax_mgr if pkg == "jax" else _port_mgr
                model = jmodel if pkg == "jax" else pmodel
                mgr, fp = make(tmp_path / pkg, model,
                               fingerprint=fingerprint), fingerprint
            s = states[step - 1]
            mgr.save(s if pkg == "jax" else state_from_numpy(s, "cpu"),
                     step=step)
            if pkg == "port" and step == 4:
                # every unit: its content is new to the canonical digests
                assert mgr.last_save_stats["delta_chunks"] == 14
            if pkg == "port" and step == 6:
                # the canonical deltas' base is step 1's fp object, whose
                # table anchors block deltas again
                assert mgr.last_save_stats["delta_chunks"] == 2
                embed = mgr.manifests.load(6).entries["embed"]["weights"]
                assert embed.delta_base == mgr.manifests.load(1).entries[
                    "embed"]["weights"].digest
        mgr.close()
    assert _tree_bytes(tmp_path / "port") == _tree_bytes(tmp_path / "jax")
    fmts = _formats(tmp_path / "port")
    assert "delta" in fmts and "block_delta" in fmts
    for step in (5, 7):
        for writer in ("jax", "port"):
            got = _port_mgr(tmp_path / writer, pmodel).restore(
                steps.state_specs(pmodel), device=CPU, step=step)
            _assert_np_equal(
                _np({"params": got["params"],
                                "opt": got["opt"]}),
                {"params": states[step - 1]["params"],
                 "opt": states[step - 1]["opt"]})


@pytest.mark.parametrize("parts", [("params", "opt"), ("params",)])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_canonical_stores_restore_across_packages(tmp_path, sides, writer,
                                                  parts):
    """A canonical store with XOR-delta chains and a rebase restores in
    both packages to the saved tensors, bit for bit; a weights-only
    restore reads no optimizer object."""
    jmodel, pmodel, s0 = sides
    states = _states(s0, 7)
    make = _jax_mgr if writer == "jax" else _port_mgr
    mgr = make(tmp_path, jmodel if writer == "jax" else pmodel)
    for step, s in enumerate(states, start=1):
        mgr.save(s if writer == "jax" else state_from_numpy(s, "cpu"),
                 step=step)
    mgr.close()
    want = {"params": states[-1]["params"], "opt": states[-1]["opt"]}
    for step in (6, 7):   # a delta chain, then the rebase
        pm = _port_mgr(tmp_path, pmodel)
        specs = steps.state_specs(pmodel)
        got = pm.restore({p: specs[p] for p in parts}, device=CPU,
                         step=step, parts=parts)
        assert pm.last_restore_stats["fallback_units"] == {}
        pm.close()
        jm = _jax_mgr(tmp_path, jmodel)
        jspecs = jax_steps.state_specs(jmodel)
        jgot = jm.restore({p: jspecs[p] for p in parts}, step=step,
                          parts=parts)
        jm.close()
        want = {"params": states[step - 1]["params"],
                "opt": states[step - 1]["opt"]}
        got_np = _np({p: got[p] for p in parts})
        _assert_np_equal(got_np, {p: want[p] for p in parts})
        _assert_np_equal(got_np, {p: jax.tree.map(np.asarray, jgot[p])
                                  for p in parts})


def test_a_junk_xor_delta_falls_back_as_in_jax(tmp_path, sides):
    """An object overwritten with an XD01 envelope of junk (its base
    itself, or a real full base): ``ChunkCorruption``, and the restore of
    both packages falls back to the older manifest's entry."""
    jmodel, pmodel, s0 = sides
    s1 = _states(s0, 3)[2]
    for writer in ("jax", "port"):
        root = tmp_path / writer
        mgr = (_jax_mgr(root, jmodel) if writer == "jax"
               else _port_mgr(root, pmodel))
        mgr.save(s0 if writer == "jax" else state_from_numpy(s0, "cpu"),
                 step=10)
        mgr.save(s1 if writer == "jax" else state_from_numpy(s1, "cpu"),
                 step=20)
        mgr.close()
    ref = _port_mgr(tmp_path / "port", pmodel).manifests.load(20)
    vref = ref.entries["embed"]["weights"]
    oref = ref.entries["embed"]["opt"]
    assert vref.stored == oref.stored == "delta"
    for writer in ("jax", "port"):
        root = tmp_path / writer
        for digest, base in ((vref.digest, vref.digest),
                             (oref.digest, oref.delta_base)):
            (root / "objects" / digest[:2] / f"{digest}.chunk").write_bytes(
                msgpack.packb({"v": 1, "format": "delta", "base": base,
                               "payload": b"XD01\x00junk"},
                              use_bin_type=True))
    with pytest.raises(ChunkCorruption):
        ReadSession(ChunkStore(tmp_path / "port")).read(vref.digest)
    with pytest.raises(JaxChunkCorruption):
        JaxReadSession(JaxChunkStore(tmp_path / "jax")).read(vref.digest)
    pm = _port_mgr(tmp_path / "port", pmodel)
    got = pm.restore(steps.state_specs(pmodel), device=CPU)
    fallbacks = pm.last_restore_stats["fallback_units"]
    pm.close()
    jm = _jax_mgr(tmp_path / "jax", jmodel)
    jgot = jm.restore(jax_steps.state_specs(jmodel))
    assert fallbacks == jm.last_restore_stats["fallback_units"] == {
        "embed/weights": 10, "embed/opt": 10}
    jm.close()
    _assert_np_equal(_np({"params": got["params"]}),
                     {"params": jax.tree.map(np.asarray, jgot["params"])})


def test_read_canonical_of_a_lossy_object_raises_as_in_jax(tmp_path, sides):
    """A canonical int8 object decodes to other tensors than its digest
    hashes: ``read_canonical`` raises "digest mismatch" in both packages
    (a lossy object never anchors a delta, so no save reaches this), while
    a read of its records checks their crc32 alone."""
    jmodel, pmodel, s0 = sides
    jm = _jax_mgr(tmp_path / "jax", jmodel, codec="int8")
    jm.save(s0, step=1)
    jm.close()
    digest = jm.manifests.load(1).entries["embed"]["opt"].digest
    with pytest.raises(JaxChunkCorruption, match="digest mismatch"):
        JaxChunkStore(tmp_path / "jax").read_canonical(digest)
    store = ChunkStore(tmp_path / "jax")
    with pytest.raises(ChunkCorruption, match="digest mismatch"):
        store.read_canonical(digest, session=ReadSession(
            store, materialize=device_materializer(CPU)))
    items, fp_blob = store.read_items(digest)
    assert fp_blob is None
    assert all(isinstance(d, workers.Int8Record) for *_, d in items)
    with pytest.raises(RuntimeError, match="materialize"):
        store.read_canonical(digest)


def test_canonical_delta_over_a_corrupt_fp_base_writes_full(tmp_path,
                                                            sides):
    """A canonical event whose fp base has a payload byte flipped under a
    recomputed crc32: its table check (``materialize``, on the saving
    tensors' device) catches it, and the unit is written full, as the JAX
    store's host check makes it."""
    jmodel, pmodel, s0 = sides
    s1 = _states(s0, 3)[2]
    for pkg in ("jax", "port"):
        make = _jax_mgr if pkg == "jax" else _port_mgr
        model = jmodel if pkg == "jax" else pmodel
        conv = (lambda s: s) if pkg == "jax" else \
            (lambda s: state_from_numpy(s, "cpu"))
        mgr = make(tmp_path / pkg, model, fingerprint=True)
        mgr.save(conv(s0), step=1)
        mgr.close()
        digest = mgr.manifests.load(1).entries["embed"]["opt"].digest
        _flip_first_record_byte(tmp_path / pkg, digest)
        mgr = make(tmp_path / pkg, model)
        mgr.save(conv(s1), step=2)
        # every unit but embed/opt: a delta against its fp object
        assert mgr.last_save_stats["delta_chunks"] == 13
        assert mgr.manifests.load(2).entries["embed"]["opt"].stored == \
            "full"
        mgr.close()
    assert _tree_bytes(tmp_path / "port") == _tree_bytes(tmp_path / "jax")


def test_a_failing_table_check_raises_and_is_not_taken_for_corruption(
        tmp_path, sides, monkeypatch):
    """An error of the device-side check of an fp base (here the one a
    kernel's wrapper raises on a tensor it cannot take) is no sign of a
    corrupt object: the canonical save and ``read_canonical`` raise it, and
    nothing is written full in its place."""
    _, pmodel, s0 = sides
    mgr = _port_mgr(tmp_path, pmodel, fingerprint=True)
    mgr.save(state_from_numpy(s0, "cpu"), step=1)
    mgr.close()
    digest = mgr.manifests.load(1).entries["embed"]["opt"].digest

    def refuse(tree, fp_blob, digest):
        raise ValueError("block_fp needs contiguous tensors")

    monkeypatch.setattr(restore_mod, "verify_placed", refuse)
    store = ChunkStore(tmp_path)
    with pytest.raises(ValueError, match="contiguous"):
        store.read_canonical(digest, session=ReadSession(
            store, materialize=device_materializer(CPU)))
    mgr = _port_mgr(tmp_path, pmodel)
    with pytest.raises(ValueError, match="contiguous"):
        mgr.save(state_from_numpy(_states(s0, 3)[2], "cpu"), step=2)
    assert mgr.store.stats_snapshot()["full_chunks"] == 0
    mgr.close()
    assert mgr.manifests.latest_step() == 1


def _flip_first_record_byte(root, digest):
    path = root / "objects" / digest[:2] / f"{digest}.chunk"
    env = workers.parse_envelope(path.read_bytes(), digest)
    meta, items = workers.decode_chunk_items(env["payload"])
    name, shape, dtype, raw = items[0]
    data = bytearray(raw)
    data[0] ^= 0x01
    items[0] = (name, shape, dtype, memoryview(data))
    env["payload"] = workers.encode_chunk_blob(items, meta)
    path.write_bytes(b"".join(bytes(p) for p in _msgpack.pack_parts(env)))


def test_an_fp_event_after_a_canonical_full_entry_writes_full(tmp_path,
                                                              sides):
    """The fingerprint path finds no table behind a canonical entry whose
    own object is full: it writes full (``_delta_base`` gives no base), as
    the JAX saver does."""
    jmodel, pmodel, s0 = sides
    s1 = _states(s0, 3)[2]
    for pkg in ("jax", "port"):
        make = _jax_mgr if pkg == "jax" else _port_mgr
        model = jmodel if pkg == "jax" else pmodel
        conv = (lambda s: s) if pkg == "jax" else \
            (lambda s: state_from_numpy(s, "cpu"))
        mgr = make(tmp_path / pkg, model)
        mgr.save(conv(s0), step=1)
        mgr.close()
        mgr = make(tmp_path / pkg, model, fingerprint=True)
        mgr.save(conv(s1), step=2)
        assert mgr.last_save_stats["delta_chunks"] == 0
        assert mgr.last_save_stats["full_chunks"] == 14
        mgr.close()
    assert _tree_bytes(tmp_path / "port") == _tree_bytes(tmp_path / "jax")
    pm = _port_mgr(tmp_path / "port", pmodel, fingerprint=True)
    ref = pm.manifests.load(1).entries["embed"]["weights"]
    assert pm._delta_base("embed", "weights", ref, []) == (None, None)
    pm.close()


def test_concurrent_writers_of_one_unit_dedup(tmp_path):
    """Sixteen threads write the same content at once (a short switch
    interval): one full object, fifteen dedup hits, no race."""
    rng = np.random.RandomState(0)
    items = [("a/w", (64, 64), "float32",
              rng.randn(64, 64).astype(np.float32).tobytes()),
             ("b/s", (8,), "int32", np.arange(8, dtype=np.int32).tobytes())]
    store = ChunkStore(tmp_path)
    refs, errors = [], []
    barrier = threading.Barrier(16)

    def write():
        try:
            barrier.wait(timeout=30)
            refs.append(store.write(1, "u", "weights", items))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=write) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert store.stats["full_chunks"] == 1
    assert store.stats["dedup_hits"] == 15
    assert len({r.digest for r in refs}) == 1 and len(refs) == 16
    assert len(list(store.iter_digests())) == 1


def test_a_self_based_delta_raises_instead_of_recursing(tmp_path):
    store = ChunkStore(tmp_path)
    items = [("w", (4096,), "float32", bytes(16384))]
    ref = store.write(1, "u", "weights", items)
    path = store.object_path(ref.digest)
    path.write_bytes(msgpack.packb({"v": 1, "format": "delta",
                                    "base": ref.digest,
                                    "payload": b"XD01\x00\x80"},
                                   use_bin_type=True))
    fresh = ChunkStore(tmp_path)
    with pytest.raises(ChunkCorruption, match="cycle"):
        fresh.read_items(ref.digest)


def test_the_overlapped_saver_refuses_the_canonical_path(tmp_path, sides):
    _, pmodel, _ = sides
    pm = _port_mgr(tmp_path, pmodel)
    with pytest.raises(ValueError, match="fingerprint"):
        OverlappedSaver(pm, spread_steps=2)
    pm.close()
    with pytest.raises(ValueError, match="fingerprint"):
        train(arch=ARCH, total_steps=2, batch=2, seq_len=16,
              ckpt_interval=2, ckpt_spread_steps=2, ckpt_fingerprint=False,
              ckpt_dir=str(tmp_path / "run"), device="cpu")
    with pytest.raises(ValueError, match="fingerprint"):
        jax_train(arch=ARCH, total_steps=2, batch=2, seq_len=16,
                  ckpt_interval=2, ckpt_spread_steps=2,
                  ckpt_fingerprint=False, ckpt_dir=str(tmp_path / "jrun"))


def test_no_fingerprint_needs_a_device_or_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(arch=ARCH, total_steps=2, batch=2, seq_len=16,
              ckpt_interval=2, ckpt_fingerprint=False,
              ckpt_dir=str(tmp_path / "run"))


# ---------------------------------------------------------------- serving
def test_hot_swap_across_xor_deltas_equals_a_cold_load(tmp_path, sides):
    """A server cold-loaded at step 3 swaps to 4, 5 and 7 of a canonical
    store (XOR deltas whose base it does not hold as bytes, then the
    rebase): each swap equals a cold load of that step bit for bit, and
    the JAX service on the same store."""
    jmodel, pmodel, s0 = sides
    states = _states(s0, 7)
    pm = _port_mgr(tmp_path, pmodel)
    for step, s in enumerate(states, start=1):
        pm.save(state_from_numpy(s, "cpu"), step=step)
    like = {"params": steps.state_specs(pmodel)["params"]}
    svc = WeightService(pm, like, device=CPU, step=3)
    jsvc = JaxWeightService(_jax_mgr(tmp_path, jmodel),
                            {"params": jax_steps.state_specs(jmodel)
                             ["params"]}, step=3)
    for step in (4, 5, 7):
        stats = svc.swap(pm.manifests.load(step))
        jsvc.swap(jsvc.mgr.manifests.load(step))
        assert stats["units_full"] == 1 and stats["units_scattered"] == 0
        cold = WeightService(pm, like, device=CPU, step=step)
        got = _np({"params": svc.current()})
        _assert_np_equal(got, _np({"params": cold.current()}))
        _assert_np_equal(got, {"params": jax.tree.map(np.asarray,
                                                      jsvc.current())})
    pm.close()


def test_variant_set_serves_xor_delta_objects(tmp_path, sides):
    """A ``VariantSet`` over a canonical store: a variant taking embed
    (an XOR delta) from step 5 into step 7 holds step 5's embed and step
    7's other units, bit for bit against cold loads."""
    from repro_torch.checkpoint.swap import VariantSet

    _, pmodel, s0 = sides
    pm = _port_mgr(tmp_path, pmodel)
    for step, s in enumerate(_states(s0, 7), start=1):
        pm.save(state_from_numpy(s, "cpu"), step=step)
    assert pm.manifests.load(5).entries["embed"]["weights"].stored == \
        "delta"
    like = {"params": steps.state_specs(pmodel)["params"]}
    vs = VariantSet(pm, like, device=CPU)
    vs.materialize("mix", base_step=7, select=[(["embed"], 5)])
    reg = pm.registry
    for unit, step in (("embed", 5), ("block_000", 7), ("lm_head", 7)):
        cold = WeightService(pm, like, device=CPU, step=step).current()
        _assert_np_equal(_np({"w": reg.extract_unit(vs.params("mix"),
                                                    unit)}),
                         _np({"w": reg.extract_unit(cold, unit)}))
    pm.close()


# ---------------------------------------------------------------- trainer
def test_trainer_without_fingerprints_tracks_jax(tmp_path):
    """Both trainers start from one JAX-written step-0 store, save every 2
    steps on the canonical path (parity), fail at step 5 and resume from
    the step-4 merge: resumed losses within 5e-3, and the same manifest
    shape (stored kinds and delta bases' presence) at every event."""
    kw = dict(arch=ARCH, total_steps=6, batch=2, seq_len=32,
              policy_name="parity", ckpt_interval=2, seed=0, lr=3e-3,
              codec="none", ckpt_fingerprint=False, ckpt_async=False)
    jmodel = jax_build_model(jax_get_config(ARCH, reduced=True))
    seed = _jax_mgr(tmp_path / "jax", jmodel)
    seed.save(jax.tree.map(np.asarray,
                           jax_steps.init_state(jmodel, jax.random.key(0))),
              step=0)
    seed.close()
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    with pytest.raises(JaxSimulatedFailure):
        jax_train(ckpt_dir=str(tmp_path / "jax"), resume=True, fail_at=5,
                  **kw)
    jres = jax_train(ckpt_dir=str(tmp_path / "jax"), resume=True, **kw)
    with pytest.raises(SimulatedFailure) as e:
        train(ckpt_dir=str(tmp_path / "port"), resume=True, fail_at=5,
              device="cpu", **kw)
    events = e.value.save_events
    res = train(ckpt_dir=str(tmp_path / "port"), resume=True, device="cpu",
                **kw)
    events += res["save_events"]
    assert [ev["step"] for ev in events] == [2, 4, 6]
    for ev in events:
        assert ev["dirty_block_frac"] == 1.0
        assert ev["hashed_bytes"] == ev["logical_bytes"] > ev["d2h_bytes"]
    assert res["restore_stats"]["step"] == 4
    assert res["dirty_block_frac"] == 1.0
    want = dict(jres["losses"])
    assert [s for s, _ in res["losses"]] == [4, 5]
    for step, loss in res["losses"]:
        assert abs(loss - want[step]) < 5e-3, (step, loss, want[step])
    jm = _jax_mgr(tmp_path / "jax", jmodel)
    pm = _port_mgr(tmp_path / "port", build_model(get_config(
        ARCH, reduced=True)))
    for step in (2, 4, 6):
        shape = [{u: {k: (r.stored, r.delta_base is None, r.step)
                      for k, r in kinds.items()}
                  for u, kinds in m.manifests.load(step).entries.items()}
                 for m in (jm, pm)]
        assert shape[0] == shape[1], step
    jm.close()
    pm.close()
