"""The port's streaming restore engine against the JAX package's: a plan
that reads each shared digest once (counted by a spy on the store's object
reads) and rebuilds a delta base once; pipelined (4 threads, either IO
backend), sequential and single-thread restores bitwise equal to the JAX
restore of the same store; weights-only and unit-prefix restores; fallback
provenance under 4 threads; missing objects resolved at plan time; base
cycles that raise instead of deadlocking, within one thread and across
two; and ``verify=False``, which checks no crc32 and no table.

Stores are written by the JAX package (codec none) or by the port from the
same JAX-initialized numpy state; every comparison is exact.
"""
import random
import sys
import threading
from collections import Counter

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.saver import CheckpointManager as JaxManager
from repro.configs import get_config as jax_get_config
from repro.core import LayerRegistry as JaxRegistry
from repro.core.policies import make_policy as jax_make_policy
from repro.launch import steps as jax_steps
from repro.models import build_model as jax_build_model
from repro_torch.checkpoint import _msgpack
from repro_torch.checkpoint import restore as restore_mod
from repro_torch.checkpoint.chunk_store import (OBJECT_VERSION, ChunkStore,
                                                ReadSession)
from repro_torch.checkpoint.restore import RestoreError, plan_restore
from repro_torch.checkpoint.saver import CheckpointManager
from repro_torch.checkpoint.serial import ChunkCorruption
from repro_torch.configs import get_config
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core.layer_registry import LayerRegistry
from repro_torch.core.policies import make_policy
from repro_torch.launch import steps
from repro_torch.models import build_model

torch.set_num_threads(1)

ARCH = "llama3.2-3b"
BB = 4096
CPU = torch.device("cpu")
BACKENDS = pytest.mark.parametrize("backend", [
    "thread", pytest.param("process", marks=pytest.mark.process_io)])


@pytest.fixture(scope="module")
def setup():
    jmodel = jax_build_model(jax_get_config(ARCH, reduced=True))
    s0 = jax.tree.map(np.asarray,
                      jax_steps.init_state(jmodel, jax.random.key(0)))
    pmodel = build_model(get_config(ARCH, reduced=True))
    return jmodel, pmodel, s0


def _drift(np_state, f):
    """Every float leaf scaled by ``f`` (int leaves kept)."""
    def one(x):
        x = np.asarray(x)
        if x.dtype.kind == "i":
            return x
        return (x.astype(np.float32) * f).astype(x.dtype)
    return {"step": np_state["step"],
            "params": jax.tree.map(one, np_state["params"]),
            "opt": jax.tree.map(one, np_state["opt"])}


def _poke(np_state, seed=1):
    """A few elements of block_001 changed (block and XOR deltas)."""
    rng = np.random.RandomState(seed)
    out = jax.tree.map(np.array, np_state)
    for tree in (out["params"], out["opt"]["master"], out["opt"]["m"]):
        w = tree["blocks"]["mlp"]["w_gate"]
        w[1, 0, :5] = (w[1, 0, :5].astype(np.float32)
                       + rng.rand(5).astype(np.float32)).astype(w.dtype)
    return out


def _mgr(pmodel, root, policy="full", **kw):
    return CheckpointManager(root, LayerRegistry(pmodel),
                             make_policy(policy, pmodel.layer_units()),
                             fp_block_bytes=BB, async_save=False, **kw)


def _np(state, parts=("params", "opt")):
    return state_to_numpy({p: state[p] for p in parts},
                          bf16_dtype=ml_dtypes.bfloat16)


def _assert_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def _spy_reads(store):
    """Count the object reads that reach the store, per digest."""
    counts: Counter = Counter()
    plain = store._read_blob

    def spying(digest, alloc=None):
        counts[digest] += 1
        return plain(digest, alloc)

    store._read_blob = spying
    return counts


@BACKENDS
def test_shared_digest_read_exactly_once(tmp_path, setup, backend):
    """block_002 holds block_001's content: their objects dedup to shared
    digests, each read once, released after its last dependent."""
    _, pmodel, s0 = setup
    st = jax.tree.map(np.array, s0)
    for tree in (st["params"], *st["opt"].values()):
        for leaf in jax.tree.leaves(tree["blocks"]):
            leaf[2] = leaf[1]
    mgr = _mgr(pmodel, tmp_path, io_backend=backend, io_workers=2)
    mgr.save(state_from_numpy(st, "cpu"), step=10)
    plan = plan_restore(mgr.manifests, mgr.store,
                        mgr.registry.unit_names())
    assert plan.unique_digests < len(plan.targets)
    assert plan.planned_object_reads == len(plan.targets)
    counts = _spy_reads(mgr.store)
    got = mgr.restore(steps.state_specs(pmodel), device=CPU)
    _assert_equal(_np(got), {"params": st["params"], "opt": st["opt"]})
    assert counts and max(counts.values()) == 1, counts
    assert set(counts) == set(plan.dependents)
    s = mgr.last_restore_stats
    assert s["objects_read"] == plan.unique_digests == len(counts)
    assert s["objects_read"] < s["planned_object_reads"]
    assert s["pipelined"] and s["io_threads"] == 4
    assert s["io_backend"] == backend and s["verify"]
    mgr.close()


@BACKENDS
@pytest.mark.parametrize("fingerprint", [True, False],
                         ids=["bd02", "xd01"])
def test_delta_base_rebuilt_once(tmp_path, setup, backend, fingerprint):
    """Deltas over full bases (block deltas on the fingerprint path, XOR
    deltas on the canonical one): each base is read once however many
    deltas patch it."""
    _, pmodel, s0 = setup
    s1 = _poke(s0)
    mgr = _mgr(pmodel, tmp_path, fingerprint=fingerprint,
               io_backend=backend, io_workers=2)
    mgr.save(state_from_numpy(s0, "cpu"), step=10)
    mgr.save(state_from_numpy(s1, "cpu"), step=20)
    mgr.close()
    # a fresh manager: the saver's canonical-payload cache holds no base
    mgr = _mgr(pmodel, tmp_path, io_backend=backend, io_workers=2)
    m = mgr.manifests.load(20)
    bases = {r.delta_base for kinds in m.entries.values()
             for r in kinds.values() if r.delta_base}
    assert bases, "the chain holds no delta"
    counts = _spy_reads(mgr.store)
    got = mgr.restore(steps.state_specs(pmodel), device=CPU)
    _assert_equal(_np(got), {"params": s1["params"], "opt": s1["opt"]})
    assert max(counts.values()) == 1, counts
    assert bases <= set(counts)
    s = mgr.last_restore_stats
    assert s["objects_read"] == s["unique_digests"] == len(counts)
    assert s["objects_read"] <= s["planned_object_reads"]
    mgr.close()


@BACKENDS
def test_pipelined_equals_sequential_equals_jax(tmp_path, setup, backend):
    """A chain of three policies over a drifting state, saved by the JAX
    package: the port's pipelined restore (4 threads), its sequential one
    and one with a single reader thread equal the JAX restore bit for
    bit."""
    jmodel, pmodel, s0 = setup
    units = jmodel.layer_units()
    jm = JaxManager(tmp_path, JaxRegistry(jmodel),
                    jax_make_policy("full", units), codec="none",
                    async_save=False, fp_block_bytes=BB)
    st = s0
    for step, policy in ((10, "full"), (20, "parity"), (30, "filtered")):
        jm.policy = jax_make_policy(policy, units)
        jm.save(st, step=step)
        st = _poke(_drift(st, 1.1), seed=step)
    want = jax.tree.map(np.asarray, jm.restore(jax_steps.state_specs(jmodel)))
    jm.close()
    want = {"params": want["params"], "opt": want["opt"]}
    like = steps.state_specs(pmodel)
    mgr = _mgr(pmodel, tmp_path, io_backend=backend, io_workers=2)
    pipe = mgr.restore(like, device=CPU)
    assert mgr.last_restore_stats["pipelined"]
    seq = mgr.restore(like, device=CPU, pipelined=False)
    assert not mgr.last_restore_stats["pipelined"]
    assert mgr.last_restore_stats["io_threads"] == 1
    mgr.close()
    one = _mgr(pmodel, tmp_path, io_backend=backend, io_workers=2,
               restore_threads=1)
    single = one.restore(like, device=CPU)
    assert not one.last_restore_stats["pipelined"]
    one.close()
    for got in (pipe, seq, single):
        assert int(got["step"]) == 30
        _assert_equal(_np(got), want)


def test_params_only_restore_reads_fewer_bytes(tmp_path, setup):
    _, pmodel, s0 = setup
    mgr = _mgr(pmodel, tmp_path, policy="parity")
    mgr.save(state_from_numpy(s0, "cpu"), step=10)
    mgr.save(state_from_numpy(_drift(s0, 1.1), "cpu"), step=20)
    like = steps.state_specs(pmodel)
    full = mgr.restore(like, device=CPU)
    full_stats = dict(mgr.last_restore_stats)
    part = mgr.restore(like, device=CPU, parts=("params",))
    part_stats = dict(mgr.last_restore_stats)
    assert "opt" not in part
    _assert_equal(_np(full, ("params",)), _np(part, ("params",)))
    assert part_stats["bytes_read"] < full_stats["bytes_read"]
    assert part_stats["targets"] == full_stats["targets"] // 2
    assert part_stats["parts"] == ["params"]
    mgr.close()


def test_unit_prefix_filter(tmp_path, setup):
    _, pmodel, s0 = setup
    mgr = _mgr(pmodel, tmp_path)
    mgr.save(state_from_numpy(s0, "cpu"), step=10)
    like = steps.state_specs(pmodel)
    reg = mgr.registry
    got = mgr.restore(like, device=CPU, parts=("params",), units=("embed",))
    want = state_from_numpy(s0, "cpu")
    for x, y in zip(jax.tree.leaves(reg.extract_unit(got["params"],
                                                     "embed")),
                    jax.tree.leaves(reg.extract_unit(want["params"],
                                                     "embed"))):
        assert torch.equal(x, y)
    # units the filter leaves out restore as zeros
    blk = reg.extract_unit(got["params"], "block_001")
    assert all(not t.any() for t in jax.tree.leaves(blk))
    s = mgr.last_restore_stats
    assert s["units"] == 1 and s["targets"] == 1
    got = mgr.restore(like, device=CPU, units="block_00")
    assert mgr.last_restore_stats["units"] == 4
    assert mgr.last_restore_stats["targets"] == 8
    with pytest.raises(RestoreError, match="matches no units"):
        mgr.restore(like, device=CPU, units=("nope_",))
    mgr.close()


def _flip_payload(mgr, digest):
    """Flip one byte of the object's first tensor record's data (its crc32
    left stale)."""
    path = mgr.store.object_path(digest)
    raw = bytearray(path.read_bytes())
    env = _msgpack.unpackb(bytes(raw))
    data = _msgpack.unpackb(env["payload"])["tensors"][0]["data"]
    at = raw.find(data) + len(data) // 2
    raw[at] ^= 0xFF
    path.write_bytes(bytes(raw))


@BACKENDS
def test_fallback_provenance_under_threads(tmp_path, setup, backend):
    """A corrupt object under 4 reader threads: its unit falls back to the
    older manifest's object, named in ``fallback_units``; every other unit
    comes from the newest step."""
    _, pmodel, s0 = setup
    s2 = _drift(s0, 2.0)
    mgr = _mgr(pmodel, tmp_path, io_backend=backend, io_workers=2)
    mgr.save(state_from_numpy(s0, "cpu"), step=10)
    mgr.save(state_from_numpy(s2, "cpu"), step=20)
    _flip_payload(mgr, mgr.manifests.load(20).entries["block_000"]
                  ["weights"].digest)
    got = mgr.restore(steps.state_specs(pmodel), device=CPU)
    assert mgr.last_restore_stats["fallback_units"] == {
        "block_000/weights": 10}
    assert mgr.last_restore_stats["io_threads"] == 4
    reg = mgr.registry
    want0 = state_from_numpy(s0, "cpu")
    want2 = state_from_numpy(s2, "cpu")
    for name in reg.unit_names():
        src = want0 if name == "block_000" else want2
        for a, b in zip(jax.tree.leaves(reg.extract_unit(got["params"],
                                                         name)),
                        jax.tree.leaves(reg.extract_unit(src["params"],
                                                         name))):
            assert torch.equal(a, b), name
    mgr.close()


def test_missing_object_resolved_at_plan_time(tmp_path, setup):
    _, pmodel, s0 = setup
    mgr = _mgr(pmodel, tmp_path)
    mgr.save(state_from_numpy(s0, "cpu"), step=10)
    mgr.save(state_from_numpy(_drift(s0, 2.0), "cpu"), step=20)
    m2 = mgr.manifests.load(20)
    mgr.store.object_path(m2.entries["block_000"]["weights"].digest).unlink()
    plan = plan_restore(mgr.manifests, mgr.store, mgr.registry.unit_names())
    t = next(x for x in plan.targets
             if x.unit == "block_000" and x.kind == "weights")
    assert t.primary.manifest_step == 10     # promoted up front
    counts = _spy_reads(mgr.store)
    got = mgr.restore(steps.state_specs(pmodel), device=CPU)
    assert mgr.last_restore_stats["fallback_units"] == {
        "block_000/weights": 10}
    assert m2.entries["block_000"]["weights"].digest not in counts
    reg = mgr.registry
    want = state_from_numpy(s0, "cpu")
    for a, b in zip(jax.tree.leaves(reg.extract_unit(got["params"],
                                                     "block_000")),
                    jax.tree.leaves(reg.extract_unit(want["params"],
                                                     "block_000"))):
        assert torch.equal(a, b)
    for m in (mgr.manifests.load(10), m2):
        for kind in ("weights", "opt"):
            p = mgr.store.object_path(m.entries["block_000"][kind].digest)
            if p.is_file():
                p.unlink()
    with pytest.raises(RestoreError):
        plan_restore(mgr.manifests, mgr.store, mgr.registry.unit_names())
    mgr.close()


def _evil_delta(store, digest, base):
    """Overwrite ``digest``'s object with an XOR delta over ``base``."""
    blob = _msgpack.packb({"v": OBJECT_VERSION, "format": "delta",
                           "base": base, "payload": b"XD01\x00junk"})
    store.object_path(digest).write_bytes(blob)


def _cycles(tmp_path, pool):
    store = ChunkStore(tmp_path / "s", dispatch=pool.dispatch)
    a = store.write(1, "u", "weights", [
        ("w", (64, 64), "float32", np.ones((64, 64), np.float32).tobytes())
    ]).digest
    b = store.write(1, "v", "weights", [
        ("w", (64, 64), "float32", np.zeros((64, 64), np.float32).tobytes())
    ]).digest

    def read(session, digest):
        if pool.dispatch.is_process:
            return session.read_offload(digest)
        return session.read(digest)

    # a fresh store each time: the writer's canonical-payload cache holds
    # the good bytes of both digests
    _evil_delta(store, a, a)
    with pytest.raises(ChunkCorruption, match="cycle"):
        read(ReadSession(ChunkStore(store.root, dispatch=pool.dispatch)), a)
    _evil_delta(store, a, b)
    _evil_delta(store, b, a)
    store = ChunkStore(store.root, dispatch=pool.dispatch)
    session = ReadSession(store)
    barrier = threading.Barrier(2, timeout=10)
    plain = store._read_blob

    def slow(digest, alloc=None):
        blob = plain(digest, alloc)
        try:
            barrier.wait()      # both threads hold their first read
        except threading.BrokenBarrierError:
            pass
        return blob

    store._read_blob = slow
    errors = {}

    def reader(digest):
        try:
            read(session, digest)
        except BaseException as e:  # noqa: BLE001
            errors[digest] = e

    threads = [threading.Thread(target=reader, args=(d,)) for d in (a, b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads), "readers deadlocked"
    assert set(errors) == {a, b}
    assert all(isinstance(e, ChunkCorruption) for e in errors.values())
    assert all("cycle" in str(e) for e in errors.values()), errors


@BACKENDS
def test_cyclic_base_raises_not_deadlocks(tmp_path, setup, backend):
    """A delta whose base chain loops back raises ``ChunkCorruption``:
    alone (its own base), and two objects based on each other read by two
    threads at once (each waits on the other's read: the memo refuses the
    wait); then a restore over such a cycle falls back."""
    from repro_torch.checkpoint.async_io import TransferPool

    pool = TransferPool(1, worker_backend=backend, io_workers=1)
    try:
        _cycles(tmp_path, pool)
    finally:
        pool.close()

    # end to end: the restore falls back past the cycle

    _, pmodel, s0 = setup
    mgr = _mgr(pmodel, tmp_path / "ckpt", io_backend=backend, io_workers=2)
    mgr.save(state_from_numpy(s0, "cpu"), step=10)
    mgr.save(state_from_numpy(_drift(s0, 2.0), "cpu"), step=20)
    vref = mgr.manifests.load(20).entries["block_000"]["weights"]
    _evil_delta(mgr.store, vref.digest, vref.digest)
    got = mgr.restore(steps.state_specs(pmodel), device=CPU)
    assert mgr.last_restore_stats["fallback_units"] == {
        "block_000/weights": 10}
    reg = mgr.registry
    want = state_from_numpy(s0, "cpu")
    for x, y in zip(jax.tree.leaves(reg.extract_unit(got["params"],
                                                     "block_000")),
                    jax.tree.leaves(reg.extract_unit(want["params"],
                                                     "block_000"))):
        assert torch.equal(x, y)
    mgr.close()


@BACKENDS
def test_verify_false_skips_crc_and_table_check(tmp_path, setup, backend,
                                                monkeypatch):
    """A flipped payload byte under its stale crc32: the verifying restore
    falls back (the crc32 catches it, so no table is held against it);
    ``restore_verify=False`` checks no crc32 and no table on the device
    (``verify_placed`` never called) and restores the flipped bytes."""
    _, pmodel, s0 = setup
    s2 = _drift(s0, 2.0)
    mgr = _mgr(pmodel, tmp_path, io_backend=backend, io_workers=2)
    mgr.save(state_from_numpy(s0, "cpu"), step=10)
    mgr.save(state_from_numpy(s2, "cpu"), step=20)
    mgr.close()
    digest = mgr.manifests.load(20).entries["block_000"]["weights"].digest
    _flip_payload(mgr, digest)
    calls = Counter()
    plain = restore_mod.verify_placed

    def counting(tree, fp_blob, d):
        calls[d] += 1
        return plain(tree, fp_blob, d)

    monkeypatch.setattr(restore_mod, "verify_placed", counting)
    like = steps.state_specs(pmodel)
    checked = _mgr(pmodel, tmp_path, io_backend=backend, io_workers=2)
    got = checked.restore(like, device=CPU)
    assert checked.last_restore_stats["fallback_units"] == {
        "block_000/weights": 10}
    assert checked.last_restore_stats["verify"]
    n_fp = checked.last_restore_stats["targets"]
    assert sum(calls.values()) == n_fp and digest not in calls
    checked.close()
    calls.clear()
    trusting = _mgr(pmodel, tmp_path, io_backend=backend, io_workers=2,
                    restore_verify=False)
    got = trusting.restore(like, device=CPU)
    s = trusting.last_restore_stats
    assert not s["verify"] and not s["fallback_units"]
    assert not calls
    reg = trusting.registry
    want = state_from_numpy(s2, "cpu")
    differ = [not torch.equal(x, y) for x, y in zip(
        jax.tree.leaves(reg.extract_unit(got["params"], "block_000")),
        jax.tree.leaves(reg.extract_unit(want["params"], "block_000")))]
    assert sum(differ) == 1         # the flipped byte's leaf
    for name in reg.unit_names()[2:]:
        for x, y in zip(jax.tree.leaves(reg.extract_unit(got["params"],
                                                         name)),
                        jax.tree.leaves(reg.extract_unit(want["params"],
                                                         name))):
            assert torch.equal(x, y)
    trusting.close()


@BACKENDS
def test_session_stress_each_digest_read_once(tmp_path, backend):
    """Sixteen threads read 24 objects (8 full, 16 XOR deltas over them)
    in their own random orders through one session, with a 1 us switch
    interval: each object comes off the store once, and every thread
    sees the same bytes for it."""
    from repro_torch.checkpoint.async_io import TransferPool

    rs = np.random.RandomState(0)
    store = ChunkStore(tmp_path)
    digests = []
    for u in range(8):
        w = rs.rand(64, 64).astype(np.float32)
        ref = store.write(1, f"u{u}", "weights",
                          [("w", (64, 64), "float32", w.tobytes())])
        digests.append(ref.digest)
        for k in range(2):
            w = w.copy()
            w[k, :3] += 1
            d = store.write(2 + k, f"u{u}", "weights",
                            [("w", (64, 64), "float32", w.tobytes())],
                            prev_ref=ref)
            assert d.stored == "delta"
            digests.append(d.digest)
    pool = TransferPool(2, worker_backend=backend, io_workers=2)
    fresh = ChunkStore(tmp_path, dispatch=pool.dispatch)
    counts = _spy_reads(fresh)
    session = ReadSession(fresh)
    seen, errors = [], []

    def reader(seed):
        order = list(digests)
        random.Random(seed).shuffle(order)
        got = {}
        try:
            for d in order:
                tree, _ = (session.read_offload(d)
                           if backend == "process" else session.read(d))
                got[d] = tree["w"].numpy().tobytes()
        except BaseException as e:  # noqa: BLE001
            errors.append(e)
        seen.append(got)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=reader, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
        pool.close()
    assert not any(t.is_alive() for t in threads), "readers hung"
    assert not errors, errors
    assert len(seen) == 16 and all(g == seen[0] for g in seen)
    assert set(counts) == set(digests) and set(counts.values()) == {1}
    assert session.stats["object_reads"] == len(digests)
