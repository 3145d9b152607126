"""The port's storage tiers under its ChunkStore (the cases of
``tests/test_backends.py``): the memory tier, the tiered hot/durable
composition (spill, promotion, eviction, spill debt, GC and tmp sweeps of
both tiers, concurrent writers), the transfer pool's lanes, the fault
injector, the store's read retries, and the manager and merge over mixed
backends.  Plus the RAM tier's copy on write: a buffer the saver reuses
after ``write`` must not change a stored object.

No test sleeps more than ~50 ms; every pool and store a test opens is
closed in a ``finally``.
"""
import os
import stat
import threading

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import faults
from repro_torch.checkpoint.async_io import (AsyncWriteError, AsyncWriter,
                                             TransferPool)
from repro_torch.checkpoint.backends import (FaultInjectingBackend,
                                             LocalFSBackend, MemoryBackend,
                                             RetryPolicy, TieredBackend)
from repro_torch.checkpoint.backends.localfs import atomic_write
from repro_torch.checkpoint.chunk_store import ChunkStore
from repro_torch.checkpoint.faults import InjectedCrash
from repro_torch.checkpoint.saver import CheckpointManager
from repro_torch.checkpoint.serial import ChunkCorruption, flatten_with_paths
from repro_torch.configs import get_config
from repro_torch.core.layer_registry import LayerRegistry
from repro_torch.core.manifest import ManifestStore
from repro_torch.core.policies import make_policy
from repro_torch.core.recipe import CheckpointRef, Recipe, SelectRule
from repro_torch.core.tailor import merge
from repro_torch.launch import steps
from repro_torch.models import build_model
from repro_torch.optim.groups import tree_map

torch.set_num_threads(1)

CPU = torch.device("cpu")
FAST_RETRY = RetryPolicy(attempts=3, base_delay=0.001, max_delay=0.002)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.disarm()
    yield
    faults.disarm()


def _w(seed: int, n: int = 512) -> np.ndarray:
    return np.random.RandomState(seed).standard_normal(n).astype(np.float32)


def _items(seed: int, n: int = 512):
    a = _w(seed, n)
    return [("w", (n,), "float32", memoryview(a.tobytes()))]


def _write(store, step, unit, seed, n=512):
    return store.write(step, unit, "weights", _items(seed, n))


def _read_w(store, digest) -> np.ndarray:
    items, _ = store.read_items(digest)
    (name, shape, dtype, raw), = items
    return np.frombuffer(bytes(raw), np.float32).reshape(shape)


# ---------------------------------------------------------- memory backend
def test_memory_backend_roundtrip_dedup_gc(tmp_path):
    store = ChunkStore(tmp_path, backend="memory")
    try:
        r1 = _write(store, 1, "u", 0)
        r2 = _write(store, 2, "u", 0)
        assert r1.digest == r2.digest
        assert store.stats["dedup_hits"] == 1
        assert not (tmp_path / "objects").exists()  # nothing on disk
        np.testing.assert_array_equal(_read_w(store, r1.digest), _w(0))
        assert store.locate(r1.digest) == "memory"
        assert store.durability()["durable_on"] == "none"
        assert store.gc_objects() == r1.nbytes
        assert not store.has(r1.digest)
        assert store.backend.total_bytes() == 0
        with pytest.raises(NotImplementedError, match="no filesystem"):
            store.object_path(r1.digest)
    finally:
        store.close()


def test_memory_backend_missing_object_raises_file_not_found():
    be = MemoryBackend()
    with pytest.raises(FileNotFoundError):
        be.read_into("deadbeef", bytearray)
    with pytest.raises(FileNotFoundError):
        be.size("deadbeef")


@pytest.mark.parametrize("spec", ["memory", "tiered", "remote3"])
def test_ram_tier_copies_what_it_is_given(tmp_path, spec):
    """A RAM tier keeps a private copy: the saver rewrites its staging
    buffers for the next event, and a kept view would let that rewrite a
    committed object (on every tier that holds it)."""
    store = ChunkStore(tmp_path, backend=spec)
    try:
        staging = bytearray(_w(3).tobytes())
        view = memoryview(staging)
        ref = store.write(1, "u", "weights",
                          [("w", (512,), "float32", view)])
        staging[:] = bytes(len(staging))          # the next event's bytes
        store.drain_spill()
        np.testing.assert_array_equal(_read_w(store, ref.digest), _w(3))
        copies = {label: bytes(tier.read_into(ref.digest, bytearray))
                  for label, tier in store.backend.tier_backends().items()
                  if tier.has(ref.digest)}
        assert len(set(copies.values())) == 1, sorted(copies)
        # a pinned-style buffer written as several parts
        parts = [memoryview(bytearray(b"ab" * 10)),
                 memoryview(bytearray(b"cd" * 5))]
        store.backend.write("ee" + "0" * 38, parts)
        for p in parts:
            p[:] = b"z" * p.nbytes
        assert bytes(store.backend.read("ee" + "0" * 38)) \
            == b"ab" * 10 + b"cd" * 5
    finally:
        store.close()


# ---------------------------------------------------------- tiered backend
def test_tiered_write_lands_hot_then_spills_durable(tmp_path):
    store = ChunkStore(tmp_path, backend="tiered")
    try:
        ref = _write(store, 1, "u", 1)
        assert store.backend.hot.has(ref.digest)
        store.drain_spill()
        assert store.backend.durable.has(ref.digest)
        assert store.locate(ref.digest) == "hot"  # the fastest holder
        np.testing.assert_array_equal(_read_w(store, ref.digest), _w(1))
        assert store.tier_stats()["hot_reads"] >= 1
        assert store.durability()["durable_on"] == "durable"
        assert (tmp_path / "objects").is_dir()  # the classic layout
        assert store.object_path(ref.digest) == (
            tmp_path / "objects" / ref.digest[:2] / f"{ref.digest}.chunk")
    finally:
        store.close()


def test_tiered_read_promotes_from_durable(tmp_path):
    store = ChunkStore(tmp_path, backend="tiered")
    try:
        ref = _write(store, 1, "u", 2)
        store.drain_spill()
    finally:
        store.close()
    store2 = ChunkStore(tmp_path, backend="tiered")  # a restart
    try:
        assert store2.locate(ref.digest) == "durable"
        np.testing.assert_array_equal(_read_w(store2, ref.digest), _w(2))
        assert store2.locate(ref.digest) == "hot"
        assert store2.tier_stats()["promotions"] == 1
    finally:
        store2.close()


def test_tiered_hot_budget_evicts_only_spilled_lru(tmp_path):
    store = ChunkStore(tmp_path, backend="tiered", hot_budget_bytes=1)
    try:
        refs = [_write(store, i, f"u{i}", 10 + i) for i in range(4)]
        store.drain_spill()
        assert store.backend.hot.total_bytes() == 0
        assert store.tier_stats()["evictions"] >= 4
        for i, r in enumerate(refs):
            np.testing.assert_array_equal(_read_w(store, r.digest),
                                          _w(10 + i))
    finally:
        store.close()


def test_tiered_unspilled_objects_never_evicted(tmp_path):
    class RefusingBackend(LocalFSBackend):
        def write(self, key, data):
            raise RuntimeError("durable tier down")

    backend = TieredBackend(MemoryBackend(),
                            RefusingBackend(tmp_path / "objects"),
                            hot_budget_bytes=1)
    store = ChunkStore(tmp_path, backend=backend)
    try:
        ref = _write(store, 1, "u", 3)
        with pytest.raises(AsyncWriteError):
            store.drain_spill()
        assert backend.hot.has(ref.digest)  # never dropped
        assert backend.tier_stats()["evictions"] == 0
        np.testing.assert_array_equal(_read_w(store, ref.digest), _w(3))
    finally:
        with pytest.raises(AsyncWriteError):
            store.close()  # the debt is still owed: close says so


def test_failed_spill_keeps_durability_debt_and_retries(tmp_path):
    class FlakyBackend(LocalFSBackend):
        fail = True

        def write(self, key, data):
            if FlakyBackend.fail:
                raise RuntimeError("transient durable outage")
            return super().write(key, data)

    backend = TieredBackend(MemoryBackend(),
                            FlakyBackend(tmp_path / "objects"))
    store = ChunkStore(tmp_path, backend=backend)
    try:
        ref = _write(store, 1, "u", 8)
        with pytest.raises(AsyncWriteError):
            store.drain_spill()
        assert store.pending_spill() == 1
        assert store.durability()["durable_on"] == "hot"
        with pytest.raises(AsyncWriteError):   # still failing, still raises
            store.drain_spill()
        FlakyBackend.fail = False
        store.drain_spill()                    # the retry heals the debt
        assert store.pending_spill() == 0
        assert store.durability()["durable_on"] == "durable"
        assert backend.durable.has(ref.digest)
    finally:
        FlakyBackend.fail = False
        store.close()


def test_promote_on_read_disabled_leaves_hot_cold(tmp_path):
    store = ChunkStore(tmp_path, backend="tiered")
    try:
        ref = _write(store, 1, "u", 9)
        store.drain_spill()
    finally:
        store.close()
    backend = TieredBackend(MemoryBackend(),
                            LocalFSBackend(tmp_path / "objects"),
                            promote_on_read=False)
    store2 = ChunkStore(tmp_path, backend=backend)
    try:
        np.testing.assert_array_equal(_read_w(store2, ref.digest), _w(9))
        assert store2.locate(ref.digest) == "durable"
        assert backend.hot.total_bytes() == 0
        assert backend.tier_stats()["promotions"] == 0
    finally:
        store2.close()


def test_tiered_gc_deletes_from_both_tiers(tmp_path):
    store = ChunkStore(tmp_path, backend="tiered")
    try:
        keep = _write(store, 1, "a", 4)
        drop = _write(store, 1, "b", 5)
        store.drain_spill()
        store.incref([keep.digest])
        assert store.gc_objects() == drop.nbytes  # counted once
        assert not store.backend.hot.has(drop.digest)
        assert not store.backend.durable.has(drop.digest)
        assert store.backend.hot.has(keep.digest)
        assert store.backend.durable.has(keep.digest)
    finally:
        store.close()


def test_tiered_tmp_sweep_per_tier_leaves_durable_alone(tmp_path):
    backend = TieredBackend(LocalFSBackend(tmp_path / "hot"),
                            LocalFSBackend(tmp_path / "objects"))
    store = ChunkStore(tmp_path, backend=backend)
    try:
        ref = _write(store, 1, "u", 6)
        store.drain_spill()
        store.incref([ref.digest])
        hot_tmp = tmp_path / "hot" / ref.digest[:2] / "x.chunk.tmp-dead-1"
        dur_tmp = tmp_path / "objects" / ref.digest[:2] / "y.chunk.tmp-dead-2"
        hot_tmp.write_bytes(b"h" * 70)
        dur_tmp.write_bytes(b"d" * 30)
        assert store.gc_objects() == 100
        assert not hot_tmp.exists() and not dur_tmp.exists()
        assert backend.hot.has(ref.digest) and backend.durable.has(ref.digest)
        np.testing.assert_array_equal(_read_w(store, ref.digest), _w(6))
    finally:
        store.close()


def test_tiered_concurrent_writers_spill_once(tmp_path):
    pool = TransferPool(4)
    try:
        backend = TieredBackend(MemoryBackend(),
                                LocalFSBackend(tmp_path / "objects"),
                                pool=pool)
        store = ChunkStore(tmp_path, backend=backend)
        w = AsyncWriter(pool)
        pends = [w.submit(_write, store, i, f"u{i}", 7, 4096)
                 for i in range(12)]
        w.drain()
        store.drain_spill()
        refs = [p.result() for p in pends]
        assert len({r.digest for r in refs}) == 1
        assert store.stats["full_chunks"] == 1
        assert store.stats["dedup_hits"] == 11
        assert backend.tier_stats()["spilled_objects"] == 1
        store.close()
    finally:
        pool.close()


# ------------------------------------------------------------ transfer pool
def test_transfer_pool_lane_isolation():
    pool = TransferPool(2)
    try:
        ok = pool.submit("write", lambda: 42)
        pool.submit("spill", lambda: 1 / 0)
        pool.drain("write")          # the error is spill's
        assert ok.result() == 42
        with pytest.raises(AsyncWriteError):
            pool.drain("spill")
        pool.drain("spill")          # consumed by the first drain
    finally:
        pool.close()


def test_shared_pool_writer_close_keeps_pool_alive():
    pool = TransferPool(2)
    try:
        w = AsyncWriter(pool)
        w.submit(lambda: None)
        w.close()                    # seals the writer lane only
        with pytest.raises(AsyncWriteError):
            w.submit(lambda: None)
        assert pool.submit("spill", lambda: 5).result(5) == 5
    finally:
        pool.close()


def test_transfer_pool_close_waits_accepted_work():
    pool = TransferPool(2)
    gate = threading.Event()
    timer = threading.Timer(0.05, gate.set)
    try:
        p = pool.submit("write", lambda: gate.wait(5) and 7)
        timer.start()
        pool.close()                 # waits for the in-flight item
        assert p.result(0) == 7
    finally:
        timer.cancel()
        gate.set()
        pool.close()


def test_spill_tasks_submitting_spills_do_not_deadlock(tmp_path):
    """remote3's pool (one thread, unbounded queue): a RAM -> disk spill
    task submits the disk -> remote spill from a pool thread."""
    pool = TransferPool(1, max_queue=0)
    try:
        inner = TieredBackend(LocalFSBackend(tmp_path / "objects"),
                              MemoryBackend(), pool=pool,
                              lane="remote_spill", hot_label="durable",
                              durable_label=None, required=False)
        outer = TieredBackend(MemoryBackend(), inner, pool=pool,
                              durable_label=None)
        for i in range(8):
            outer.write(f"{i:02x}" + "0" * 38, bytes([i]) * 64)
        outer.drain()
        assert outer.pending_spill() == 0
        assert all(inner.durable.has(f"{i:02x}" + "0" * 38)
                   for i in range(8))
        outer.close()
    finally:
        pool.close()


# ----------------------------------------------------------- manager-level
@pytest.fixture(scope="module")
def small_setup():
    model = build_model(get_config("yi-9b", reduced=True).replace(
        num_layers=2))
    state = steps.init_state(model, 0, CPU)
    return model, state, LayerRegistry(model)


def _assert_states_equal(a, b, parts=("params", "opt")):
    for part in parts:
        fa, fb = flatten_with_paths(a[part]), flatten_with_paths(b[part])
        assert [p for p, _ in fa] == [p for p, _ in fb]
        for (p, x), (_, y) in zip(fa, fb):
            assert x.dtype == y.dtype and torch.equal(x, y), (part, p)


def _bump(state, registry, unit, delta=1.0):
    """A copy of ``state`` with the first elements of ``unit``'s first
    weights leaf moved by ``delta``."""
    out = {"step": state["step"].clone(),
           "params": tree_map(torch.clone, state["params"]),
           "opt": tree_map(torch.clone, state["opt"])}
    (_, leaf), *_ = flatten_with_paths(
        registry.extract_unit(out["params"], unit))
    with torch.no_grad():
        leaf.view(-1)[:8] += delta
    return out


def _mgr(root, model, registry, **kw):
    return CheckpointManager(root, registry,
                             make_policy("full", model.layer_units()), **kw)


def test_tiered_save_restores_bit_exact_from_either_tier(tmp_path,
                                                         small_setup):
    model, state, registry = small_setup
    like = steps.state_specs(model)
    mgr = _mgr(tmp_path, model, registry, store_backend="tiered")
    try:
        manifest = mgr.save(state, step=10)
        assert manifest.meta["storage"]["backend"] == "tiered"
        assert manifest.meta["storage"]["durable_on"] in ("hot", "durable")
        got = mgr.restore(like, device=CPU)
        _assert_states_equal(state, got)
        s = mgr.last_restore_stats
        assert s["tier_reads"].get("hot", 0) > 0
        assert set(s["unit_tiers"].values()) == {"hot"}
        mgr.drain_spill()
    finally:
        mgr.close()
    mgr2 = _mgr(tmp_path, model, registry, store_backend="tiered")
    try:
        _assert_states_equal(state, mgr2.restore(like, device=CPU))
        s2 = mgr2.last_restore_stats
        assert s2["tier_reads"].get("durable", 0) > 0
        assert set(s2["unit_tiers"].values()) == {"durable"}
        _assert_states_equal(state, mgr2.restore(like, device=CPU))
        assert set(mgr2.last_restore_stats["unit_tiers"].values()) == {"hot"}
    finally:
        mgr2.close()


def test_tiered_spill_barrier_commits_durable(tmp_path, small_setup):
    model, state, registry = small_setup
    mgr = _mgr(tmp_path, model, registry, store_backend="tiered",
               spill_barrier=True)
    try:
        manifest = mgr.save(state, step=10)
        assert manifest.meta["storage"]["durable_on"] == "durable"
        assert mgr.last_save_stats["spill_pending"] == 0
        for d in manifest.referenced_digests():
            assert mgr.store.backend.durable.has(d)
    finally:
        mgr.close()


def test_durability_barrier_of_one_event(tmp_path, small_setup):
    """``save(durability_barrier=True)`` drains before its commit even
    where ``spill_barrier`` is off; a slow durable tier shows the
    difference in the next event's record."""
    model, state, registry = small_setup
    gate = threading.Event()

    class GatedBackend(LocalFSBackend):
        def write(self, key, data):
            gate.wait(5)
            return super().write(key, data)

    pool = TransferPool(3, max_queue=0)
    backend = TieredBackend(MemoryBackend(),
                            GatedBackend(tmp_path / "objects"), pool=pool)
    mgr = _mgr(tmp_path, model, registry, async_save=False,
               store_backend=backend)
    try:
        m1 = mgr.save(state, step=10)
        assert m1.meta["storage"]["durable_on"] == "hot"
        assert m1.meta["storage"]["pending_spill"] > 0
        gate.set()
        m2 = mgr.save(state, step=12, durability_barrier=True)
        assert m2.meta["storage"]["durable_on"] == "durable"
        assert m2.meta["storage"]["pending_spill"] == 0
    finally:
        gate.set()
        mgr.close()
        pool.close()


def test_memory_manager_roundtrip_records_volatile(tmp_path, small_setup):
    model, state, registry = small_setup
    mgr = _mgr(tmp_path, model, registry, async_save=False,
               store_backend="memory")
    try:
        manifest = mgr.save(state, step=10)
        assert manifest.meta["storage"]["durable_on"] == "none"
        _assert_states_equal(state, mgr.restore(steps.state_specs(model),
                                                device=CPU))
        assert not (tmp_path / "objects").exists()
    finally:
        mgr.close()


def test_merge_across_heterogeneous_backends(tmp_path, small_setup):
    """A RAM-tier source merged with a local one; the output restores bit
    for bit from its durable objects."""
    model, state, registry = small_setup
    mgr_a = _mgr(tmp_path / "a", model, registry, async_save=False,
                 store_backend="memory")
    mgr_b = _mgr(tmp_path / "b", model, registry, async_save=False)
    mgr_out = None
    try:
        mgr_a.save(state, step=100)
        state_b = _bump(state, registry, "block_001")
        mgr_b.save(state_b, step=100)
        recipe = Recipe(
            base=CheckpointRef(tmp_path / "b", 100),
            output=tmp_path / "merged",
            select=[SelectRule(units=["embed", "block_000"],
                               source=CheckpointRef(tmp_path / "a", 100))])
        stats = merge(recipe, workers=2, device="cpu",
                      stores={str(CheckpointRef(tmp_path / "a", 100)):
                              mgr_a.store})
        assert stats["units"] > 0
        out_meta = ManifestStore(tmp_path / "merged").load(100).meta
        assert out_meta["storage"]["backend"] == "local"
        assert out_meta["storage"]["durable_on"] == "durable"
        mgr_out = _mgr(tmp_path / "merged", model, registry,
                       async_save=False)
        got = mgr_out.restore(steps.state_specs(model), device=CPU)
        for unit, src in (("block_001", state_b), ("block_000", state),
                          ("embed", state)):
            _assert_states_equal(
                {"params": registry.extract_unit(src["params"], unit)},
                {"params": registry.extract_unit(got["params"], unit)},
                parts=("params",))
    finally:
        for m in (mgr_a, mgr_b, mgr_out):
            if m is not None:
                m.close()


def test_merge_into_a_tiered_output_store(tmp_path, small_setup):
    model, state, registry = small_setup
    mgr = _mgr(tmp_path / "src", model, registry, async_save=False)
    out = ChunkStore(tmp_path / "out", backend="tiered")
    try:
        mgr.save(state, step=4)
        merge(Recipe(base=CheckpointRef(tmp_path / "src", 4),
                     output=tmp_path / "out", select=[]),
              workers=2, device="cpu", out_store=out)
        meta = ManifestStore(tmp_path / "out").load(4).meta
        assert meta["storage"]["backend"] == "tiered"
        assert meta["storage"]["durable_on"] == "durable"  # drained first
        src = {p.name: p.read_bytes()
               for p in (tmp_path / "src" / "objects").glob("*/*.chunk")}
        dst = {p.name: p.read_bytes()
               for p in (tmp_path / "out" / "objects").glob("*/*.chunk")}
        assert src == dst
    finally:
        out.close()
        mgr.close()


# --------------------------------------------------------- fault injection
def test_faulty_crash_on_nth_write_preserves_prior_objects(tmp_path):
    fb = FaultInjectingBackend(LocalFSBackend(tmp_path / "objects"),
                               crash_on_write=2)
    store = ChunkStore(tmp_path, backend=fb)
    r1 = _write(store, 1, "u0", 1)
    with pytest.raises(InjectedCrash):
        _write(store, 1, "u1", 2)
    assert fb.faults == 1
    np.testing.assert_array_equal(_read_w(store, r1.digest), _w(1))
    assert sum(1 for _ in fb.keys()) == 1  # no torn object left


def test_faulty_torn_durable_write_detected_and_healed(tmp_path):
    fb = FaultInjectingBackend(LocalFSBackend(tmp_path / "objects"),
                               torn_on_write={1, 2})  # the retry tears too
    backend = TieredBackend(MemoryBackend(), fb)
    key, data = "deadbeef01", b"\xab" * 1024
    try:
        backend.write(key, data)
        with pytest.raises(AsyncWriteError):
            backend.drain()
        assert fb.has(key) and fb.size(key) == len(data) // 2
        assert backend.pending_spill() == 1
        assert backend.locate(key) == "hot"
        fb.heal()
        backend.drain()  # the retry sees the short copy and rewrites it
        assert backend.pending_spill() == 0
        assert fb.size(key) == len(data)
        assert bytes(LocalFSBackend(tmp_path / "objects").read(key)) == data
    finally:
        fb.heal()
        backend.close()


def test_faulty_durable_outage_never_drops_or_collects(tmp_path):
    fb = FaultInjectingBackend(LocalFSBackend(tmp_path / "objects"),
                               error_on_write="all")
    backend = TieredBackend(MemoryBackend(), fb, hot_budget_bytes=1)
    store = ChunkStore(tmp_path, backend=backend)
    try:
        ref = _write(store, 1, "u0", 31)
        store.incref([ref.digest])
        with pytest.raises(AsyncWriteError):
            store.drain_spill()
        assert store.pending_spill() == 1
        assert backend.locate(ref.digest) == "hot"
        assert backend.tier_stats()["evictions"] == 0
        assert store.gc_objects() == 0  # referenced and dirty
        np.testing.assert_array_equal(_read_w(store, ref.digest), _w(31))
        fb.heal()
        store.drain_spill()
        assert store.pending_spill() == 0
        assert LocalFSBackend(tmp_path / "objects").has(ref.digest)
    finally:
        fb.heal()
        store.close()


def test_faulty_spill_latency_objects_stay_hot_until_durable(tmp_path):
    """A slow durable tier (50 ms of injected latency, and a write held
    until the checks are made): the write returns at once, the object is
    hot and owed, and the drain delivers it."""
    gate = threading.Event()

    class HeldBackend(LocalFSBackend):
        def write(self, key, data):
            gate.wait(5)
            return super().write(key, data)

    fb = FaultInjectingBackend(HeldBackend(tmp_path / "objects"),
                               write_latency=0.05)
    backend = TieredBackend(MemoryBackend(), fb)
    store = ChunkStore(tmp_path, backend=backend)
    try:
        ref = _write(store, 1, "u0", 41)
        assert store.pending_spill() == 1
        assert store.durability()["durable_on"] == "hot"
        gate.set()
        store.drain_spill()
        assert store.pending_spill() == 0
        assert store.durability()["durable_on"] == "durable"
    finally:
        gate.set()
        store.close()
    store2 = ChunkStore(tmp_path)
    np.testing.assert_array_equal(_read_w(store2, ref.digest), _w(41))


def test_sweep_tmp_spares_own_process_inflight_tmp_files(tmp_path):
    be = LocalFSBackend(tmp_path / "objects")
    be.write("ab123", b"payload")
    d = tmp_path / "objects" / "ab"
    live = d / f"ab123.chunk.tmp-{os.getpid():x}-deadbeef"
    live.write_bytes(b"inflight")
    stale = d / "ab123.chunk.tmp-99999999-1"
    stale.write_bytes(b"old")
    assert be.sweep_tmp() == len(b"old")
    assert not stale.exists()
    assert live.exists(), "sweep unlinked a live in-flight write"


def test_atomic_write_fsyncs_parent_directory(tmp_path, monkeypatch):
    synced = []
    real_fsync = os.fsync

    def spy(fd):
        synced.append(stat.S_ISDIR(os.fstat(fd).st_mode))
        return real_fsync(fd)

    monkeypatch.setattr(os, "fsync", spy)
    atomic_write(tmp_path / "obj.chunk", [b"pay", b"load"], fsync=True)
    assert any(synced), "no directory fd was fsynced after os.replace"
    assert sum(1 for is_dir in synced if not is_dir) == 1
    assert (tmp_path / "obj.chunk").read_bytes() == b"payload"
    synced.clear()
    atomic_write(tmp_path / "obj2.chunk", b"payload", fsync=False)
    assert synced == []


def test_faulty_seeded_error_rate_is_deterministic():
    def schedule(seed, rate, n=200):
        be = FaultInjectingBackend(MemoryBackend(),
                                   error_rate_write=rate, seed=seed)
        hits = []
        for i in range(n):
            try:
                be.write(f"k{i}", b"x")
                hits.append(False)
            except OSError:
                hits.append(True)
        return hits

    a = schedule(7, 0.2)
    assert a == schedule(7, 0.2)
    assert a != schedule(8, 0.2)
    assert any(a) and not all(a)
    assert 0.05 < sum(a) / len(a) < 0.5
    assert not any(schedule(7, 0.0))
    be = FaultInjectingBackend(MemoryBackend(), error_rate_read=1.0, seed=3)
    be.write("k", b"x")
    with pytest.raises(OSError):
        be.read_into("k", bytearray)
    be.heal()
    assert bytes(be.read_into("k", bytearray)) == b"x"


def test_faulty_schedule_equals_the_jax_injector():
    """Same seed, same rate: the port's and the JAX package's injectors
    fault the same op indices."""
    from repro.checkpoint.backends import FaultInjectingBackend as JaxFaulty
    from repro.checkpoint.backends import MemoryBackend as JaxMemory

    def hits(be):
        out = []
        for i in range(100):
            try:
                be.write(f"k{i}", b"x")
                out.append(False)
            except OSError:
                out.append(True)
        return out

    assert hits(FaultInjectingBackend(MemoryBackend(), error_rate_write=0.3,
                                      seed=5)) \
        == hits(JaxFaulty(JaxMemory(), error_rate_write=0.3, seed=5))


def test_chunk_store_read_retries_transient_then_succeeds(tmp_path):
    faulty = FaultInjectingBackend(LocalFSBackend(tmp_path / "objects"),
                                   error_on_read={1})
    store = ChunkStore(tmp_path, backend=faulty, read_retry=FAST_RETRY)
    ref = _write(store, 1, "u", 5)
    np.testing.assert_array_equal(_read_w(store, ref.digest), _w(5))
    assert store.io_retries == 1


def test_chunk_store_read_exhausted_retries_is_corruption(tmp_path):
    faulty = FaultInjectingBackend(LocalFSBackend(tmp_path / "objects"),
                                   error_on_read="all")
    store = ChunkStore(tmp_path, backend=faulty, read_retry=FAST_RETRY)
    ref = _write(store, 1, "u", 6)
    with pytest.raises(ChunkCorruption):
        store.read_items(ref.digest)
    assert store.io_retries == 2  # attempts - 1


def test_restore_counts_retries_and_falls_back_past_a_dead_object(
        tmp_path, small_setup):
    """A flaky read is retried (``io_retries``), not a fallback; an object
    that stays unreadable is corruption, and the unit comes from the
    older manifest."""
    model, state, registry = small_setup
    like = steps.state_specs(model)
    mgr = _mgr(tmp_path, model, registry, async_save=False)
    try:
        mgr.save(state, step=2)
        state2 = _bump(state, registry, "final_norm")
        m4 = mgr.save(state2, step=4)
    finally:
        mgr.close()
    dead = m4.entries["final_norm"]["weights"].digest
    faulty = FaultInjectingBackend(LocalFSBackend(tmp_path / "objects"),
                                   error_on_read="all",
                                   match=lambda k: k == dead)
    mgr2 = _mgr(tmp_path, model, registry, async_save=False,
                store_backend=faulty)
    mgr2.store.read_retry = FAST_RETRY
    try:
        got = mgr2.restore(like, device=CPU)
        s = mgr2.last_restore_stats
        assert s["fallback_units"] == {"final_norm/weights": 2}
        assert s["io_retries"] == 2
        _assert_states_equal(
            {"params": registry.extract_unit(state["params"],
                                             "final_norm")},
            {"params": registry.extract_unit(got["params"], "final_norm")},
            parts=("params",))
        faulty.heal()
        faulty.error_on_read = {faulty.reads + 1}   # one transient
        got = mgr2.restore(like, device=CPU)
        s = mgr2.last_restore_stats
        assert s["fallback_units"] == {} and s["io_retries"] == 1
        _assert_states_equal(state2, got)
    finally:
        mgr2.close()
