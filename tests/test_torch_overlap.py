"""The port's zero-stall overlapped saver on the CPU: parity with the
synchronous save, mispredictions, crashes, in-place mutation after
``begin``, and parity with the JAX package's ``OverlappedSaver``.

Every state is JAX-initialised and crosses to the port through numpy
(``repro_torch.convert``).  Everything compared is integer or byte data
(manifest entries, digests, object bytes, restored tensors), so every
comparison is exact.
"""
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.overlap import OverlappedSaver as JaxOverlappedSaver
from repro.checkpoint.saver import CheckpointManager as JaxManager
from repro.configs import get_config as jax_get_config
from repro.core import LayerRegistry as JaxRegistry
from repro.core.policies import make_policy as jax_make_policy
from repro.launch import steps as jax_steps
from repro.models import build_model as jax_build_model
from repro_torch.checkpoint import faults
from repro_torch.checkpoint.async_io import (AsyncWriteError, AsyncWriter,
                                             StagingArena, TransferPool)
from repro_torch.checkpoint.chunk_store import ChunkStore
from repro_torch.checkpoint.faults import InjectedCrash
from repro_torch.checkpoint.overlap import DirtyPredictor, OverlappedSaver
from repro_torch.checkpoint.saver import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.convert import state_from_numpy
from repro_torch.core.layer_registry import LayerRegistry
from repro_torch.core.policies import make_policy
from repro_torch.kernels._build import CudaKernel
from repro_torch.launch import steps as steps_lib
from repro_torch.models import build_model

# The suite runs in several worker processes at once: one intra-op
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

ARCH = "llama3.2-3b"
BB = 4096
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.disarm()
    yield
    faults.disarm()


def _poke_all(state):
    def poke(x):
        x = np.array(x)
        x.flat[:1] += 1
        return x

    return {"step": np.array(state["step"]),
            "params": jax.tree.map(poke, state["params"]),
            "opt": jax.tree.map(poke, state["opt"])}


def _biggest(state):
    leaves = jax.tree.leaves(state["params"])
    return id(max(leaves, key=lambda x: np.asarray(x).size))


def _poke_one(state):
    """One element of one leaf: most units dedup, one goes delta with a
    single dirty block."""
    tid = _biggest(state)
    out = jax.tree.map(np.array, state["params"])
    for src, dst in zip(jax.tree.leaves(state["params"]),
                        jax.tree.leaves(out)):
        if id(src) == tid:
            dst.flat[-1:] += 2
    return {"step": np.array(state["step"]), "params": out,
            "opt": jax.tree.map(np.array, state["opt"])}


def _poke_blocks(state, want=4):
    """A few scattered 4 KiB blocks of the biggest leaf: sparse enough to
    stay a delta, dirty enough that a 1-block capacity guess overflows."""
    tid = _biggest(state)
    out = jax.tree.map(np.array, state["params"])
    for src, dst in zip(jax.tree.leaves(state["params"]),
                        jax.tree.leaves(out)):
        if id(src) != tid:
            continue
        epb = BB // dst.dtype.itemsize
        nb = max(1, -(-dst.nbytes // BB))
        for i in range(max(2, min(want, nb // 4))):
            dst.flat[i * epb] += 3
    return {"step": np.array(state["step"]), "params": out,
            "opt": jax.tree.map(np.array, state["opt"])}


@pytest.fixture(scope="module")
def setup():
    jmodel = jax_build_model(jax_get_config(ARCH, reduced=True))
    s1 = jax.tree.map(np.asarray,
                      jax_steps.init_state(jmodel, jax.random.key(0)))
    s2 = _poke_all(s1)        # dense drift: every leaf dirty
    s3 = _poke_one(s2)        # sparse drift: one dirty block in all
    s4 = _poke_blocks(s3)     # scattered drift: a few dirty blocks
    model = build_model(get_config(ARCH, reduced=True))
    return model, LayerRegistry(model), [s1, s1, s2, s3, s4], jmodel


#: (step, state index) of the five-event chain every parity test replays:
#: full base, clean re-save, dense drift, sparse drift, scattered drift.
EVENTS = [(10, 0), (20, 1), (30, 2), (40, 3), (50, 4)]


def _port(np_state):
    return state_from_numpy(np_state, CPU)


def _assert_states_equal(np_state, got):
    """A restored port state equals a numpy state byte for byte."""
    for part in ("params", "opt"):
        want = sorted(_flat(np_state[part]), key=lambda kv: kv[0])
        have = sorted(_flat(got[part]), key=lambda kv: kv[0])
        assert [k for k, _ in want] == [k for k, _ in have]
        for (_, w), (_, h) in zip(want, have):
            assert np.ascontiguousarray(w).tobytes() == \
                h.contiguous().view(torch.uint8).numpy().tobytes()


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _manifest_sig(mgr, step):
    m = mgr.manifests.load(step)
    assert m is not None
    return {(unit, kind): (e.digest, e.stored, e.delta_base)
            for unit, kinds in m.entries.items()
            for kind, e in kinds.items()}


def _mgr(root, model, registry, **kw):
    kw.setdefault("fp_block_bytes", BB)
    return CheckpointManager(root, registry,
                             make_policy("full", model.layer_units()), **kw)


def _run_sync(root, model, registry, states, **kw):
    mgr = _mgr(root, model, registry, **kw)
    for step, si in EVENTS:
        mgr.save(_port(states[si]), step=step)
    sigs = {s: _manifest_sig(mgr, s) for s, _ in EVENTS}
    digests = sorted(mgr.store.iter_digests())
    mgr.close()
    return sigs, digests


def _run_overlapped(root, model, registry, states, *, predictor=None,
                    spread=2, mutate=False, **kw):
    """The chain through the overlapped saver.  ``mutate``: right after
    each ``begin``, overwrite every state tensor in place, as the next
    optimizer step does."""
    mgr = _mgr(root, model, registry, **kw)
    ov = OverlappedSaver(mgr, spread_steps=spread)
    if predictor is not None:
        ov.predictor = predictor
    stats = []
    for step, si in EVENTS:
        st = _port(states[si])
        ov.begin(st, step)
        if mutate:
            with torch.no_grad():
                for part in ("params", "opt"):
                    for _, x in _flat(st[part]):
                        x.add_(1)
        ticks = 0
        while ov.tick() is None:
            ticks += 1
            assert ticks < 100
        stats.append(dict(mgr.last_save_stats))
    sigs = {s: _manifest_sig(mgr, s) for s, _ in EVENTS}
    digests = sorted(mgr.store.iter_digests())
    ov.close()
    mgr.close()
    return sigs, digests, stats


# ------------------------------------------------------------------- parity
@pytest.mark.parametrize("async_save", [True, False])
def test_overlapped_matches_sync_bit_exact(setup, tmp_path, async_save):
    """The same chain through both savers: identical manifests and object
    sets, and a bit-exact restore of the overlapped chain."""
    model, registry, states, _ = setup
    sy_sigs, sy_digests = _run_sync(tmp_path / "sync", model, registry,
                                    states)
    ov_sigs, ov_digests, stats = _run_overlapped(
        tmp_path / "ov", model, registry, states, async_save=async_save)
    assert sy_sigs == ov_sigs
    assert sy_digests == ov_digests
    for s in stats:
        assert s["save_mode"] == "overlapped"
        assert s["spread_steps"] == 2
        assert s["stall_seconds"] >= s["snapshot_seconds"] > 0
    # the clean re-save dedups without staging a byte
    assert stats[1]["d2h_bytes"] == stats[1]["staged_bytes"] == 0
    # the sparse drift moves about one block, not the model
    assert 0 < stats[3]["d2h_bytes"] <= 4 * BB
    assert 0 < stats[3]["dirty_block_frac"] < 0.05

    mgr = _mgr(tmp_path / "ov", model, registry, async_save=False)
    got = mgr.restore(steps_lib.state_specs(model), device=CPU, step=40)
    assert not mgr.last_restore_stats["fallback_units"]
    _assert_states_equal(states[3], got)
    mgr.close()


class _FixedPredictor(DirtyPredictor):
    """Misprediction on demand: always guess ``n`` blocks."""

    def __init__(self, n):
        super().__init__()
        self._n = n

    def predict(self, name, kind, path, n_blocks, drift):
        return min(max(1, self._n), n_blocks)


@pytest.mark.parametrize("guess,expect_overflow,mutate", [
    (1, True, False),          # under-predict: every delta overflows
    (1 << 20, False, False),   # over-predict: full-capacity gathers
    (1, True, True),           # ... with the state overwritten after begin
    (1 << 20, False, True),
])
def test_misprediction_never_changes_committed_bytes(
        setup, tmp_path, guess, expect_overflow, mutate):
    """Force the predictor wrong both ways, and overwrite the live state
    in place right after every ``begin``: the committed manifests and
    objects still equal the sync save of the un-mutated states."""
    model, registry, states, _ = setup
    sy_sigs, sy_digests = _run_sync(tmp_path / "sync", model, registry,
                                    states)
    ov_sigs, ov_digests, stats = _run_overlapped(
        tmp_path / "ov", model, registry, states,
        predictor=_FixedPredictor(guess), mutate=mutate)
    assert sy_sigs == ov_sigs
    assert sy_digests == ov_digests
    redispatches = sum(s["overflow_redispatches"] for s in stats)
    assert (redispatches > 0) == expect_overflow


def test_spread_slices_and_forced_finish(setup, tmp_path):
    """spread_steps=N slices the staging across N ticks, and a new begin
    mid-spread force-finishes the event in flight (strict FIFO)."""
    model, registry, states, _ = setup
    mgr = _mgr(tmp_path, model, registry)
    ov = OverlappedSaver(mgr, spread_steps=3)
    ov.begin(_port(states[0]), 10)
    assert ov.active and ov.event_step == 10
    assert ov.tick() is None          # slice 1 of 3
    assert mgr.manifests.latest_step() is None
    ov.begin(_port(states[2]), 20)    # event 10 commits first
    assert mgr.manifests.latest_step() == 10
    assert mgr.last_save_stats["spread_slices"] == 2
    assert ov.active
    m = ov.finish()
    assert m is not None and m.step == 20
    assert mgr.manifests.all_steps() == [10, 20]
    assert ov.finish() is None and ov.tick() is None
    got = mgr.restore(steps_lib.state_specs(model), device=CPU, step=20)
    _assert_states_equal(states[2], got)
    ov.close()
    mgr.close()


def test_spread_ticks_commit_after_the_last_slice(setup, tmp_path):
    model, registry, states, _ = setup
    mgr = _mgr(tmp_path, model, registry)
    ov = OverlappedSaver(mgr, spread_steps=2)
    ov.begin(_port(states[0]), 10)
    n_units = 2 * len(registry.units)
    assert ov.tick() is None and ov.tick() is None
    m = ov.tick()                     # the tick after the last slice
    assert m is not None and m.step == 10
    s = mgr.last_save_stats
    assert s["spread_slices"] == 2 and s["full_chunks"] == n_units
    ov.close()
    mgr.close()


# ------------------------------------------------------------ crash matrix
@pytest.mark.parametrize("point,hit", [
    ("fingerprint", 1),        # in begin, after a unit's device pass
    ("snapshot_overlap", 1),   # died with the whole event in flight
    ("spread_slice", 1),       # before any slice ran
    ("spread_slice", 2),       # mid-spread: some units already written
    ("gather", 2),             # a slice staged, before its write
    ("pool:write", 1),         # on a writer thread, surfacing on a drain
    ("object_write", 2),       # inside the store, on a writer thread
    ("manifest_commit", 1),    # every object landed, no manifest yet
    ("manifest_latest", 1),    # torn commit: manifest file, old LATEST
])
def test_crash_mid_overlap_previous_manifest_wins(setup, tmp_path, point,
                                                  hit):
    """A crash anywhere in the overlap window: the previous manifest stays
    LATEST and restores bit-exact with no fallback, and the chain goes on
    after the restart."""
    model, registry, states, _ = setup
    mgr = _mgr(tmp_path, model, registry)
    ov = OverlappedSaver(mgr, spread_steps=2)
    ov.begin(_port(states[0]), 10)
    while ov.tick() is None:
        pass
    with faults.scoped(point, hit=hit):
        with pytest.raises((InjectedCrash, AsyncWriteError)):
            ov.begin(_port(states[2]), 20)
            while ov.tick() is None:
                pass
    assert not faults.pending()
    ov.close()
    mgr.close()

    mgr2 = _mgr(tmp_path, model, registry, async_save=False)
    assert mgr2.manifests.latest_step() == 10
    got = mgr2.restore(steps_lib.state_specs(model), device=CPU)
    assert not mgr2.last_restore_stats["fallback_units"]
    _assert_states_equal(states[0], got)
    ov2 = OverlappedSaver(mgr2, spread_steps=2)
    ov2.begin(_port(states[2]), 20)
    m = ov2.finish()
    assert m is not None and mgr2.manifests.latest_step() == 20
    got = mgr2.restore(steps_lib.state_specs(model), device=CPU, step=20)
    _assert_states_equal(states[2], got)
    ov2.close()
    mgr2.close()


@pytest.mark.parametrize("point,hit,async_save", [
    (p, h, a) for p, h in (("fingerprint", 2), ("gather", 1),
                           ("object_write", 1), ("manifest_commit", 1),
                           ("manifest_latest", 1))
    for a in (True, False)] + [("pool:write", 2, True)])
def test_crash_in_sync_save_previous_manifest_wins(setup, tmp_path, point,
                                                   hit, async_save):
    """The synchronous save reaches the same crash points (``pool:write``
    only with the async writer, inline writes run on no pool): a crash
    leaves the previous manifest authoritative and bit-exact."""
    model, registry, states, _ = setup
    mgr = _mgr(tmp_path, model, registry, async_save=async_save)
    mgr.save(_port(states[0]), step=10)
    with faults.scoped(point, hit=hit):
        with pytest.raises((InjectedCrash, AsyncWriteError)):
            mgr.save(_port(states[2]), step=20)
    assert not faults.pending()
    mgr.close()
    mgr2 = _mgr(tmp_path, model, registry, async_save=False)
    assert mgr2.manifests.latest_step() == 10
    got = mgr2.restore(steps_lib.state_specs(model), device=CPU)
    assert not mgr2.last_restore_stats["fallback_units"]
    _assert_states_equal(states[0], got)
    mgr2.close()


def test_meta_table_matches_jax(setup):
    """The structure-only table the overlapped saver plans with: the same
    paths, shapes, dtypes, sizes and block counts as the JAX package's."""
    from repro.checkpoint.fingerprint import meta_table as jax_meta_table
    from repro_torch.checkpoint.fingerprint import meta_table

    model, registry, states, jmodel = setup
    jreg = JaxRegistry(jmodel)
    st = _port(states[0])
    for unit in registry.unit_names():
        for kind in ("weights", "opt"):
            if kind == "weights":
                tree = registry.extract_unit(st["params"], unit)
                jtree = jreg.extract_unit(states[0]["params"], unit)
            else:
                tree = registry.extract_opt_unit(st["opt"], unit)
                jtree = jreg.extract_opt_unit(states[0]["opt"], unit)
            got = meta_table(tree, BB)
            want = jax_meta_table(jtree, BB)
            assert [(m.path, m.shape, m.dtype, m.nbytes, m.n_blocks)
                    for m in got] == \
                [(m.path, m.shape, m.dtype, m.nbytes, m.n_blocks)
                 for m in want]
            assert all(not m.fp.any() and m.sumsq is None for m in got)


def test_crash_points_cataloged_and_parsed():
    for p in ("fingerprint", "gather", "object_write", "manifest_commit",
              "manifest_latest", "snapshot_overlap", "spread_slice"):
        assert p in faults.CRASH_POINTS
    assert faults.parse_fail_at("7") == (7, None, 1)
    assert faults.parse_fail_at("7@spread_slice:2") == (7, "spread_slice", 2)
    with pytest.raises(ValueError):
        faults.parse_fail_at("7@")


# --------------------------------------------------------------- predictor
def test_predictor_advisory_lifecycle():
    p = DirtyPredictor(margin=1.5)
    # first sight: predict everything (cannot overflow)
    assert p.predict("u", "weights", "w", 64, None) == 64
    p.observe("u", "weights", "w", 4)
    # afterwards: last count x margin, clamped to [1, n_blocks]
    assert p.predict("u", "weights", "w", 64, None) == 6
    assert p.predict("u", "weights", "w", 64, 1.0) == 12    # drift widens
    assert p.predict("u", "weights", "w", 64, 123.0) == 12  # drift clamped
    p.observe("u", "weights", "w", 0)
    assert p.predict("u", "weights", "w", 64, None) == 1    # floor of 1
    p.observe("u", "weights", "w", 1000)
    assert p.predict("u", "weights", "w", 64, None) == 64   # ceiling


# ------------------------------------------------------------ staging arena
def test_staging_arena_reuses_and_grows_slots():
    arena = StagingArena(pin=False, min_bytes=4096)
    a = arena.acquire(100)
    b = arena.acquire(100)             # none free: a second slot
    assert arena.allocated_bytes == 2 * 4096 and a is not b
    v1, v2 = a.view(3), a.view(4)      # regions append
    v1.copy_(torch.tensor([1, 2, 3], dtype=torch.uint8))
    v2.fill_(9)
    assert a.buf[:7].tolist() == [1, 2, 3, 9, 9, 9, 9]
    with pytest.raises(AsyncWriteError):
        a.view(a.capacity)             # past the end
    arena.release(a)
    arena.release(b)
    c = arena.acquire(10)              # reused, cursor reset
    assert c in (a, b) and c.view(10).numel() == 10
    big = arena.acquire(100_000)       # grows the free slot, no new one
    assert big.capacity >= 100_000
    assert arena.allocated_bytes == 4096 + big.capacity
    arena.release(c)
    arena.release(big)
    assert arena.acquire(50_000) is big
    arena.close()
    with pytest.raises(AsyncWriteError):
        arena.acquire(1)


# ----------------------------------------------------------------- threads
def test_transfer_pool_errors_surface_on_drain():
    pool = TransferPool(3, max_queue=4)
    w = AsyncWriter(pool=pool)
    oks = [w.submit(lambda i=i: i * i) for i in range(20)]
    bad = w.submit(lambda: 1 / 0)
    with pytest.raises(AsyncWriteError):
        w.drain()
    assert [p.result() for p in oks] == [i * i for i in range(20)]
    with pytest.raises(ZeroDivisionError):
        bad.result()
    w.drain()                          # errors are reported once
    w.close()
    with pytest.raises(AsyncWriteError):
        w.submit(int)
    pool.close()
    with pytest.raises(AsyncWriteError):
        pool.submit("write", int)


def test_shared_counters_survive_thread_stress(tmp_path):
    """Writer threads bump the store's stats and refcounts and the kernels'
    launch counters at once: with a short switch interval a lost update
    would show in the totals."""
    store = ChunkStore(tmp_path)
    kern = CudaKernel("none", "none", [])
    kern._fn = lambda *a: 0            # a launch that does nothing
    n_threads, n = 12, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                store._bump(written_bytes=3, dedup_hits=1)
                store.incref(["d"])
                kern.launch()

        ts = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert store.stats_snapshot()["dedup_hits"] == n_threads * n
    assert store.stats_snapshot()["written_bytes"] == 3 * n_threads * n
    assert store.refcount("d") == n_threads * n
    assert kern.launches == n_threads * n
    store.close()


# ------------------------------------------------------------ across packages
def test_same_chain_same_store_as_jax_overlapped_saver(setup, tmp_path):
    """The five-event chain saved by the JAX package's OverlappedSaver
    (codec none) and by the port's: equal manifest entries and
    byte-identical objects."""
    model, registry, states, jmodel = setup
    jm = JaxManager(tmp_path / "jax", JaxRegistry(jmodel),
                    jax_make_policy("full", jmodel.layer_units()),
                    codec="none", fp_block_bytes=BB)
    jov = JaxOverlappedSaver(jm, spread_steps=2)
    pm = _mgr(tmp_path / "port", model, registry)
    pov = OverlappedSaver(pm, spread_steps=2)
    for step, si in EVENTS:
        jov.begin(states[si], step)
        pov.begin(_port(states[si]), step)
        while jov.tick() is None:
            pass
        while pov.tick() is None:
            pass
        assert _manifest_sig(pm, step) == _manifest_sig(jm, step), step
        for k in ("written_bytes", "dedup_hits", "delta_chunks",
                  "full_chunks", "logical_bytes", "d2h_bytes"):
            assert pm.last_save_stats[k] == jm.last_save_stats[k], (step, k)
    jov.close()
    jm.close()
    pov.close()
    pm.close()

    def objects(root):
        return {p.name: p.read_bytes()
                for p in sorted((root / "objects").glob("*/*.chunk"))}

    assert objects(tmp_path / "port") == objects(tmp_path / "jax")
