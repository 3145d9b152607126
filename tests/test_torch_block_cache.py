"""The port's block cache (``repro_torch.checkpoint.block_cache``) under
its store, manager, ``VariantSet`` and server, against the JAX package's.

The cache's unit semantics run as one scenario through both packages'
caches (same results, same counters).  The stores: the reduced Yi-9B,
JAX-initialized state through numpy, events at steps 2, 4 and 6 (policy
full, 4 KiB fingerprint blocks), each later event drifting a few elements
of block_001's and block_002's ``w_gate`` by a numpy ``RandomState``, so
@6's block_001 and block_002 are block deltas over step 2's full objects
and differ from @2's.  The variants: @6, @6 with block_001 from @2, @6
with block_002 from @2.  Weights are byte data, so every comparison is
exact.  Every cache and manager is closed, so no ``repro-io-<pid>-cache-*``
segment outlives a test (the session guard of ``tests/conftest.py``).
"""
import glob
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.block_cache import BlockCache as JaxBlockCache
from repro.checkpoint.saver import CheckpointManager as JaxManager
from repro.checkpoint.swap import VariantSet as JaxVariantSet
from repro.configs import get_config as jax_get_config
from repro.core import LayerRegistry as JaxRegistry
from repro.core.policies import make_policy as jax_make_policy
from repro.launch import steps as jax_steps
from repro.models import build_model as jax_build_model
from repro_torch.checkpoint.async_io import sweep_dead_owner_shm
from repro_torch.checkpoint.block_cache import BlockCache
from repro_torch.checkpoint.chunk_store import ChunkStore, ReadSession
from repro_torch.checkpoint.restore import device_materializer
from repro_torch.checkpoint.saver import CheckpointManager
from repro_torch.checkpoint.serial import flatten_with_paths
from repro_torch.checkpoint.swap import VariantSet
from repro_torch.configs import get_config
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core.layer_registry import LayerRegistry
from repro_torch.core.manifest import ManifestStore
from repro_torch.core.policies import make_policy
from repro_torch.core.tailor import variant_manifest
from repro_torch.launch import steps
from repro_torch.launch.serve import serve
from repro_torch.models import build_model

torch.set_num_threads(1)

ARCH = "yi-9b"
BB = 4096
CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parent.parent
MB = 1 << 20
VARIANTS = (("base", []), ("b1", [("block_001", 2)]),
            ("b2", [("block_002", 2)]))
DRIFTED = ("block_001", "block_002")


def _shm_segments():
    return glob.glob(f"/dev/shm/repro-io-{os.getpid():x}-cache-*")


# ------------------------------------------------------------- unit level
def _lru_budget(c):
    got = [c.get("a", lambda: b"a" * 40), c.get("b", lambda: b"b" * 40),
           c.get("a", lambda: pytest.fail("a hit loaded"))]
    c.get("c", lambda: b"c" * 40)           # 120 > 100: evicts "b", the LRU
    return got + [(c.peek("a"), c.peek("b"), c.peek("c"))]


def _bypass(c):
    c.get("a", lambda: b"a" * 40)
    big = c.get("huge", lambda: b"x" * 500)
    return [big, c.peek("huge"), c.peek("a")]


def _unpoisoned_failure(c):
    def flaky():
        raise OSError("io")
    with pytest.raises(OSError):
        c.get("f", flaky)
    return [c.get("f", lambda: b"f" * 8), c.get("f", lambda: b"never")]


def _coalescing(c):
    started, release = threading.Event(), threading.Event()
    loads = []

    def slow():
        loads.append(1)
        started.set()
        release.wait(5)
        return b"payload"

    out = [None] * 4

    def get(i):
        out[i] = c.get("d", slow)

    threads = [threading.Thread(target=get, args=(i,)) for i in range(4)]
    threads[0].start()
    assert started.wait(5)
    for t in threads[1:]:
        t.start()
    time.sleep(0.1)                         # the others reach the wait
    release.set()
    for t in threads:
        t.join(5)
    return out + [len(loads)]


def _shm_cleanup(c):
    c.get("a", lambda: b"x" * 128)
    held = len(_shm_segments())
    hit = c.get("a", lambda: b"never")
    c.close()
    after = len(_shm_segments())
    # closed: passes reads through, keeps nothing
    through = c.get("a", lambda: b"y" * 16)
    return [held, hit, after, through, c.peek("a")]


SCENARIOS = {"lru_budget": (_lru_budget, 100, False),
             "bypass": (_bypass, 100, False),
             "unpoisoned_failure": (_unpoisoned_failure, 100, False),
             "coalescing": (_coalescing, MB, False),
             "shm_cleanup": (_shm_cleanup, MB, True)}


def _plain(v):
    """A result as plain data: buffers as bytes."""
    if isinstance(v, (bytes, bytearray, memoryview)):
        return bytes(v)
    return v


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_cache_semantics_match_jax(name):
    run, budget, shm = SCENARIOS[name]
    results, snaps = [], []
    for cls in (JaxBlockCache, BlockCache):
        c = cls(budget, shm=shm)
        try:
            results.append([_plain(v) for v in run(c)])
            snaps.append(c.snapshot())
        finally:
            c.close()
    assert results[0] == results[1]
    assert snaps[0] == snaps[1]
    assert not _shm_segments()
    if name == "lru_budget":
        assert results[1][-1] == (True, False, True)
        assert snaps[1]["evictions"] == 1 and snaps[1]["hits"] == 1
    elif name == "bypass":
        assert snaps[1]["bypassed"] == 1 and snaps[1]["entries"] == 1
    elif name == "coalescing":
        assert results[1] == [b"payload"] * 4 + [1]
        assert snaps[1]["misses"] == 1 and snaps[1]["coalesced"] == 3
    elif name == "shm_cleanup":
        assert results[1][:3] == [1, b"x" * 128, 0]


def test_a_hit_fills_the_callers_buffer_and_never_aliases_it():
    c = BlockCache(MB)
    handed = []

    def alloc(n):
        handed.append(np.zeros(n, np.uint8))
        return handed[-1]

    try:
        first = c.get("d", lambda: memoryview(bytearray(b"\x01" * 64)), alloc)
        first[:] = b"\xff" * 64             # a decode writes into its blob
        hit = c.get("d", lambda: pytest.fail("loaded"), alloc)
        assert bytes(hit) == b"\x01" * 64
        assert len(handed) == 1 and hit.obj is handed[0]
        handed[0][:] = 7                    # a recycled lease
        assert bytes(c.get("d", lambda: b"", alloc)) == b"\x01" * 64
    finally:
        c.close()


def test_a_dead_owners_cache_segments_are_swept():
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    dead = f"/dev/shm/repro-io-{proc.pid:x}-cache-000001"
    live = f"/dev/shm/repro-io-{os.getpid():x}-cache-999999"
    for p in (dead, live):
        Path(p).write_bytes(b"x")
    try:
        removed = sweep_dead_owner_shm()
        assert os.path.basename(dead) in removed
        assert not os.path.exists(dead) and os.path.exists(live)
    finally:
        for p in (dead, live):
            if os.path.exists(p):
                os.unlink(p)


# ------------------------------------------------------------------ stores
def _jax_side():
    model = jax_build_model(jax_get_config(ARCH, reduced=True))
    return model, JaxRegistry(model)


def _port_model():
    return build_model(get_config(ARCH, reduced=True))


@pytest.fixture(scope="module")
def states():
    """Three numpy train states: JAX's init, then two drifts of a few
    elements of block_001's and block_002's w_gate (weights, master, m)."""
    jmodel, _ = _jax_side()
    s = jax.tree.map(np.asarray, jax_steps.init_state(jmodel,
                                                      jax.random.key(0)))
    rng = np.random.RandomState(1)
    out = [s]
    for _ in range(2):
        s = jax.tree.map(np.array, out[-1])
        for tree in (s["params"], s["opt"]["master"], s["opt"]["m"]):
            w = tree["blocks"]["mlp"]["w_gate"]
            for b in (1, 2):
                w[b, 0, :5] = (w[b, 0, :5].astype(np.float32)
                               + rng.rand(5).astype(np.float32)
                               ).astype(w.dtype)
        out.append(s)
    return out


def _port_mgr(root, **kw):
    model = _port_model()
    kw.setdefault("async_save", False)
    kw.setdefault("fp_block_bytes", BB)
    return model, CheckpointManager(
        root, LayerRegistry(model),
        make_policy(kw.pop("policy", "full"), model.layer_units()), **kw)


def _write_port(root, states, **kw):
    _, mgr = _port_mgr(root, **kw)
    try:
        for step, s in zip((2, 4, 6), states):
            mgr.save(state_from_numpy(s, "cpu"), step=step)
    finally:
        mgr.close()
    return root


@pytest.fixture(scope="module")
def jax_store(tmp_path_factory, states):
    root = tmp_path_factory.mktemp("cache") / "jax"
    jmodel, jreg = _jax_side()
    mgr = JaxManager(root, jreg, jax_make_policy("full", jmodel.layer_units()),
                     codec="none", async_save=False, fp_block_bytes=BB)
    try:
        for step, s in zip((2, 4, 6), states):
            mgr.save(s, step=step)
    finally:
        mgr.close()
    return root


@pytest.fixture(scope="module")
def port_store(tmp_path_factory, states):
    return _write_port(tmp_path_factory.mktemp("cache") / "port", states)


def _variant_digests(root, select):
    """The digests a weights-only load of the variant reads: each unit's
    object and, for a delta, its base."""
    m = variant_manifest(ManifestStore(root), base_step=6, select=select)
    out = set()
    for kinds in m.entries.values():
        r = kinds["weights"]
        out.add(r.digest)
        if r.delta_base:
            out.add(r.delta_base)
    return out


def _flat_bytes(tree):
    """{path: raw bytes} of a nested dict of arrays or tensors."""
    out = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{prefix}/{k}" if prefix else k)
        else:
            out[prefix] = np.ascontiguousarray(
                state_to_numpy(t) if isinstance(t, torch.Tensor)
                else np.asarray(t)).tobytes()

    walk(tree, "")
    return out


def _load_variants(mgr, model):
    vs = VariantSet(mgr, steps.state_specs(model), device="cpu")
    r0 = mgr.store.backend_reads
    for name, select in VARIANTS:
        vs.materialize(name, base_step=6, select=select)
    return vs, mgr.store.backend_reads - r0


def test_store_setup_drifts_the_selected_units(port_store):
    m2, m6 = (ManifestStore(port_store).load(s) for s in (2, 6))
    for u in m6.entries:
        differ = (m2.entries[u]["weights"].digest
                  != m6.entries[u]["weights"].digest)
        assert differ == (u in DRIFTED), u
        if differ:
            assert m6.entries[u]["weights"].stored == "delta"


# ---------------------------------------------------------- store and gc
def test_store_reads_through_the_cache_and_gc_discards(tmp_path, states):
    cache = BlockCache(64 * MB)
    model, mgr = _port_mgr(tmp_path, block_cache=cache, keep=1)
    try:
        assert mgr.store.block_cache is cache and mgr.block_cache is cache
        mgr.save(state_from_numpy(states[0], "cpu"), step=10)
        digest = ManifestStore(tmp_path).load(10).entries[
            "block_000"]["weights"].digest
        mgr.store.read_object_bytes(digest)
        before = mgr.store.backend_reads
        blob = mgr.store.read_object_bytes(digest)
        assert mgr.store.backend_reads == before     # served by the cache
        assert cache.peek(digest)
        assert bytes(blob) == mgr.store.object_path(digest).read_bytes()
        # every weight changes: step 10's weights objects are retired
        poked = jax.tree.map(np.array, states[0])
        poked["params"] = jax.tree.map(
            lambda x: (x.astype(np.float32) + 1).astype(x.dtype),
            poked["params"])
        mgr.save(state_from_numpy(poked, "cpu"), step=20)
        mgr.gc()
        assert not mgr.store.has(digest)
        assert not cache.peek(digest)
    finally:
        mgr.close()
    # a cache passed in is the caller's: the manager left it open
    cache.get("k", lambda: b"kept")
    assert cache.peek("k")
    cache.close()


def test_a_managers_own_cache_closes_with_it(port_store):
    _, mgr = _port_mgr(port_store, block_cache_bytes=64 * MB,
                       block_cache_shm=True)
    try:
        d = ManifestStore(port_store).load(6).entries["embed"]["weights"]
        mgr.store.read_object_bytes(d.digest)
        assert _shm_segments()
    finally:
        mgr.close()
    assert not _shm_segments()


# ---------------------------------------------------------------- variants
def test_variants_read_each_shared_digest_once(port_store):
    model, mgr = _port_mgr(port_store, block_cache_bytes=64 * MB)
    seen = []
    backend = mgr.store.backend
    real = backend.read_into

    def spy(key, alloc):
        seen.append(key)
        return real(key, alloc)

    backend.read_into = spy
    try:
        vs, reads = _load_variants(mgr, model)
        distinct = set().union(*(_variant_digests(port_store, s)
                                 for _, s in VARIANTS))
        assert len(seen) == len(set(seen)) == reads == len(distinct)
        assert set(seen) == distinct
        snap = vs.stats()["cache"]
        assert snap["misses"] == len(distinct) and snap["hits"] > 0
        # per variant, restore stats as without the cache: every object
        # the variant reads is counted, hit or miss
        for name, select in VARIANTS:
            got = vs.stats()["variants"][name]
            assert got["objects_read"] == len(_variant_digests(port_store,
                                                               select))
        # b1's block_001 is @2's
        cold2 = mgr.restore({"params": steps.state_specs(model)["params"]},
                            device=CPU, parts=("params",), step=2)
        reg = mgr.registry
        assert _flat_bytes(reg.extract_unit(vs.params("b1"), "block_001")) \
            == _flat_bytes(reg.extract_unit(cold2["params"], "block_001"))
    finally:
        backend.read_into = real
        mgr.close()


def _variant_run(root, **kw):
    """(backend reads, cache snapshot, {variant: flat bytes}, restore
    stats) of the three variants on one port manager."""
    model, mgr = _port_mgr(root, **kw)
    try:
        vs, reads = _load_variants(mgr, model)
        st = vs.stats()
        params = {n: _flat_bytes(vs.params(n)) for n, _ in VARIANTS}
        return reads, st["cache"], params, st["variants"]
    finally:
        mgr.close()


@pytest.mark.parametrize("shm", [False, True])
def test_cached_loads_read_less_and_serve_the_same_weights(port_store, shm):
    reads_c, snap, cached, stats_c = _variant_run(
        port_store, block_cache_bytes=64 * MB, block_cache_shm=shm)
    reads_u, none, uncached, stats_u = _variant_run(port_store)
    assert none is None
    per_variant = [_variant_digests(port_store, s) for _, s in VARIANTS]
    assert reads_c == len(set().union(*per_variant)) < reads_u
    assert reads_u == sum(len(d) for d in per_variant)
    assert snap["misses"] == reads_c
    assert snap["hits"] == reads_u - reads_c
    assert cached == uncached
    keys = ("objects_read", "bytes_read", "tier_reads", "unique_digests",
            "planned_object_reads", "targets")
    assert {n: {k: v[k] for k in keys} for n, v in stats_c.items()} == \
        {n: {k: v[k] for k in keys} for n, v in stats_u.items()}
    assert not _shm_segments()


def test_budgets_below_an_object_and_below_the_working_set(port_store):
    sizes = {d: ChunkStore(port_store).object_size(d) for d in
             set().union(*(_variant_digests(port_store, s)
                           for _, s in VARIANTS))}
    _, _, want, _ = _variant_run(port_store)
    # below the smallest object: every object bypasses
    reads, snap, got, _ = _variant_run(
        port_store, block_cache_bytes=min(sizes.values()) - 1)
    assert got == want and snap["bypassed"] == snap["misses"] == reads
    assert snap["hits"] == 0 and snap["entries"] == 0
    # holds the largest object but not all of them: evictions
    reads, snap, got, _ = _variant_run(
        port_store, block_cache_bytes=max(sizes.values()))
    assert got == want and snap["evictions"] > 0
    assert snap["bytes"] <= max(sizes.values())


def test_jax_and_port_variants_agree_on_one_jax_store(jax_store):
    jmodel, jreg = _jax_side()
    jmgr = JaxManager(jax_store, jreg,
                      jax_make_policy("full", jmodel.layer_units()),
                      async_save=False, fp_block_bytes=BB,
                      block_cache_bytes=64 * MB)
    try:
        jvs = JaxVariantSet(jmgr, jax_steps.state_specs(jmodel))
        r0 = jmgr.store.backend_reads
        for name, select in VARIANTS:
            jvs.materialize(name, base_step=6, select=select)
        j_reads = jmgr.store.backend_reads - r0
        j_snap = jvs.stats()["cache"]
        j_params = {n: _flat_bytes(jax.tree.map(np.asarray, jvs.params(n)))
                    for n, _ in VARIANTS}
    finally:
        jmgr.close()
    reads, snap, params, _ = _variant_run(jax_store,
                                          block_cache_bytes=64 * MB)
    assert params == j_params
    assert reads == j_reads == len(set().union(
        *(_variant_digests(jax_store, s) for _, s in VARIANTS)))
    assert {k: snap[k] for k in ("hits", "misses")} == \
        {k: j_snap[k] for k in ("hits", "misses")}
    assert params["b1"] != params["base"] != params["b2"]


@pytest.mark.process_io
def test_the_process_backend_with_the_cache(port_store):
    want = _variant_run(port_store)
    got = _variant_run(port_store, block_cache_bytes=64 * MB,
                       io_backend="process", io_workers=2)
    reads, snap, params, stats = got
    assert params == want[2]
    assert reads == snap["misses"] < want[0]
    assert all(v["io_backend"] == "process" for v in stats.values())
    assert not _shm_segments()


@pytest.mark.parametrize("cached", [False, True])
def test_a_hot_swap_reports_its_cache_counts(port_store, cached):
    """A swap from @2 to @6 on a manager whose cache already holds @6's
    objects (a variant of @6 loaded first) reads only what @2 lacks, all
    of it from the cache; without a cache its ``cache`` is None."""
    from repro_torch.checkpoint.swap import WeightService
    kw = {"block_cache_bytes": 64 * MB} if cached else {}
    model, mgr = _port_mgr(port_store, **kw)
    try:
        like = steps.state_specs(model)
        VariantSet(mgr, like, device="cpu").materialize("v", base_step=6)
        svc = WeightService(mgr, like, device="cpu", step=2)
        r0 = mgr.store.backend_reads
        stats = svc.swap(ManifestStore(port_store).load(6))
        reads = mgr.store.backend_reads - r0
        cold6 = mgr.restore({"params": like["params"]}, device=CPU,
                            parts=("params",), step=6)["params"]
        assert _flat_bytes(svc.current()) == _flat_bytes(cold6)
        assert stats["units_swapped"] == len(DRIFTED)
        if cached:
            assert reads == 0
            assert stats["cache"] == {"hits": stats["objects_read"],
                                      "misses": 0, "evictions": 0}
        else:
            assert stats["cache"] is None
            assert reads == stats["objects_read"]
    finally:
        mgr.close()


# ------------------------------------------------------- object formats
def _format_store(root, states, fmt):
    kw = {"bd02": {}, "xd01": {"fingerprint": False},
          "int8": {"fingerprint": False, "codec": "int8"},
          "fp_int8": {"codec": "int8"}}[fmt]
    return _write_port(root, states, **kw)


@pytest.mark.parametrize("fmt", ["bd02", "xd01", "int8", "fp_int8"])
def test_every_object_format_reads_twice_through_the_cache(tmp_path, states,
                                                           fmt):
    """A tree read through the cache, its buffers then overwritten (a
    recycled lease, a decode writing into its blob), and read again on a
    hit, equals the tree an uncached store reads; the cached bytes equal
    the object file's."""
    root = _format_store(tmp_path / fmt, states, fmt)
    m = ManifestStore(root).load(6)
    refs = [r for kinds in m.entries.values() for r in kinds.values()]
    stored = {r.stored for r in refs}
    assert stored == ({"full"} if "int8" in fmt else {"full", "delta"})
    digests = sorted({d for r in refs for d in (r.digest, r.delta_base)
                      if d})
    mat = device_materializer(CPU)

    def read_all(store, alloc=None):
        s = ReadSession(store, alloc=alloc, materialize=mat)
        return {d: s.read(d) for d in digests}

    want = read_all(ChunkStore(root, codec="int8" if "int8" in fmt
                               else "none"))
    cache = BlockCache(64 * MB)
    store = ChunkStore(root, block_cache=cache)
    handed = []

    def alloc(n):
        handed.append(bytearray(n))
        return handed[-1]

    def flat(got):
        return {d: (_items_bytes(tree), None if fp is None else bytes(fp))
                for d, (tree, fp) in got.items()}

    want = flat(want)
    try:
        assert flat(read_all(store, alloc)) == want
        reads = store.backend_reads
        assert reads == len(digests)
        for buf in handed:
            buf[:] = b"\xa5" * len(buf)
        assert flat(read_all(store, alloc)) == want
        assert store.backend_reads == reads
        assert cache.snapshot()["hits"] >= len(digests)
        for d in digests:
            cached = cache.get(d, lambda: pytest.fail("evicted"))
            assert bytes(cached) == store.object_path(d).read_bytes()
    finally:
        cache.close()


def _items_bytes(tree):
    out = {}
    for path, leaf in flatten_with_paths(tree):
        if isinstance(leaf, torch.Tensor):
            out[path] = state_to_numpy(leaf).tobytes()
        else:                               # an int8 record
            out[path] = (bytes(memoryview(leaf.data).cast("B")), leaf.n_q,
                         leaf.n_scale, tuple(leaf.shape), leaf.dtype)
    return out


# ------------------------------------------------------------------ server
SERVE = dict(arch=ARCH, batch=2, prompt_len=8, new_tokens=3, device="cpu",
             variant_base_step=6, variant_select=["block_001@2"])


def test_serve_through_the_cache_gives_the_uncached_tokens(port_store):
    plain = serve(from_ckpt=str(port_store), **SERVE)
    cached = serve(from_ckpt=str(port_store), cache_mb=64, **SERVE)
    assert plain["cache"] is None
    assert cached["tokens_digest"] == plain["tokens_digest"]
    assert cached["cache"]["misses"] == len(
        _variant_digests(port_store, [("block_001", 2)]))
    assert cached["restore"]["objects_read"] == \
        plain["restore"]["objects_read"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", ARCH, "--batch", "2", "--prompt-len", "8",
         "--new-tokens", "3", "--from-ckpt", str(port_store),
         "--variant-base-step", "6", "--variant-select", "block_001@2",
         "--cache-mb", "64", "--cache-shm"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    cli = json.loads(out.stdout)
    assert cli["tokens_digest"] == plain["tokens_digest"]
    assert cli["cache"] == cached["cache"]
