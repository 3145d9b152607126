"""Shard-native checkpoints of the port (``checkpoint/sharded.py``,
``parallel/sharding.py``): the block math against the JAX package's, the
cases of ``tests/test_sharded_ckpt.py`` but its mesh test (roundtrip,
resharded restores, block deltas per shard object, the canonical path, GC
retention, the barrier and its crash, the event index past the retention
cap, stale cohorts, an incomplete cover, the three fallbacks, a legacy
manifest, the merge, a global save over a sharded chain, the policies'
tie-break), the sharded rows of ``tests/test_resiliency.py``'s crash
matrix, leaves too short for every participant and scalars, and the
mesh half's refusal (ROADMAP A4.2).

The train state is the JAX package's initialization of the reduced
mamba2-370m (llama3.2-3b where the JAX test takes it), carried to the port
through numpy; drifts are made with numpy.  Everything compared is bytes
or tensors, so every comparison is exact.
"""
import jax
import numpy as np
import pytest
import torch

from proptest import cases, rand_shape
from repro.configs import get_config as jax_get_config
from repro.launch import steps as jax_steps
from repro.models import build_model as jax_build_model
from repro.parallel import sharding as jax_shd
from repro_torch.checkpoint import faults
from repro_torch.checkpoint.async_io import AsyncWriteError
from repro_torch.checkpoint.chunk_store import ChunkRef
from repro_torch.checkpoint.faults import InjectedCrash
from repro_torch.checkpoint.restore import RestoreError
from repro_torch.checkpoint.saver import CheckpointManager
from repro_torch.checkpoint.serial import flatten_with_paths
from repro_torch.checkpoint.sharded import (ShardBarrierError,
                                            ShardCoordinator,
                                            ShardedCheckpointer,
                                            ShardedSaver, assemble_shards,
                                            combine_states,
                                            participant_wanted,
                                            spec_overlaps)
from repro_torch.configs import get_config
from repro_torch.convert import state_from_numpy
from repro_torch.core import Recipe, merge
from repro_torch.core.layer_registry import LayerRegistry
from repro_torch.core.manifest import Manifest, entry_refs, is_sharded
from repro_torch.core.policies import PolicyContext, make_policy
from repro_torch.core.recipe import CheckpointRef
from repro_torch.launch import steps
from repro_torch.models import build_model
from repro_torch.models.model_api import LayerUnit
from repro_torch.parallel import sharding as shd

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.disarm()
    yield
    faults.disarm()


def _np_state(arch):
    jmodel = jax_build_model(jax_get_config(arch, reduced=True))
    return jax.tree.map(np.asarray,
                        jax_steps.init_state(jmodel, jax.random.key(0)))


@pytest.fixture(scope="module")
def small():
    model = build_model(get_config("mamba2-370m", reduced=True))
    return model, _np_state("mamba2-370m"), LayerRegistry(model)


def _port(np_state):
    return state_from_numpy(np_state, "cpu")


def _mgr(root, model, reg, policy="full", **kw):
    return CheckpointManager(root, reg, make_policy(policy,
                                                    model.layer_units()),
                             **kw)


def _like(model):
    return steps.state_specs(model)


def _assert_state_equal(a, b, parts=("params", "opt")):
    for part in parts:
        fa, fb = flatten_with_paths(a[part]), flatten_with_paths(b[part])
        assert [p for p, _ in fa] == [p for p, _ in fb]
        for (p, x), (_, y) in zip(fa, fb):
            assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()), p


def _map_np(fn, np_state, parts=("params",)):
    out = dict(np_state)
    for part in parts:
        out[part] = jax.tree.map(lambda x: fn(np.array(x)), np_state[part])
    return out


def _plus_one(x):
    return (x.astype(np.float32) + 1).astype(x.dtype)


# ------------------------------------------------------------- block math
def test_block_math_basics():
    a = ((0, 4), (0, 8))
    b = ((2, 6), (4, 12))
    assert shd.intersect_blocks(a, b) == ((2, 4), (4, 8))
    assert shd.intersect_blocks(a, ((4, 6), (0, 8))) is None
    assert shd.block_size(a) == 32
    assert shd.block_size(()) == 1  # scalar block
    assert shd.blocks_cover_exactly((4, 8), [((0, 2), (0, 8)),
                                             ((2, 4), (0, 8))])
    assert not shd.blocks_cover_exactly((4, 8), [((0, 3), (0, 8)),
                                                 ((2, 4), (0, 8))])
    assert not shd.blocks_cover_exactly((4, 8), [((0, 2), (0, 8))])
    assert shd.uniform_blocks((), 0, 3) == ((),)
    assert shd.uniform_blocks((), 1, 3) == ()
    assert shd.uniform_blocks((2, 5), 3, 4) == ()
    with pytest.raises(ValueError):
        shd.uniform_blocks((4,), 4, 4)


def _grid_partition(rs, shape):
    """A random grid tiling of ``shape`` (per-dimension cut points)."""
    if not shape:
        return [()]
    per_dim = []
    for d in shape:
        n_cuts = rs.randint(0, min(3, d))
        cuts = sorted(set([0, d] + list(rs.randint(1, d, size=n_cuts))
                          if d > 1 else [0, d]))
        per_dim.append([(cuts[i], cuts[i + 1])
                        for i in range(len(cuts) - 1)])
    blocks = [()]
    for ranges in per_dim:
        blocks = [b + (r,) for b in blocks for r in ranges]
    return blocks


@pytest.mark.parametrize("seed", range(4))
def test_block_math_agrees_with_jax(seed):
    """A seeded sweep of shapes (scalars among them) and participant
    counts: ``uniform_blocks`` per participant, ``intersect_blocks`` of
    random grid blocks, ``blocks_cover_exactly`` of true and broken
    covers, ``normalize_index``, ``block_size`` and ``partition_devices``
    are the JAX package's, value for value."""
    def gen(rs):
        shape = (() if rs.rand() < 0.1
                 else rand_shape(rs, ndim_max=3, dim_max=11))
        return shape, int(rs.randint(1, 9))

    for shape, n in cases(50, gen, seed=100 + seed):
        for pid in range(n):
            got = shd.uniform_blocks(shape, pid, n)
            assert got == jax_shd.uniform_blocks(shape, pid, n)
        owned = [b for pid in range(n)
                 for b in shd.uniform_blocks(shape, pid, n)]
        assert shd.blocks_cover_exactly(shape, owned)
        rs = np.random.RandomState(seed)
        grid = _grid_partition(rs, shape)
        broken = [grid[:-1], grid + grid[:1]] if len(grid) > 1 else [[]]
        for blocks in [grid, owned] + broken:
            assert shd.blocks_cover_exactly(shape, blocks) == \
                jax_shd.blocks_cover_exactly(shape, blocks)
        for x in grid:
            assert shd.block_size(x) == jax_shd.block_size(x)
            for y in grid + owned:
                if len(x) == len(y):
                    assert shd.intersect_blocks(x, y) == \
                        jax_shd.intersect_blocks(x, y)
            idx = shd.block_slices(x)
            assert shd.normalize_index(idx[:1], shape) == \
                jax_shd.normalize_index(idx[:1], shape)
        devs = list(range(int(rs.randint(n, 3 * n + 1))))
        assert shd.partition_devices(devs, n) == \
            jax_shd.partition_devices(devs, n)


def test_slice_plan_covers_target_exactly():
    """For random shapes, source shard sets and target participants (two
    random grid tilings), the shards ``spec_overlaps`` plans meet each
    target's blocks in pieces that tile them with no double read, and
    every skipped shard is disjoint from the target."""
    def gen(rs):
        shape = rand_shape(rs, ndim_max=3, dim_max=9)

        def assign(blocks, k):
            owners = [[] for _ in range(k)]
            for b in blocks:
                owners[rs.randint(0, k)].append(b)
            return [tuple(o) for o in owners]

        return (shape,
                assign(_grid_partition(rs, shape), int(rs.randint(1, 5))),
                assign(_grid_partition(rs, shape), int(rs.randint(1, 5))))

    for shape, src, tgt in cases(60, gen, seed=77):
        specs = [{"participant": i,
                  "leaves": [{"path": "w", "shape": list(shape),
                              "dtype": "float32",
                              "blocks": [list(map(list, b))
                                         for b in blocks]}]}
                 for i, blocks in enumerate(src) if blocks]
        for want in tgt:
            planned = [sp for sp in specs if spec_overlaps(
                sp, lambda *_a, _w=want: _w, "u", "weights")]
            pieces = [shd.intersect_blocks(tuple(map(tuple, b)), w)
                      for sp in planned for b in sp["leaves"][0]["blocks"]
                      for w in want]
            pieces = [p for p in pieces if p]
            assert sum(map(shd.block_size, pieces)) == \
                sum(map(shd.block_size, want))
            for i, p in enumerate(pieces):
                assert not any(shd.intersect_blocks(p, q)
                               for q in pieces[i + 1:])
            for sp in specs:
                if sp not in planned:
                    assert not any(
                        shd.intersect_blocks(tuple(map(tuple, b)), w)
                        for b in sp["leaves"][0]["blocks"] for w in want)


def test_mesh_ownership_names_a4_2(small):
    """Ownership from a device mesh's shardings is ROADMAP A4.2: the
    resolver and a participant given ``shardings`` raise naming it."""
    _, _, reg = small
    with pytest.raises(ValueError, match="A4.2"):
        participant_wanted(reg, 0, 2, shardings={"params": {}})
    with pytest.raises(ValueError, match="A4.2"):
        ShardedSaver(type("M", (), {"registry": reg})(), 0, 2,
                     shardings={"params": {}})
    with pytest.raises(ValueError, match="outside"):
        participant_wanted(reg, 2, 2)


def test_scalars_and_short_axes(small):
    """A scalar belongs to participant 0 and a leaf whose axis 0 is
    shorter than N leaves the last participants nothing; the pieces are
    views of the leaves (no copy), and ``assemble_shards`` of every
    participant's shard rebuilds the tree, zero-filled where ``partial``
    leaves out a participant."""
    _, _, reg = small
    mgr = type("M", (), {"registry": reg})()
    tree = {"s": torch.tensor(3.5), "w": torch.arange(6.).reshape(2, 3),
            "b": torch.arange(5, dtype=torch.bfloat16)}
    parts = []
    for pid in range(3):
        spec, shard = ShardedSaver(mgr, pid, 3)._shard_of("u", "weights",
                                                         tree)
        if pid == 2:
            assert [leaf["path"] for leaf in spec["leaves"]] == ["b"]
        if pid == 0:
            assert "s#b0" in shard
            assert shard["w#b0"].data_ptr() == tree["w"].data_ptr()
        else:
            assert "s#b0" not in shard
        for key, piece in shard.items():
            if key.startswith("w"):
                assert piece.untyped_storage().data_ptr() == \
                    tree["w"].untyped_storage().data_ptr()
        parts.append((spec, {k: v.clone() for k, v in shard.items()}))
    whole, moved = assemble_shards(parts, partial=False)
    for k, v in tree.items():
        assert torch.equal(whole[k], v), k
    assert moved == sum(v.numel() * v.element_size() for v in tree.values())
    part, _ = assemble_shards(parts[1:], partial=True)
    assert torch.equal(part["w"][1], tree["w"][1])
    assert not part["w"][0].any() and "s" not in part
    with pytest.raises(ValueError, match="tile"):
        assemble_shards(parts[1:], partial=False)


# ------------------------------------------------------- save/restore paths
def test_sharded_save_restart_restore_roundtrip(small, tmp_path):
    model, nps, reg = small
    state = _port(nps)
    mgr = _mgr(tmp_path, model, reg, "parity")
    ck = ShardedCheckpointer(mgr, 2)
    m1 = ck.save(state, step=10)
    assert all(is_sharded(e) for kinds in m1.entries.values()
               for e in kinds.values())
    assert m1.meta["sharded"]["n_participants"] == 2
    pids = {r.spec["participant"] for kinds in m1.entries.values()
            for e in kinds.values() for r in entry_refs(e)}
    assert pids == {0, 1}
    ck.save(state, step=20)
    s = mgr.last_save_stats
    assert s["written_bytes"] == 0 and s["d2h_bytes"] == 0
    assert s["dedup_hits"] > 0 and s["participants"] == 2
    mgr.close()

    mgr2 = _mgr(tmp_path, model, reg, "parity", async_save=False)
    restored = mgr2.restore(_like(model), device=CPU)
    _assert_state_equal(state, restored)
    assert int(restored["step"]) == 20
    st = mgr2.last_restore_stats
    assert not st["fallback_units"] and st["shards_skipped"] == 0
    assert st["sharded_targets"] == st["targets"] > 2 * len(reg.units)
    ShardedCheckpointer(mgr2, 2).save(state, step=30)
    s = mgr2.last_save_stats
    assert s["written_bytes"] == 0 and s["d2h_bytes"] == 0
    mgr2.close()


@pytest.mark.parametrize("n_save,n_restore", [(2, 4), (8, 3)])
def test_resharded_restore_reads_strictly_fewer_bytes(small, tmp_path,
                                                      n_save, n_restore):
    model, nps, reg = small
    state = _port(nps)
    mgr = _mgr(tmp_path, model, reg)
    ShardedCheckpointer(mgr, n_save).save(state, step=10)
    like = _like(model)
    mgr.restore(like, device=CPU)
    full = dict(mgr.last_restore_stats)
    assert full["sharded_targets"] > 0 and full["shards_skipped"] == 0
    results, wanteds = [], []
    for pid in range(n_restore):
        wanted = participant_wanted(reg, pid, n_restore)
        results.append(mgr.restore(like, device=CPU, owned=wanted))
        s = mgr.last_restore_stats
        assert s["bytes_read"] < full["bytes_read"]
        assert s["shards_skipped"] > 0
        wanteds.append(wanted)
    mgr.close()
    combined = combine_states(like, reg, results, wanteds)
    _assert_state_equal(state, combined)
    assert int(combined["step"]) == 10


def test_block_delta_per_shard_object(tmp_path):
    """A one-element drift per weights leaf lands as block deltas per
    shard object: only the owner's dirty blocks move device->host."""
    model = build_model(get_config("llama3.2-3b", reduced=True))
    reg = LayerRegistry(model)
    nps = _np_state("llama3.2-3b")
    mgr = _mgr(tmp_path, model, reg, fp_block_bytes=4096)
    ck = ShardedCheckpointer(mgr, 2)
    ck.save(_port(nps), step=10)

    def poke(x):
        x.flat[0] = _plus_one(x.flat[:1])[0]
        return x

    drifted = _map_np(poke, nps)
    ck.save(_port(drifted), step=20)
    s = mgr.last_save_stats
    assert s["delta_chunks"] > 0, s
    assert s["dirty_block_frac"] < 0.05, s
    assert s["dedup_hits"] > 0
    _assert_state_equal(_port(drifted), mgr.restore(_like(model),
                                                     device=CPU))
    mgr.close()


def test_non_fingerprint_sharded_path(small, tmp_path):
    """The canonical path saves shard-native too: XOR deltas per shard
    object on the later event."""
    model, nps, reg = small
    mgr = _mgr(tmp_path, model, reg, fingerprint=False)
    ck = ShardedCheckpointer(mgr, 2)
    ck.save(_port(nps), step=10)
    drifted = _map_np(_plus_one, nps)
    ck.save(_port(drifted), step=20)
    assert mgr.last_save_stats["delta_chunks"] > 0
    _assert_state_equal(_port(drifted), mgr.restore(_like(model),
                                                     device=CPU))
    mgr.close()


def test_sharded_gc_retention(small, tmp_path):
    model, nps, reg = small
    mgr = _mgr(tmp_path, model, reg, keep=2, async_save=False)
    ck = ShardedCheckpointer(mgr, 2, parallel=False)
    rng = np.random.RandomState(0)
    for i in range(4):
        bump = rng.standard_normal()
        drifted = _map_np(lambda x: (x.astype(np.float32) + bump)
                          .astype(x.dtype), nps)
        ck.save(_port(drifted), step=(i + 1) * 10)
    assert mgr.manifests.all_steps() == [30, 40]
    live = set()
    for s in (30, 40):
        live |= set(mgr.manifests.load(s).referenced_digests())
    assert all(mgr.store.has(d) for d in live)
    assert set(mgr.store.iter_digests()) == live
    _assert_state_equal(_port(drifted), mgr.restore(_like(model),
                                                     device=CPU))
    mgr.close()


def test_barrier_crash_keeps_previous_manifest(small, tmp_path):
    model, nps, reg = small
    state = _port(nps)
    mgr = _mgr(tmp_path, model, reg, async_save=False)
    ShardedCheckpointer(mgr, 2).save(state, step=10)
    ShardedSaver(mgr, 0, 2).save_shards(state, step=20)
    coord = ShardCoordinator(mgr)
    with pytest.raises(ShardBarrierError, match="missing participant"):
        coord.commit(20, 2)
    restored = mgr.restore(_like(model), device=CPU)
    assert int(restored["step"]) == 10
    _assert_state_equal(state, restored)
    ShardedSaver(mgr, 1, 2).save_shards(state, step=20)
    assert coord.commit(20, 2).step == 20
    restored = mgr.restore(_like(model), device=CPU)
    assert int(restored["step"]) == 20
    _assert_state_equal(state, restored)
    assert not (tmp_path / "shards").exists() or \
        not list((tmp_path / "shards").iterdir())
    mgr.close()


def test_event_index_survives_retention_cap(small, tmp_path):
    model, nps, reg = small
    state = _port(nps)
    mgr = _mgr(tmp_path, model, reg, "parity", keep=2, async_save=False)
    ck = ShardedCheckpointer(mgr, 2, parallel=False)
    selections = [(m.meta["event_index"], tuple(m.saved_units))
                  for m in (ck.save(state, step=(i + 1) * 10)
                            for i in range(6))]
    assert [i for i, _ in selections] == list(range(6))
    assert selections[-1][1] != selections[-2][1]
    mgr.close()
    mgr2 = _mgr(tmp_path, model, reg, "parity", keep=2, async_save=False)
    m = ShardedCheckpointer(mgr2, 2, parallel=False).save(state, step=70)
    assert m.meta["event_index"] == 6
    mgr2.close()


def test_stale_cohort_records_do_not_block_commit(small, tmp_path):
    model, nps, reg = small
    state = _port(nps)
    mgr = _mgr(tmp_path, model, reg, async_save=False)
    ShardedSaver(mgr, 2, 4).save_shards(state, step=10)
    ShardedSaver(mgr, 3, 4).save_shards(state, step=10)
    ShardedSaver(mgr, 0, 2).save_shards(state, step=10)
    ShardedSaver(mgr, 1, 2).save_shards(state, step=10)
    manifest = ShardCoordinator(mgr).commit(10, 2)
    assert manifest.meta["sharded"]["n_participants"] == 2
    _assert_state_equal(state, mgr.restore(_like(model), device=CPU))
    mgr.close()


def test_coordinator_rejects_incomplete_cover(small, tmp_path):
    model, nps, reg = small
    state = _port(nps)
    mgr = _mgr(tmp_path, model, reg, async_save=False)
    s0, s1 = ShardedSaver(mgr, 0, 2), ShardedSaver(mgr, 1, 2)
    s1.wanted = s0.wanted  # both claim the same half
    s0.save_shards(state, step=10)
    s1.save_shards(state, step=10)
    with pytest.raises(ShardBarrierError, match="do not exactly tile"):
        ShardCoordinator(mgr).commit(10, 2)
    assert mgr.manifests.latest_step() is None
    mgr.close()


def _two_events(model, reg, nps, root, drifted):
    mgr = _mgr(root, model, reg, keep=4, async_save=False)
    ck = ShardedCheckpointer(mgr, 2, parallel=False)
    ck.save(_port(nps), step=10)
    ck.save(_port(drifted), step=20)
    return mgr


def test_shard_fallback_is_unit_consistent(small, tmp_path):
    model, nps, reg = small
    drifted = _map_np(_plus_one, nps)
    mgr = _two_events(model, reg, nps, tmp_path, drifted)
    unit = reg.unit_names()[0]
    victim = entry_refs(mgr.manifests.load(20).entries[unit]["weights"])[0]
    assert victim.step == 20
    mgr.store.object_path(victim.digest).unlink()
    restored = mgr.restore(_like(model), device=CPU)
    assert mgr.last_restore_stats["fallback_units"].get(
        f"{unit}/weights") == 10
    want, got = (_port(nps), restored)
    for (p, a), (_, b) in zip(
            flatten_with_paths(reg.extract_unit(want["params"], unit)),
            flatten_with_paths(reg.extract_unit(got["params"], unit))):
        assert torch.equal(a, b), p
    other = reg.unit_names()[1]
    for (p, a), (_, b) in zip(
            flatten_with_paths(reg.extract_unit(_port(drifted)["params"],
                                                other)),
            flatten_with_paths(reg.extract_unit(got["params"], other))):
        assert torch.equal(a, b), p
    mgr.close()


def test_shard_fallback_spans_dedup_steps(small, tmp_path):
    model, nps, reg = small
    unit = reg.unit_names()[0]
    u = reg.by_name[unit]
    drifted = dict(nps)
    params = jax.tree.map(np.array, nps["params"])

    def lower(x):
        x[x.shape[0] // 2:] = _plus_one(x[x.shape[0] // 2:])

    if u.index is None:
        jax.tree.map(lower, params[u.path[0]])
    else:
        jax.tree.map(lambda x: lower(x[u.index]), params[u.path[0]])
    drifted["params"] = params
    mgr = _two_events(model, reg, nps, tmp_path, drifted)
    by20 = {r.spec["participant"]: r for r in entry_refs(
        mgr.manifests.load(20).entries[unit]["weights"])}
    by10 = {r.spec["participant"]: r for r in entry_refs(
        mgr.manifests.load(10).entries[unit]["weights"])}
    assert by20[0].digest == by10[0].digest, "p0's shard dedups"
    assert by20[1].digest != by10[1].digest
    mgr.store.object_path(by20[1].digest).unlink()
    restored = mgr.restore(_like(model), device=CPU)
    for (p, a), (_, b) in zip(
            flatten_with_paths(reg.extract_unit(_port(nps)["params"], unit)),
            flatten_with_paths(reg.extract_unit(restored["params"], unit))):
        assert torch.equal(a, b), p
    assert mgr.last_restore_stats["fallback_units"].get(
        f"{unit}/weights") == 10
    mgr.close()


def test_shard_fallback_refuses_mixed_step_tensor(small, tmp_path):
    model, nps, reg = small
    mgr = _two_events(model, reg, nps, tmp_path, _map_np(_plus_one, nps))
    unit = reg.unit_names()[0]
    p20 = {r.spec["participant"]: r for r in entry_refs(
        mgr.manifests.load(20).entries[unit]["weights"])}
    p10 = {r.spec["participant"]: r for r in entry_refs(
        mgr.manifests.load(10).entries[unit]["weights"])}
    mgr.store.object_path(p20[1].digest).unlink()
    mgr.store.object_path(p10[0].digest).unlink()
    with pytest.raises(RestoreError, match="mixed-step"):
        mgr.restore(_like(model), device=CPU)
    mgr.close()


def test_sharded_save_over_legacy_manifest_forces_full(small, tmp_path):
    model, nps, reg = small
    state = _port(nps)
    mgr = _mgr(tmp_path, model, reg, "parity", async_save=False)
    ShardedCheckpointer(mgr, 2, parallel=False).save(state, step=10)
    m = mgr.manifests.load(10)
    unit = reg.unit_names()[0]
    legacy = {u: dict(k) for u, k in m.entries.items()}
    legacy[unit]["weights"] = ChunkRef(
        step=20, unit=unit, kind="weights", relpath="step-20/old.chunk",
        nbytes=0, digest="")
    mgr.manifests.commit(Manifest(step=20, entries=legacy, meta={}))
    mgr2 = _mgr(tmp_path, model, reg, "parity", async_save=False)
    m30 = ShardedCheckpointer(mgr2, 2, parallel=False).save(state, step=30)
    assert set(m30.saved_units) == set(reg.unit_names())
    assert all(r.digest for kinds in m30.entries.values()
               for e in kinds.values() for r in entry_refs(e))
    _assert_state_equal(state, mgr2.restore(_like(model), device=CPU,
                                            step=30))
    mgr2.close()
    mgr.close()


def test_merge_copies_shard_sets_atomically(small, tmp_path):
    model, nps, reg = small
    state = _port(nps)
    src = tmp_path / "src"
    mgr = _mgr(src, model, reg)
    ShardedCheckpointer(mgr, 2).save(state, step=10)
    recipe = Recipe(base=CheckpointRef(src, 10), output=tmp_path / "out",
                    select=[])
    stats = merge(recipe, workers=2, device="cpu",
                  stores={str(CheckpointRef(src, 10)): mgr.store})
    mgr.close()
    assert stats["chunks"] > len(reg.units)
    mgr2 = _mgr(tmp_path / "out", model, reg, async_save=False)
    m = mgr2.manifests.load()
    assert all(is_sharded(e) and all(r.spec for r in e)
               for kinds in m.entries.values() for e in kinds.values())
    _assert_state_equal(state, mgr2.restore(_like(model), device=CPU))
    mgr2.close()


def test_global_save_over_sharded_chain(small, tmp_path):
    """A global save over a shard set starts fresh global objects (no
    cross-layout dedup or delta) and restores."""
    model, nps, reg = small
    state = _port(nps)
    mgr = _mgr(tmp_path, model, reg)
    ShardedCheckpointer(mgr, 2).save(state, step=10)
    mgr.save(state, step=20)
    assert mgr.last_save_stats["dedup_hits"] == 0
    m = mgr.manifests.load()
    assert not any(is_sharded(e) for kinds in m.entries.values()
                   for e in kinds.values())
    _assert_state_equal(state, mgr.restore(_like(model), device=CPU))
    mgr.close()


def test_topk_delta_tie_break_is_deterministic():
    units = ([LayerUnit(name=f"block_{i:02d}", path=("blocks",), index=i)
              for i in range(6)]
             + [LayerUnit(name="embed", path=("embed",), kind="aux"),
                LayerUnit(name="final_norm", path=("norm",), kind="aux")])
    pol = make_policy("topk_delta", units, frac=0.5)
    blocks = pol.blocks
    ctx = PolicyContext(event_index=3, step=0,
                        drift_scores={b: 1.0 for b in blocks})
    ctx_r = PolicyContext(event_index=3, step=0,
                          drift_scores={b: 1.0 for b in reversed(blocks)})
    sel = [u for u in pol.select(ctx) if u.startswith("block")]
    sel_r = [u for u in pol.select(ctx_r) if u.startswith("block")]
    assert sel == sel_r == blocks[:3]
    scores = {b: (2.0 if i == 4 else 1.0) for i, b in enumerate(blocks)}
    sel = [u for u in pol.select(PolicyContext(0, 0, drift_scores=scores))
           if u.startswith("block")]
    assert sel == [blocks[4], blocks[0], blocks[1]]


# ------------------------------------------------------ crash matrix rows
SHARDED_POINTS = ("fingerprint", "gather", "object_write",
                  "participant_record", "barrier", "manifest_commit",
                  "manifest_latest")


@pytest.mark.parametrize("point", SHARDED_POINTS)
def test_crash_matrix_previous_manifest_stays_authoritative(small, tmp_path,
                                                            point):
    """``tests/test_resiliency.py``'s sharded rows: die at ``point`` in
    event 2 of two participants (every leaf drifted); a fresh manager on
    the root has step 10 as LATEST, restores it bit-exactly with no
    fallback, and again after a GC."""
    model, nps, reg = small
    mgr = _mgr(tmp_path, model, reg, fp_block_bytes=4096)
    saver = ShardedCheckpointer(mgr, 2)
    saver.save(_port(nps), step=10)

    def poke(x):
        x.flat[:1] = _plus_one(x.flat[:1])
        return x

    state2 = _map_np(poke, nps, parts=("params", "opt"))
    with faults.scoped(point):
        with pytest.raises((InjectedCrash, AsyncWriteError,
                            ShardBarrierError)):
            saver.save(_port(state2), step=20)
    assert not faults.pending()
    try:
        mgr.close()
    except (AsyncWriteError, InjectedCrash):
        pass
    mgr2 = _mgr(tmp_path, model, reg, async_save=False)
    assert mgr2.manifests.latest_step() == 10
    got = mgr2.restore(_like(model), device=CPU)
    assert int(got["step"]) == 10
    _assert_state_equal(_port(nps), got)
    assert not mgr2.last_restore_stats["fallback_units"]
    mgr2.gc()
    _assert_state_equal(_port(nps), mgr2.restore(_like(model), device=CPU))
    mgr2.close()
