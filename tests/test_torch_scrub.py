"""The port's store scrub (``repro_torch/checkpoint/scrub.py``) against the
JAX package's: every test of tests/test_scrub.py on the port (healthy
report, a byte flipped in any object kind in any tier repaired bit-exact or
quarantined with provenance, backfill of the deepest tier, re-derivation
from the canonical cache, block deltas, the quarantine's life, the audit
mode, ``scrub_root``), the sharded kind turned into the port's A4 error,
and three checks across packages: the same corruption scrubbed by each
gives equal reports, equal bytes in every tier and a byte-equal
``QUARANTINE.json``; each package's restore honours the other's quarantine;
``--scrub-on-start`` through the port's trainer.  Tables are checked on the
CPU (``device="cpu"``: the plain ``block_fp``).  Inputs come from numpy
seeds; the JAX side runs with ``zstandard`` (installed here) where it
writes zstd and without it where it writes the int8 codec.
"""
import contextlib
import dataclasses
import io
import json
import shutil
import sys
from pathlib import Path

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.checkpoint.workers as jax_workers
from proptest import cases
from repro.checkpoint import ChunkStore as JaxStore
from repro.checkpoint import StoreScrubber as JaxScrubber
from repro.checkpoint.saver import CheckpointManager as JaxManager
from repro.configs import get_config as jax_get_config
from repro.core import LayerRegistry as JaxRegistry
from repro.core.manifest import Manifest as JaxManifest
from repro.core.manifest import ManifestStore as JaxManifestStore
from repro.core.policies import make_policy as jax_make_policy
from repro.launch import steps as jax_steps
from repro.models import build_model as jax_build_model
from repro_torch.checkpoint import StoreScrubber, scrub_root, workers
from repro_torch.checkpoint.chunk_store import ChunkStore
from repro_torch.checkpoint.saver import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core.layer_registry import LayerRegistry
from repro_torch.core.manifest import Manifest, ManifestStore
from repro_torch.core.policies import make_policy
from repro_torch.kernels.quantize import quantize
from repro_torch.launch import steps
from repro_torch.launch import train as train_mod
from repro_torch.models import build_model

ARCH = "llama3.2-3b"
BB = 4096
BF16 = ml_dtypes.bfloat16
CPU = torch.device("cpu")
REMOTE_OPTS = {"latency": 0.0, "seed": 3}


# ------------------------------------------------------------------ sides
@pytest.fixture(scope="module")
def np_state():
    jmodel = jax_build_model(jax_get_config(ARCH, reduced=True))
    return jax.tree.map(np.asarray,
                        jax_steps.init_state(jmodel, jax.random.key(0)))


def _drift(np_state, unit_index=0, n=10):
    """A copy with the first elements of one stacked block's first weights
    leaf moved (block_000 by default)."""
    out = jax.tree.map(np.array, np_state)
    leaf = jax.tree_util.tree_leaves(out["params"]["blocks"])[0]
    flat = leaf[unit_index].reshape(-1)
    flat[:n] = (flat[:n].astype(np.float32) + 1).astype(flat.dtype)
    return out


def _port_model():
    model = build_model(get_config(ARCH, reduced=True))
    return model, LayerRegistry(model)


def _port_mgr(root, **kw):
    model, reg = _port_model()
    kw.setdefault("remote_opts", dict(REMOTE_OPTS))
    kw.setdefault("store_backend", "remote3")
    return model, reg, CheckpointManager(
        root, reg, make_policy("full", model.layer_units()),
        async_save=False, fp_block_bytes=BB, spill_barrier=True, **kw)


def _jax_mgr(root, **kw):
    jmodel = jax_build_model(jax_get_config(ARCH, reduced=True))
    kw.setdefault("remote_opts", dict(REMOTE_OPTS))
    kw.setdefault("store_backend", "remote3")
    return jmodel, JaxManager(
        root, JaxRegistry(jmodel),
        jax_make_policy("full", jmodel.layer_units()), async_save=False,
        fp_block_bytes=BB, spill_barrier=True, **kw)


def _items(arrays):
    return [(k, tuple(v.shape), str(v.dtype),
             np.ascontiguousarray(v).tobytes()) for k, v in arrays.items()]


def _synthetic_store(root):
    """A model-free store of the canonical kinds the port writes, one
    manifest: a full object (codec none), an XOR delta (XD01) on it, and a
    canonical int8 object (a second store on the same backend quantizes)."""
    store = ChunkStore(root, backend="remote3",
                       remote_opts=dict(REMOTE_OPTS))
    rs = np.random.RandomState(7)
    base = rs.standard_normal(4096).astype(np.float32)
    r_full = store.write(10, "x0", "weights", _items({"w": base}))
    cur = base.copy()
    cur[5] += 1.0
    r_delta = store.write(20, "x0", "weights", _items({"w": cur}),
                          prev_ref=r_full)
    assert r_delta.stored == "delta"
    w8 = rs.standard_normal(2048).astype(np.float32)
    q, s = quantize(torch.from_numpy(w8))
    rec = workers.Int8Record(q.numpy().tobytes() + s.numpy().tobytes(),
                             q.numel(), s.numel(), w8.shape, "float32")
    r_int8 = ChunkStore(root, codec="int8", backend=store.backend).write(
        20, "x1", "weights", _items({"w": w8}),
        full_items=[("w", w8.shape, "float32", rec)])
    ManifestStore(root).commit(Manifest(step=20, entries={
        "x0": {"weights": r_delta}, "x1": {"weights": r_int8}}))
    store.drain_spill()
    return store, {"full": r_full.digest, "delta": r_delta.digest,
                   "int8": r_int8.digest}


def _flip(tier, digest, off=None, bit=0xFF):
    blob = bytearray(tier.read(digest))
    blob[len(blob) // 2 if off is None else off] ^= bit
    tier.write(digest, bytes(blob))


def _scrub(store, **kw):
    return StoreScrubber(store, device="cpu").scrub(**kw)


# ------------------------------------------------------- tests/test_scrub
def test_scrub_healthy_store_reports_clean(tmp_path):
    store, kinds = _synthetic_store(tmp_path)
    report = _scrub(store)
    assert report["v"] == 1 and report["repair"]
    assert report["checked_objects"] == 3   # full, delta, int8
    assert report["healthy"] == report["checked_objects"]
    assert not report["repaired"] and not report["unrecoverable"]
    assert not report["demoted_manifests"]
    # every object was verified on both durable tiers
    assert report["checked_tiers"]["durable"] == report["checked_objects"]
    assert report["checked_tiers"]["remote"] == report["checked_objects"]
    store.close()


def test_canonical_int8_objects_are_healthy_in_the_port_only(tmp_path):
    """A lossy canonical object decodes to other tensors than its digest
    hashes: the port checks it by crc32 (as its restore does) and finds it
    healthy, where the JAX scrub, which hashes the dequantized payload,
    reports every such object unrecoverable (ROADMAP C3)."""
    store, kinds = _synthetic_store(tmp_path)
    store.close()
    store = ChunkStore(tmp_path, backend="remote3",
                       remote_opts=dict(REMOTE_OPTS))
    assert _scrub(store, repair=False)["healthy"] == 3
    store.close()
    jstore = JaxStore(tmp_path, backend="remote3",
                      remote_opts=dict(REMOTE_OPTS))
    jrep = JaxScrubber(jstore).scrub(repair=False)
    jstore.close()
    assert [r["digest"] for r in jrep["unrecoverable"]] == [kinds["int8"]]


def _fp_store(root, np_state):
    """A port manager's remote3 store: step 10 in full objects, step 20
    with block_000's weights as a BD02 block delta."""
    model, reg, mgr = _port_mgr(root)
    mgr.save(state_from_numpy(np_state, "cpu"), step=10)
    mgr.save(state_from_numpy(_drift(np_state), "cpu"), step=20)
    ref = mgr.manifests.load(20).entries["block_000"]["weights"]
    assert ref.stored == "delta"
    return mgr


def _jax_zstd_store(root):
    """A JAX remote3 store compressed with zstd, model-free: a full object
    and an XOR delta on it (XD01, zstd body)."""
    jax_workers.HAVE_ZSTD = True
    store = JaxStore(root, backend="remote3", codec="zstd",
                     remote_opts=dict(REMOTE_OPTS))
    rs = np.random.RandomState(11)
    base = {"w": rs.standard_normal(4096).astype(np.float32)}
    r_full = store.write(10, "z0", "weights", base)
    cur = {"w": base["w"].copy()}
    cur["w"][9] -= 1.0
    r_delta = store.write(20, "z0", "weights", cur, delta_base=r_full.digest)
    assert r_delta.stored == "delta"
    JaxManifestStore(root).commit(JaxManifest(step=20, entries={
        "z0": {"weights": r_delta}}))
    store.drain_spill()
    store.close()


# ------------------------------------------------ the core property test
@pytest.mark.parametrize("kinds", ["canonical", "fp", "jax_zstd"])
def test_scrub_flip_any_byte_any_kind_any_tier_property(tmp_path, np_state,
                                                        monkeypatch, kinds):
    """A byte flipped in any object kind the port reads (full, XD01 and
    canonical int8 written by the port; full and BD02 of its fp path; full
    and XD01 compressed with zstd, written by JAX) in any tier holding a
    copy is found and repaired bit-exact from a good tier; flipped in every
    tier at once, the object is re-derived from the canonical cache or
    quarantined with its manifests and units, never served."""
    monkeypatch.setattr(jax_workers, "HAVE_ZSTD", True)
    mgr = None
    if kinds == "canonical":
        store, _ = _synthetic_store(tmp_path)
    elif kinds == "fp":
        mgr = _fp_store(tmp_path, np_state)
        store = mgr.store
    else:
        _jax_zstd_store(tmp_path)
        store = ChunkStore(tmp_path, backend="remote3",
                           remote_opts=dict(REMOTE_OPTS))
    tiers = store.backend.tier_backends()
    # equal digests carry equal bytes in every tier
    pristine = {d: tier.read(d) for tier in tiers.values()
                for d in tier.keys()}
    sites = sorted((label, d) for label, tier in tiers.items()
                   for d in tier.keys())
    digests = sorted(pristine)
    prov = {}
    for step in ManifestStore(tmp_path).all_steps():
        for d, where in ManifestStore(tmp_path).load(step) \
                .digest_provenance().items():
            prov.setdefault(d, (set(), set()))
            prov[d][0].add(step)
            prov[d][1].update((u, k) for u, k, _ in where)

    def gen(rs):
        if rs.randint(3) == 0:      # every tier at once
            d = digests[rs.randint(len(digests))]
            return None, d, float(rs.rand())
        label, d = sites[rs.randint(len(sites))]
        return label, d, float(rs.rand())

    for label, digest, frac in cases(8, gen, seed=5 + len(kinds)):
        # the tiers holding a copy now (a read promotes into the hot tier)
        where = [label] if label else sorted(
            lbl for lbl, tier in tiers.items() if tier.has(digest))
        for lbl in where:
            _flip(tiers[lbl], digest, off=int(frac * len(pristine[digest])))
        report = _scrub(store)
        if label is not None:
            rec = {r["digest"]: r for r in report["repaired"]}[digest]
            assert rec["method"] == "replicate" and rec["repaired"]
            assert rec["bad_tiers"] == [label]
            assert rec["repaired_from"] != label
            assert not report["unrecoverable"], (label, digest)
            assert tiers[label].read(digest) == pristine[digest]
            continue
        fixed = {r["digest"]: r for r in report["repaired"]}
        if digest in fixed:
            assert fixed[digest]["method"] == "rederive"
            store.verify_object_blob(digest, tiers[where[0]].read(digest),
                                     "cpu")
        else:
            rec = {r["digest"]: r
                   for r in report["unrecoverable"]}[digest]
            assert rec["reason"] == "corrupt in every tier"
            assert sorted(rec["bad_tiers"]) == where
            assert set(rec["manifests"]) == prov[digest][0]
            assert {tuple(u) for u in rec["units"]} == prov[digest][1]
            assert store.quarantined(digest)
            for lbl in where:  # an operator puts the bytes back
                tiers[lbl].write(digest, pristine[digest])
            again = _scrub(store)
            assert again["released_from_quarantine"] == [digest]
            assert not store.quarantined(digest)
        for lbl in where:
            assert tiers[lbl].read(digest) == pristine[digest] \
                or digest in fixed
            tiers[lbl].write(digest, pristine[digest])
    if mgr is not None:
        mgr.close()
    else:
        store.close()


def test_scrub_backfills_missing_deepest_tier_copy(tmp_path):
    store, kinds = _synthetic_store(tmp_path)
    tiers = store.backend.tier_backends()
    victim = kinds["full"]
    assert tiers["remote"].delete(victim) > 0
    report = _scrub(store)
    rec = {r["digest"]: r for r in report["repaired"]}[victim]
    assert rec["method"] == "backfill"
    assert rec["bad_tiers"] == ["remote"]
    assert tiers["remote"].has(victim)
    assert not report["unrecoverable"]
    # a hot-tier (not the deepest) miss is eviction: nothing to repair
    assert tiers["hot"].delete(kinds["delta"]) > 0
    report2 = _scrub(store)
    assert not report2["repaired"] and not report2["unrecoverable"]
    store.close()


def test_scrub_rederives_from_canonical_cache(tmp_path):
    store, kinds = _synthetic_store(tmp_path)
    tiers = store.backend.tier_backends()
    victim = kinds["full"]
    for label, tier in tiers.items():
        if tier.has(victim):
            _flip(tier, victim)
    report = _scrub(store)
    rec = {r["digest"]: r for r in report["repaired"]}[victim]
    assert rec["method"] == "rederive"
    assert rec["repaired_from"] == "canonical-cache"
    assert not report["unrecoverable"]
    # the rebuilt envelope verifies against the digest in every tier
    for tier in tiers.values():
        store.verify_object_blob(victim, tier.read(victim), "cpu")
    store.close()


def test_scrub_repairs_corrupt_block_delta_object(tmp_path, np_state):
    mgr = _fp_store(tmp_path, np_state)
    victim = mgr.manifests.load(20).entries["block_000"]["weights"].digest
    tiers = mgr.store.backend.tier_backends()
    good = tiers["durable"].read(victim)
    _flip(tiers["durable"], victim)
    report = mgr.scrub(device="cpu")
    rec = {r["digest"]: r for r in report["repaired"]}[victim]
    assert rec["method"] == "replicate" and "durable" in rec["bad_tiers"]
    assert tiers["durable"].read(victim) == good
    model, reg = _port_model()
    restored = mgr.restore(steps.state_specs(model), device=CPU)
    stats = mgr.last_restore_stats
    assert not stats["fallback_units"] and not stats["quarantined_skipped"]
    want = state_from_numpy(_drift(np_state), "cpu")
    exp = reg.extract_unit(want["params"], "block_000")
    got = reg.extract_unit(restored["params"], "block_000")
    _assert_trees_equal(got, exp)
    mgr.close()


def _assert_trees_equal(a, b):
    fa = jax.tree_util.tree_leaves(state_to_numpy(a, bf16_dtype=BF16))
    fb = jax.tree_util.tree_leaves(state_to_numpy(b, bf16_dtype=BF16))
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


# --------------------------------------- unrecoverable: quarantine, honesty
def test_unrecoverable_quarantines_demotes_and_never_serves(tmp_path,
                                                            np_state):
    mgr = _fp_store(tmp_path, np_state)
    victim = mgr.manifests.load(20).entries["block_000"]["weights"].digest
    mgr.close()
    # restart: canonical cache cold, hot tier empty -> no re-derivation
    model, reg, mgr2 = _port_mgr(tmp_path)
    tiers = mgr2.store.backend.tier_backends()
    good = {}
    for label in ("durable", "remote"):
        good[label] = tiers[label].read(victim)
        _flip(tiers[label], victim)
    report = mgr2.scrub(device="cpu")
    rec = {r["digest"]: r for r in report["unrecoverable"]}[victim]
    assert rec["reason"] == "corrupt in every tier"
    assert 20 in rec["manifests"]
    assert ["block_000", "weights"] in rec["units"]
    assert 20 in report["demoted_manifests"]
    assert mgr2.store.quarantined(victim)
    assert mgr2.store.quarantine_path.is_file()
    # the planner skips the quarantined digest: block_000 falls back to
    # step 10, every other unit restores at step 20
    restored = mgr2.restore(steps.state_specs(model), device=CPU)
    assert mgr2.last_restore_stats["quarantined_skipped"] >= 1
    s10 = state_from_numpy(np_state, "cpu")
    s20 = state_from_numpy(_drift(np_state), "cpu")
    _assert_trees_equal(reg.extract_unit(restored["params"], "block_000"),
                        reg.extract_unit(s10["params"], "block_000"))
    other = next(u.name for u in model.layer_units()
                 if u.name != "block_000")
    _assert_trees_equal(reg.extract_unit(restored["params"], other),
                        reg.extract_unit(s20["params"], other))
    # the bytes put back: the next scrub releases the quarantine
    tiers["durable"].write(victim, good["durable"])
    report2 = mgr2.scrub(device="cpu")
    assert victim in report2["released_from_quarantine"]
    assert not mgr2.store.quarantined(victim)
    assert report2["quarantined"] == 0
    assert not report2["unrecoverable"]
    rec2 = {r["digest"]: r for r in report2["repaired"]}[victim]
    assert rec2["method"] == "replicate" and "remote" in rec2["bad_tiers"]
    assert not mgr2.store.quarantine_path.exists()
    mgr2.close()


def test_quarantine_survives_restart_and_blocks_planning(tmp_path):
    store, kinds = _synthetic_store(tmp_path)
    store.close()
    store1 = ChunkStore(tmp_path, backend="remote3",
                        remote_opts=dict(REMOTE_OPTS))
    tiers = store1.backend.tier_backends()
    victim = kinds["int8"]
    for label in ("durable", "remote"):
        _flip(tiers[label], victim, off=0)
    report = _scrub(store1)
    assert [r["digest"] for r in report["unrecoverable"]] == [victim]
    store1.close()
    store2 = ChunkStore(tmp_path, backend="remote3",
                        remote_opts=dict(REMOTE_OPTS))
    assert store2.quarantined(victim)
    assert not store2.quarantined(kinds["full"])
    store2.close()
    # a mangled file reads as an empty quarantine
    (tmp_path / "QUARANTINE.json").write_bytes(b"{not json")
    store3 = ChunkStore(tmp_path)
    assert store3.quarantine() == {}
    store3.close()


def test_audit_mode_reports_without_touching_bytes(tmp_path):
    store, kinds = _synthetic_store(tmp_path)
    tiers = store.backend.tier_backends()
    victim = kinds["delta"]
    _flip(tiers["durable"], victim, off=3)
    corrupt = tiers["durable"].read(victim)
    report = _scrub(store, repair=False)
    rec = {r["digest"]: r for r in report["repaired"]}[victim]
    assert rec["repaired"] is False and not report["repair"]
    assert tiers["durable"].read(victim) == corrupt
    assert not store.quarantine_path.is_file()
    store.close()


def test_scrub_root_offline_entry(tmp_path):
    store, kinds = _synthetic_store(tmp_path)
    tiers = store.backend.tier_backends()
    _flip(tiers["durable"], kinds["full"], off=-1)
    store.close()
    report = scrub_root(tmp_path, backend="remote3",
                        remote_opts=dict(REMOTE_OPTS), device="cpu")
    assert {r["digest"] for r in report["repaired"]} >= {kinds["full"]}
    assert not report["unrecoverable"]
    # the card by default: without one, scrub_root raises
    if not torch.cuda.is_available():
        with pytest.raises(Exception):
            scrub_root(tmp_path, backend="remote3",
                       remote_opts=dict(REMOTE_OPTS))


def test_sharded_entry_raises_the_a4_error_before_any_write(tmp_path):
    """JAX's sharded kind (``tests/test_scrub.py``'s synthetic store: a
    full object, an XOR delta on it and a shard set of two spec-carrying
    refs), copied twice with one shard object flipped in the durable
    tier: the port's scrub gives JAX's report but ``elapsed_s`` (four
    objects checked, two of them shards, the flip repaired from a good
    copy) and leaves equal bytes in every tier."""
    src = tmp_path / "src"
    store = JaxStore(src, backend="remote3", remote_opts=dict(REMOTE_OPTS))
    rs = np.random.RandomState(3)
    base = {"w": rs.standard_normal(4096).astype(np.float32)}
    r_full = store.write(10, "x0", "weights", base)
    cur = {"w": base["w"].copy()}
    cur["w"][5] += 1.0
    r_delta = store.write(20, "x0", "weights", cur,
                          delta_base=r_full.digest)
    refs = tuple(dataclasses.replace(
        store.write(20, "xs", "weights",
                    {"w": rs.standard_normal(256).astype(np.float32)}),
        spec={"participant": i}) for i in range(2))
    JaxManifestStore(src).commit(JaxManifest(step=20, entries={
        "x0": {"weights": r_delta}, "xs": {"weights": refs}}))
    store.drain_spill()
    store.close()
    reports = {}
    for pkg in ("jax", "port"):
        root = tmp_path / pkg
        shutil.copytree(src, root)
        st = (JaxStore(root, backend="remote3", remote_opts=dict(REMOTE_OPTS))
              if pkg == "jax" else
              ChunkStore(root, backend="remote3",
                         remote_opts=dict(REMOTE_OPTS)))
        _flip(st.backend.tier_backends()["durable"], refs[0].digest)
        rep = (JaxScrubber(st).scrub() if pkg == "jax"
               else StoreScrubber(st, device="cpu").scrub())
        st.close()
        rep.pop("elapsed_s")
        reports[pkg] = rep
    assert reports["port"] == reports["jax"]
    rep = reports["port"]
    assert rep["checked_objects"] == 4 and not rep["unrecoverable"]
    assert [r["digest"] for r in rep["repaired"]] == [refs[0].digest]
    assert _tier_files(tmp_path / "port") == _tier_files(tmp_path / "jax")


def _tier_files(root):
    """Every object file of the disk tiers (objects/, remote/) and the
    quarantine, by path."""
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(Path(root).rglob("*")) if p.is_file()
            and (p.parts[-3] in ("objects", "remote")
                 or p.name == "QUARANTINE.json")}


def test_scrub_parity_with_jax(tmp_path, np_state, monkeypatch):
    """One JAX-written store (remote3, zstd: full fp objects, BD02 deltas)
    copied twice and corrupted alike (a durable copy flipped, an object
    flipped in every tier, a bucket copy gone): JAX's scrub of one copy and
    the port's of the other give equal reports but ``elapsed_s``, equal
    bytes in every tier and a byte-equal ``QUARANTINE.json``; the audit
    before it agrees too."""
    monkeypatch.setattr(jax_workers, "HAVE_ZSTD", True)
    src = tmp_path / "src"
    _, jm = _jax_mgr(src, codec="zstd")
    jm.save(np_state, step=10)
    jm.save(_drift(np_state), step=20)
    m20 = jm.manifests.load(20)
    jm.close()
    d_bd = m20.entries["block_000"]["weights"].digest
    d_full = m20.entries["embed"]["weights"].digest
    d_gone = m20.entries["final_norm"]["weights"].digest
    reports = {}
    for pkg in ("jax", "port"):
        root = tmp_path / pkg
        shutil.copytree(src, root)
        store = (JaxStore(root, backend="remote3",
                          remote_opts=dict(REMOTE_OPTS)) if pkg == "jax"
                 else ChunkStore(root, backend="remote3",
                                 remote_opts=dict(REMOTE_OPTS)))
        tiers = store.backend.tier_backends()
        _flip(tiers["durable"], d_full)
        for label in ("durable", "remote"):
            _flip(tiers[label], d_bd)
        tiers["remote"].delete(d_gone)
        scrub = (JaxScrubber(store).scrub if pkg == "jax"
                 else StoreScrubber(store, device="cpu").scrub)
        audit = scrub(repair=False)
        rep = scrub()
        store.close()
        for r in (audit, rep):
            r.pop("elapsed_s")
        reports[pkg] = (audit, rep)
    assert reports["port"] == reports["jax"]
    audit, rep = reports["port"]
    assert {r["method"] for r in rep["repaired"]} == {"replicate",
                                                      "backfill"}
    assert [r["digest"] for r in rep["unrecoverable"]] == [d_bd]
    assert _tier_files(tmp_path / "port") == _tier_files(tmp_path / "jax")
    assert (tmp_path / "port" / "QUARANTINE.json").read_bytes() == \
        (tmp_path / "jax" / "QUARANTINE.json").read_bytes()


@pytest.mark.parametrize("scrubber", ["jax", "port"])
def test_each_restore_honours_the_other_packages_quarantine(tmp_path,
                                                            np_state,
                                                            scrubber):
    """A quarantine either package's scrub wrote is honoured by the other
    package's restore planner: the quarantined block delta is skipped and
    its unit restores from the older object, equal in both packages."""
    _, jm = _jax_mgr(tmp_path, codec="none", store_backend="local")
    jm.save(np_state, step=10)
    jm.save(_drift(np_state), step=20)
    victim = jm.manifests.load(20).entries["block_000"]["weights"]
    jm.close()
    assert victim.stored == "delta"
    path = tmp_path / victim.relpath
    blob = bytearray(path.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    path.write_bytes(bytes(blob))
    if scrubber == "jax":
        jstore = JaxStore(tmp_path)
        rep = JaxScrubber(jstore).scrub()
        jstore.close()
    else:
        rep = scrub_root(tmp_path, device="cpu")
    assert [r["digest"] for r in rep["unrecoverable"]] == [victim.digest]
    model, reg, pm = _port_mgr(tmp_path, store_backend="local")
    got = pm.restore(steps.state_specs(model), device=CPU)
    stats = pm.last_restore_stats
    pm.close()
    jmodel, jm = _jax_mgr(tmp_path, store_backend="local")
    want = jm.restore(jax_steps.state_specs(jmodel))
    jstats = jm.last_restore_stats
    jm.close()
    # planned around, never read: no candidate failed at read time
    assert stats["quarantined_skipped"] == jstats["quarantined_skipped"] == 1
    assert stats["fallback_units"] == jstats["fallback_units"] == \
        {"block_000/weights": 10}
    want = jax.tree.map(np.asarray, {"params": want["params"],
                                     "opt": want["opt"]})
    got = state_to_numpy({"params": got["params"], "opt": got["opt"]},
                         bf16_dtype=BF16)
    fa = jax.tree_util.tree_leaves(got)
    fb = jax.tree_util.tree_leaves(want)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    # block_000 is step 10's: the drift is gone
    first = jax.tree_util.tree_leaves(got["params"]["blocks"])[0][0]
    assert first.tobytes() == jax.tree_util.tree_leaves(
        np_state["params"]["blocks"])[0][0].tobytes()


def test_scrub_on_start_flag_through_the_port_trainer(tmp_path,
                                                      monkeypatch):
    """``--scrub-on-start`` on the CPU: a LATEST object whose unit an older
    manifest holds under another digest, flipped under a recomputed crc32
    (so only its table check catches it), is reported unrecoverable with
    its manifests and units, quarantined, and skipped by the resume, which
    serves the older object."""
    ckpt = tmp_path / "ckpt"
    kw = dict(arch="yi-9b", reduced=True, batch=2, seq_len=16,
              policy_name="parity", ckpt_interval=2, ckpt_dir=str(ckpt),
              ckpt_async=False, device="cpu", num_layers=2)
    train_mod.train(total_steps=6, **kw)
    ms = ManifestStore(ckpt)
    m6 = ms.load(6)
    older = {(u, k): r.digest for s in ms.all_steps() if s < 6
             for u, kinds in ms.load(s).entries.items()
             for k, r in kinds.items()}
    unit, kind = next((u, k) for u, kinds in sorted(m6.entries.items())
                      for k, r in sorted(kinds.items())
                      if r.stored == "full" and (u, k) in older
                      and older[(u, k)] != r.digest and r.step == 6)
    victim = m6.entries[unit][kind]
    _flip_under_crc(ckpt / victim.relpath, victim.digest)
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", "yi-9b", "--num-layers", "2", "--steps", "7",
        "--batch", "2", "--seq-len", "16", "--policy", "parity",
        "--ckpt-interval", "2", "--ckpt-dir", str(ckpt), "--sync-save",
        "--device", "cpu", "--resume", "--scrub-on-start"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_mod.main()
    res = json.loads(out.getvalue())
    rep = res["scrub_report"]
    rec = {r["digest"]: r for r in rep["unrecoverable"]}[victim.digest]
    assert rec["reason"] == "corrupt in every tier"
    assert [unit, kind] in rec["units"] and 6 in rec["manifests"]
    assert (ckpt / "QUARANTINE.json").is_file()
    stats = res["restore_stats"]
    assert stats["quarantined_skipped"] >= 1
    # the unit was planned around (its older object), never read corrupt
    assert stats["fallback_units"] == {f"{unit}/{kind}": 4} \
        or stats["fallback_units"] == {f"{unit}/{kind}": 2}
    assert res["steps"] == 1


def _flip_under_crc(path, digest):
    """Flip a payload byte of the first tensor record of a full object and
    recompute its crc32: the record decodes cleanly, only the table check
    on the device catches it."""
    import msgpack
    import zlib
    env = workers.parse_envelope(path.read_bytes(), digest)
    payload = msgpack.unpackb(bytes(env["payload"]), raw=False)
    t = payload["tensors"][0]
    data = bytearray(t["data"])
    data[len(data) // 2] ^= 0x01
    t["data"] = bytes(data)
    t["crc"] = zlib.crc32(t["data"]) & 0xFFFFFFFF
    env = {k: (bytes(v) if isinstance(v, memoryview) else v)
           for k, v in env.items()}
    env["payload"] = msgpack.packb(payload, use_bin_type=True)
    path.write_bytes(msgpack.packb(env, use_bin_type=True))
