"""The port's explicit merge (``repro_torch.core.{yamlish,recipe,tailor}``)
against the JAX package's.

Both packages get the same train state: JAX-initialized, converted to the
port through numpy, and drifted in a few elements of one block by a numpy
``RandomState`` (so later events write block-sparse deltas whose full
bases the merge must bring along).  Stores use 4 KiB fingerprint blocks;
the JAX side writes ``codec="none"`` (or int8 with
``repro.checkpoint.workers.HAVE_ZSTD`` patched off, as
tests/test_torch_int8.py does).  Manifests, objects and restored tensors
are byte data, so every comparison of them is exact; the trainers resumed
from one merged root are held to 5e-3 of each other (the port's
train-step tolerance against JAX, tests/test_torch_int8.py).
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.checkpoint.workers as jax_workers
from repro.checkpoint.saver import CheckpointManager as JaxManager
from repro.checkpoint.serial import ChunkCorruption as JaxChunkCorruption
from repro.configs import get_config as jax_get_config
from repro.core import LayerRegistry as JaxRegistry
from repro.core import yamlish as jax_yamlish
from repro.core.policies import make_policy as jax_make_policy
from repro.core.recipe import CheckpointRef as JaxCheckpointRef
from repro.core.recipe import Recipe as JaxRecipe
from repro.core.recipe import expand_patterns as jax_expand_patterns
from repro.core.tailor import merge as jax_merge
from repro.launch import steps as jax_steps
from repro.launch.train import SimulatedFailure as JaxSimulatedFailure
from repro.launch.train import train as jax_train
from repro.models import build_model as jax_build_model
from repro_torch.checkpoint import _msgpack, workers
from repro_torch.checkpoint.chunk_store import ChunkRef, ChunkStore
from repro_torch.checkpoint.saver import CheckpointManager
from repro_torch.checkpoint.serial import ChunkCorruption
from repro_torch.configs import get_config
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import CheckpointRef, Recipe, SelectRule, merge
from repro_torch.core import tailor, yamlish
from repro_torch.core.layer_registry import LayerRegistry
from repro_torch.core.manifest import (Manifest, ManifestStore, entry_refs,
                                       is_sharded)
from repro_torch.core.policies import make_policy
from repro_torch.core.recipe import expand_patterns
from repro_torch.launch import steps
from repro_torch.launch.train import train
from repro_torch.models import build_model

# The suite runs in several worker processes at once: one intra-op
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

ARCH = "yi-9b"
BB = 4096
CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parent.parent
UNITS = ["embed", "block_000", "block_001", "block_002", "block_003",
         "final_norm", "lm_head"]


# ------------------------------------------------------------------ yamlish
# The recipes of tests/test_core_llmtailor.py's yamlish tests, and one of
# each recipe shape the merge takes.
RECIPES = [
    """
# a recipe
base: /ckpt/a@1000
output: /out/dir
optimizer: true
select:
  - units: block_000..block_003
    from: /ckpt/b@900
  - units: [embed, lm_head]
    from: /ckpt/b@900
""",
    "a: 3\nb: 3.5\nc: null\nd: 'x y'\ne: false",
    """
base: /ckpt/a   # LATEST
output: "/out/with space"
optimizer: false
select:
  - units:
      - block_*
      - final_norm
    from: /ckpt/c@7
""",
    "select: []\nbase: r@1\noutput: o\nmeta: {k: 1, j: two}\n",
]


@pytest.mark.parametrize("text", RECIPES)
def test_yamlish_reads_and_writes_the_recipe_corpus_as_jax(text):
    got = yamlish.loads(text)
    assert got == jax_yamlish.loads(text)
    assert yamlish.dumps(got) == jax_yamlish.dumps(got)
    assert yamlish.loads(yamlish.dumps(got)) == got


# The grammar the module documents: nested mappings, block lists, scalars
# (int, float, bool, null, quoted and bare strings); keys are bare names.
_KEYS = st.from_regex(r"[a-z_][a-z0-9_]{0,7}", fullmatch=True)
_SCALARS = (st.none() | st.booleans() | st.integers(-10**9, 10**9)
            | st.floats(allow_nan=False, allow_infinity=False, width=32)
            | st.text("abcxyz019 _./@-:#[]{},'", max_size=12))
_TREES = st.recursive(
    _SCALARS,
    lambda inner: (st.lists(inner, max_size=4)
                   | st.dictionaries(_KEYS, inner, min_size=1, max_size=4)),
    max_leaves=16)


@settings(max_examples=150, deadline=None, derandomize=True,
          database=None)
@given(st.dictionaries(_KEYS, _TREES, min_size=1, max_size=5))
def test_yamlish_agrees_with_jax_on_drawn_documents(doc):
    text = jax_yamlish.dumps(doc)
    assert yamlish.dumps(doc) == text
    try:
        want = jax_yamlish.loads(text)
    except Exception as e:  # noqa: BLE001 - the port must fail alike
        with pytest.raises(type(e)) as got:
            yamlish.loads(text)
        assert str(got.value) == str(e)
        return
    assert yamlish.loads(text) == want


# ------------------------------------------------------------------- recipe
@pytest.mark.parametrize("patterns", [
    ["block_000..block_002", "embed"],
    ["block_001..block_003"],
    ["block_02..block_03"],          # other width: no unit has it
    ["block_*"], ["*"], ["final_*", "lm_head"],
    ["lm_head", "block_003..block_001"],
    [],
])
def test_expand_patterns_agrees_with_jax(patterns):
    assert expand_patterns(patterns, UNITS) == \
        jax_expand_patterns(patterns, UNITS)


@pytest.mark.parametrize("patterns", [["nope"], ["embed", "block_9"]])
def test_unknown_units_raise_key_error_in_both(patterns):
    with pytest.raises(KeyError):
        jax_expand_patterns(patterns, UNITS)
    with pytest.raises(KeyError, match="unknown unit"):
        expand_patterns(patterns, UNITS)


@pytest.mark.parametrize("ref", ["/a/b@12", "/a/b", "rel@dir@3", "x@0"])
def test_checkpoint_ref_parses_as_jax(ref):
    got, want = CheckpointRef.parse(ref), JaxCheckpointRef.parse(ref)
    assert (got.root, got.step, str(got)) == (want.root, want.step,
                                              str(want))


@pytest.mark.parametrize("suffix", [".yaml", ".json"])
def test_recipe_load_and_assignment_agree_with_jax(tmp_path, suffix):
    d = {"base": "/ck@6", "output": "/out", "optimizer": False,
         "select": [{"units": "block_000..block_002", "from": "/ck@2"},
                    {"units": ["block_001", "embed"], "from": "/other"}]}
    path = tmp_path / f"r{suffix}"
    if suffix == ".json":
        path.write_text(json.dumps(d))
    else:
        path.write_text(yamlish.dumps(d))
    got, want = Recipe.load(path), JaxRecipe.load(path)
    assert (str(got.base), got.output, got.optimizer) == \
        (str(want.base), want.output, want.optimizer)
    ga, wa = got.assignment(UNITS), want.assignment(UNITS)
    assert {u: str(r) for u, r in ga.items()} == \
        {u: str(r) for u, r in wa.items()}
    # later rules win
    assert str(ga["block_001"]) == "/other" and str(ga["block_000"]) == "/ck@2"
    assert SelectRule(units=["block_*"], source=got.base).expand(UNITS) == \
        [u for u in UNITS if u.startswith("block_")]


# ---------------------------------------------------------------- manifests
def test_manifest_entries_are_single_refs_and_shard_sets_raise(tmp_path,
                                                              no_zstd):
    """A shard set (a list of refs, each with its spec) reads as a tuple
    of refs and writes back byte for byte; a store JAX's sharded
    checkpointer wrote (two participants, a full and a delta event) merges
    in the port byte-identically to JAX's merge of it, each shard set
    whole with its specs, and the merged root restores to the state."""
    from repro.checkpoint.sharded import ShardedCheckpointer as JaxSharded

    ms = ManifestStore(tmp_path / "m")
    assert not is_sharded(object()) and is_sharded(())
    assert entry_refs("r") == ("r",) and entry_refs(["a", "b"]) == ("a", "b")
    ref = {"step": 1, "unit": "embed", "kind": "weights",
           "relpath": "objects/ab/ab.chunk", "nbytes": 1, "digest": "ab",
           "stored": "full", "delta_base": None,
           "spec": {"participant": 0, "leaves": [
               {"path": "w", "shape": [4, 2], "dtype": "bfloat16",
                "blocks": [[[0, 4], [0, 2]]]}]}}
    blob = Manifest(step=1, entries={"embed": {"weights": (
        ChunkRef.from_json(ref),)}}).to_json()
    ms.path(1).write_bytes(blob)
    got = ms.load(1).entries["embed"]["weights"]
    assert is_sharded(got) and got[0].spec == ref["spec"]
    assert ms.load(1).to_json() == blob
    assert "spec" not in ChunkRef.from_json(
        {k: v for k, v in ref.items() if k != "spec"}).to_json()

    src = tmp_path / "src"
    jmodel, jreg = _jax_side()
    mgr = JaxManager(src, jreg, jax_make_policy("parity",
                                                jmodel.layer_units()),
                     codec="none", async_save=False, fp_block_bytes=BB)
    states = _states()
    for step, st in zip((2, 4), states):
        JaxSharded(mgr, 2).save(st, step=step)
    mgr.close()
    recipes = {}
    for pkg in ("jax", "port"):
        recipes[pkg] = tmp_path / f"recipe_{pkg}.yaml"
        recipes[pkg].write_text(
            f"base: {src}@4\noutput: {tmp_path / f'merged_{pkg}'}\n"
            f"select:\n  - units: block_000\n    from: {src}@2\n")
    want = jax_merge(JaxRecipe.load(recipes["jax"]), workers=2)
    got = merge(Recipe.load(recipes["port"]), workers=2, device="cpu")
    assert _tree_bytes(tmp_path / "merged_port") == \
        _tree_bytes(tmp_path / "merged_jax")
    assert got["chunks"] == want["chunks"] > 2 * len(UNITS)
    m = ManifestStore(tmp_path / "merged_port").load()
    assert all(is_sharded(e) and all(r.spec for r in e)
               for kinds in m.entries.values() for e in kinds.values())
    model, reg = _port_side()
    pm = CheckpointManager(tmp_path / "merged_port", reg,
                           make_policy("full", model.layer_units()),
                           async_save=False)
    restored = state_to_numpy(pm.restore(steps.state_specs(model),
                                         device=CPU), ml_dtypes.bfloat16)
    pm.close()
    for part in ("params", "opt"):
        for (_, a), (_, b) in zip(
                _flat_np(restored[part]), _flat_np(states[1][part])):
            np.testing.assert_array_equal(a, b)


def _flat_np(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flat_np(tree[k], f"{prefix}{k}/")]
    return [(prefix, np.asarray(tree))]


# -------------------------------------------------------------------- stores
def _jax_side():
    model = jax_build_model(jax_get_config(ARCH, reduced=True))
    return model, JaxRegistry(model)


def _port_side():
    model = build_model(get_config(ARCH, reduced=True))
    return model, LayerRegistry(model)


def _states(seed=0):
    """Three numpy train states: JAX's init, then two drifts of a few
    elements of block_001 (weights, master and m) drawn by a numpy seed."""
    jmodel, _ = _jax_side()
    s0 = jax.tree.map(np.asarray,
                      jax_steps.init_state(jmodel, jax.random.key(seed)))
    rng = np.random.RandomState(seed + 1)
    out = [s0]
    for _ in range(2):
        s = jax.tree.map(np.array, out[-1])
        for tree in (s["params"], s["opt"]["master"], s["opt"]["m"]):
            w = tree["blocks"]["mlp"]["w_gate"]
            w[1, 0, :5] = (w[1, 0, :5].astype(np.float32)
                           + rng.rand(5).astype(np.float32)).astype(w.dtype)
        out.append(s)
    return out


def _write_store(root, writer, codec="none", policy="parity"):
    """Events at steps 2, 4, 6 of the three states, saved by ``writer``.
    Parity: step 2 saves every unit, 4 the odd blocks and embed (block_001
    as a block delta against step 2), 6 the even blocks and lm_head."""
    states = _states()
    if writer == "jax":
        jmodel, jreg = _jax_side()
        mgr = JaxManager(root, jreg,
                         jax_make_policy(policy, jmodel.layer_units()),
                         codec=codec, async_save=False, fp_block_bytes=BB)
        for step, s in zip((2, 4, 6), states):
            mgr.save(s, step=step)
    else:
        model, reg = _port_side()
        mgr = CheckpointManager(root, reg,
                                make_policy(policy, model.layer_units()),
                                codec=codec, async_save=False,
                                fp_block_bytes=BB)
        for step, s in zip((2, 4, 6), states):
            mgr.save(state_from_numpy(s, "cpu"), step=step)
    mgr.close()
    return states


def _recipe_text(src, out, optimizer=True):
    return (f"base: {src}@6\noutput: {out}\n"
            f"optimizer: {'true' if optimizer else 'false'}\n"
            f"select:\n"
            f"  - units: block_001\n    from: {src}@4\n"
            f"  - units: [embed, final_norm]\n    from: {src}@2\n")


def _recipes(tmp_path, src, optimizer=True):
    """The same recipe for each package, differing only in ``output``."""
    out = {}
    for pkg in ("jax", "port"):
        p = tmp_path / f"recipe_{pkg}.yaml"
        p.write_text(_recipe_text(src, tmp_path / f"merged_{pkg}",
                                  optimizer))
        out[pkg] = p
    return out


def _tree_bytes(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(Path(root).rglob("*")) if p.is_file()}


def _objects(root):
    return {p.name: p.read_bytes()
            for p in sorted((Path(root) / "objects").glob("*/*.chunk"))}


@pytest.fixture
def no_zstd(monkeypatch):
    monkeypatch.setattr(jax_workers, "HAVE_ZSTD", False)


CASES = {
    "lossless_w1": dict(codec="none", optimizer=True, workers=1),
    "lossless_w4": dict(codec="none", optimizer=True, workers=4),
    "weights_only": dict(codec="none", optimizer=False, workers=2),
    "int8": dict(codec="int8", optimizer=True, workers=2),
}


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_merge_is_byte_identical_to_jax(tmp_path, no_zstd, writer, case):
    """One recipe merged by each package from a store either package wrote
    gives byte-identical manifests, LATEST and object files, and the same
    stats."""
    c = CASES[case]
    src = tmp_path / "src"
    _write_store(src, writer, codec=c["codec"])
    recipes = _recipes(tmp_path, src, c["optimizer"])
    want = jax_merge(JaxRecipe.load(recipes["jax"]), workers=c["workers"])
    got = merge(Recipe.load(recipes["port"]), workers=c["workers"],
                device="cpu")
    assert _tree_bytes(tmp_path / "merged_port") == \
        _tree_bytes(tmp_path / "merged_jax")
    keys = ["units", "bytes", "chunks", "sources"]
    if c["workers"] == 1:        # who copies a shared base is a race above
        keys.append("shared_chunks")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["verify_seconds"] >= 0 and got["seconds"] > 0
    m = ManifestStore(tmp_path / "merged_port").load()
    assert m.step == 6 and m.saved_units == sorted(m.entries)
    assert m.meta["merged_from"]["block_001"] == f"{src}@4"
    kinds = {k for e in m.entries.values() for k in e}
    assert kinds == ({"weights", "opt"} if c["optimizer"] else {"weights"})
    out = ChunkStore(tmp_path / "merged_port")
    fmts = {out.read_envelope(d)["format"] for d in out.iter_digests()}
    if c["codec"] == "none":
        # block_001's step-4 objects are block deltas; their bases followed
        delta = m.entries["block_001"]["weights"]
        assert delta.stored == "delta" and out.has(delta.delta_base)
        assert fmts == {"full", "block_delta"}
    else:
        assert fmts == {"full"}


@pytest.mark.parametrize("merger", ["port", "jax"])
def test_merged_root_restores_bit_exactly_in_the_other_package(tmp_path,
                                                               merger):
    """The port's merge restores in JAX, and JAX's in the port, to the
    units the recipe named: block_001 from step 4, embed and final_norm
    from step 2, the rest from step 6."""
    src = tmp_path / "src"
    s2, s4, s6 = _write_store(src, "port" if merger == "jax" else "jax")
    recipes = _recipes(tmp_path, src)
    if merger == "jax":
        jax_merge(JaxRecipe.load(recipes["jax"]), workers=2)
        root = tmp_path / "merged_jax"
        model, reg = _port_side()
        mgr = CheckpointManager(root, reg, make_policy("full",
                                                       model.layer_units()),
                                async_save=False, fp_block_bytes=BB)
        got = mgr.restore(steps.state_specs(model), device=CPU)
        got = state_to_numpy({"params": got["params"], "opt": got["opt"]},
                             bf16_dtype=ml_dtypes.bfloat16)
    else:
        merge(Recipe.load(recipes["port"]), workers=2, device="cpu")
        root = tmp_path / "merged_port"
        jmodel, jreg = _jax_side()
        mgr = JaxManager(root, jreg, jax_make_policy(
            "full", jmodel.layer_units()), codec="none", async_save=False,
            fp_block_bytes=BB)
        got = jax.tree.map(np.asarray,
                           mgr.restore(jax_steps.state_specs(jmodel)))
    mgr.close()
    _, jreg = _jax_side()
    source = {"block_001": s4, "embed": s2, "final_norm": s2}
    for unit in UNITS:
        want = source.get(unit, s6)
        for extract, part in ((jreg.extract_unit, "params"),
                              (jreg.extract_opt_unit, "opt")):
            a = jax.tree.leaves(extract(got[part], unit))
            b = jax.tree.leaves(extract(want[part], unit))
            assert len(a) == len(b) > 0
            for x, y in zip(a, b):
                x, y = np.asarray(x), np.asarray(y)
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), unit


def test_trainer_resumed_from_a_merged_root_tracks_jax(tmp_path):
    """The JAX trainer writes events 2 and 4 (parity); the port merges
    base @4 with embed from @2; both trainers resume from copies of the
    merged root to step 6, their losses within 5e-3, and commit step-6
    manifests with the same entries."""
    kw = dict(arch=ARCH, total_steps=6, batch=2, seq_len=32,
              policy_name="parity", ckpt_interval=2, seed=0, lr=3e-3,
              codec="none", ckpt_async=False)
    src = tmp_path / "src"
    with pytest.raises(JaxSimulatedFailure):
        jax_train(ckpt_dir=str(src), fail_at=5, **kw)
    recipe = tmp_path / "r.yaml"
    recipe.write_text(f"base: {src}@4\noutput: {tmp_path / 'm'}\n"
                      f"select:\n  - units: embed\n    from: {src}@2\n")
    merge(Recipe.load(recipe), device="cpu")
    shutil.copytree(tmp_path / "m", tmp_path / "mj")
    jres = jax_train(ckpt_dir=str(tmp_path / "mj"), resume=True, **kw)
    res = train(ckpt_dir=str(tmp_path / "m"), resume=True, device="cpu",
                **kw)
    assert res["restore_stats"]["step"] == 4
    assert [s for s, _ in res["losses"]] == [4, 5]
    want = dict(jres["losses"])
    for step, loss in res["losses"]:
        assert abs(loss - want[step]) < 5e-3, (step, loss, want[step])
    got_m = ManifestStore(tmp_path / "m").load(6)
    want_m = ManifestStore(tmp_path / "mj").load(6)
    assert got_m.saved_units == want_m.saved_units
    assert {u: {k: (r.stored, r.step) for k, r in e.items()}
            for u, e in got_m.entries.items()} == \
        {u: {k: (r.stored, r.step) for k, r in e.items()}
         for u, e in want_m.entries.items()}


# ------------------------------------------------------------- verification
def flip_payload_byte(store_root, digest, *, codec=None):
    """Rewrite a full object of ``store_root`` with one payload byte
    flipped and its record's crc32 recomputed (the envelope, its table and
    so its address unchanged): only a recompute of the fingerprint table
    from the tensors can see it.  ``codec`` also relabels the envelope."""
    path = Path(store_root) / "objects" / digest[:2] / f"{digest}.chunk"
    blob = path.read_bytes()
    env = workers.parse_envelope(blob, digest)
    if codec is not None:
        env["codec"] = codec
    if env["format"] == "block_delta":
        recs = workers.block_delta_decode(env["payload"])
        data = bytearray(recs[0]["data"])
        data[0] ^= 0x01
        recs[0]["data"] = memoryview(data)
        env["payload"] = workers.block_delta_encode(recs)
    else:
        assert env["format"] == "full"
        meta, items = workers.decode_chunk_items(env["payload"])
        name, shape, dtype, raw = items[0]
        data = bytearray(raw)
        data[0] ^= 0x01
        items[0] = (name, shape, dtype, memoryview(data))
        env["payload"] = workers.encode_chunk_blob(items, meta)
    path.write_bytes(b"".join(bytes(p) for p in _msgpack.pack_parts(env)))


def _weights_digest(root, step, unit):
    return ManifestStore(root).load(step).entries[unit]["weights"].digest


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_flipped_byte_with_its_crc_recomputed_fails_both_merges(
        tmp_path, writer):
    src = tmp_path / "src"
    _write_store(src, writer)
    digest = _weights_digest(src, 6, "lm_head")
    flip_payload_byte(src, digest)
    # the record's crc32 passes: the read alone does not see it
    items, fp_blob = ChunkStore(src).read_items(digest)
    assert fp_blob is not None
    recipes = _recipes(tmp_path, src)
    with pytest.raises(JaxChunkCorruption):
        jax_merge(JaxRecipe.load(recipes["jax"]), workers=2)
    with pytest.raises(ChunkCorruption, match="fingerprint mismatch"):
        merge(Recipe.load(recipes["port"]), workers=2, device="cpu")
    out = tmp_path / "merged_port"
    assert ManifestStore(out).all_steps() == []
    assert not (out / "LATEST").exists()
    # --no-verify copies the object as it is, as the JAX merge does
    shutil.rmtree(out)
    merge(Recipe.load(recipes["port"]), workers=2, verify=False,
          device="cpu")
    assert ManifestStore(out).latest_step() == 6
    assert _objects(out)[f"{digest}.chunk"] == _objects(src)[
        f"{digest}.chunk"]


@pytest.mark.parametrize("corrupt", [False, True])
def test_a_lossy_labelled_block_delta_is_table_checked_as_in_jax(tmp_path,
                                                                 corrupt):
    """The JAX rule recomputes the table of every fp object but a lossy
    full one: a block delta labelled int8 is checked by its table although
    ``read_items`` returns none for it (a restore checks it by crc32)."""
    src = tmp_path / "src"
    _write_store(src, "port")
    digest = _weights_digest(src, 4, "block_001")
    path = src / "objects" / digest[:2] / f"{digest}.chunk"
    if corrupt:
        flip_payload_byte(src, digest, codec="int8")
    else:
        env = workers.parse_envelope(path.read_bytes(), digest)
        env["codec"] = "int8"
        path.write_bytes(b"".join(bytes(p)
                                  for p in _msgpack.pack_parts(env)))
    env = workers.parse_envelope(path.read_bytes(), digest)
    assert env["format"] == "block_delta" and tailor.table_checked(env)
    assert ChunkStore(src).read_items(digest)[1] is None
    recipes = _recipes(tmp_path, src)
    if corrupt:
        with pytest.raises(JaxChunkCorruption):
            jax_merge(JaxRecipe.load(recipes["jax"]), workers=1)
        with pytest.raises(ChunkCorruption):
            merge(Recipe.load(recipes["port"]), workers=1, device="cpu")
        assert ManifestStore(tmp_path / "merged_port").all_steps() == []
    else:
        jax_merge(JaxRecipe.load(recipes["jax"]), workers=1)
        merge(Recipe.load(recipes["port"]), workers=1, device="cpu")
        assert _tree_bytes(tmp_path / "merged_port") == \
            _tree_bytes(tmp_path / "merged_jax")


def test_lossy_full_objects_are_checked_by_crc_alone():
    assert not tailor.table_checked({"fp": b"t", "format": "full",
                                     "codec": "int8"})
    assert tailor.table_checked({"fp": b"t", "format": "full",
                                 "codec": "none"})
    assert not tailor.table_checked({"format": "full", "codec": "none"})


@pytest.mark.parametrize("store", ["xor_delta", "zstd"])
def test_objects_the_port_cannot_decode_raise_unless_unverified(tmp_path,
                                                                store):
    """A JAX store with XOR-delta (canonical path) or zstd objects: both
    are decoded now (zstd by the port's own decoder), so the verifying
    merge is byte-identical to the JAX merge, and so is ``--no-verify``.  A
    flipped byte in an XD01 payload, or in a zstd record under a recomputed
    crc32, raises ``ChunkCorruption`` in both packages (no manifest)."""
    src = tmp_path / "src"
    jmodel, jreg = _jax_side()
    kw = (dict(codec="none", fingerprint=False) if store == "xor_delta"
          else dict(codec="zstd"))
    mgr = JaxManager(src, jreg, jax_make_policy("full", jmodel.layer_units()),
                     async_save=False, fp_block_bytes=BB, **kw)
    for step, s in zip((2, 4, 6), _states()):
        mgr.save(s, step=step)
    mgr.close()
    recipes = _recipes(tmp_path, src)
    if store == "xor_delta":
        ref = ManifestStore(src).load(4).entries["block_001"]["weights"]
        path = src / ref.relpath
        assert workers.parse_envelope(path.read_bytes(),
                                      ref.digest)["format"] == "delta"
        jax_merge(JaxRecipe.load(recipes["jax"]), workers=2)
        merge(Recipe.load(recipes["port"]), workers=2, device="cpu")
        assert _tree_bytes(tmp_path / "merged_port") == \
            _tree_bytes(tmp_path / "merged_jax")
        assert path.name in _objects(tmp_path / "merged_port")
        for pkg in ("jax", "port"):
            shutil.rmtree(tmp_path / f"merged_{pkg}")
        env = workers.parse_envelope(path.read_bytes(), ref.digest)
        payload = bytearray(env["payload"])
        payload[-1] ^= 0x01     # an XOR byte of the last segment
        env["payload"] = bytes(payload)
        path.write_bytes(_msgpack.packb(env))
        with pytest.raises(JaxChunkCorruption, match="digest mismatch"):
            jax_merge(JaxRecipe.load(recipes["jax"]), workers=1)
        with pytest.raises(ChunkCorruption, match="digest mismatch"):
            merge(Recipe.load(recipes["port"]), workers=1, device="cpu")
        assert ManifestStore(tmp_path / "merged_port").all_steps() == []
        return
    envs = {}
    for kinds in ManifestStore(src).load(6).entries.values():
        for ref in kinds.values():
            envs[ref.digest] = (src / ref.relpath, workers.parse_envelope(
                (src / ref.relpath).read_bytes(), ref.digest))
    fmts = {(e["format"], e.get("codec") or bytes(e["payload"][:5]))
            for _, e in envs.values()}
    # full zstd objects and zstd-compressed block deltas
    assert ("full", "zstd") in fmts and ("block_delta", b"BD02\x01") in fmts
    path, env = next(v for v in envs.values()
                     if v[1].get("codec") == "zstd")
    jax_merge(JaxRecipe.load(recipes["jax"]), workers=2)
    for verify in (True, False):
        merge(Recipe.load(recipes["port"]), workers=2, verify=verify,
              device="cpu")
        assert _tree_bytes(tmp_path / "merged_port") == \
            _tree_bytes(tmp_path / "merged_jax")
        shutil.rmtree(tmp_path / "merged_port")
    shutil.rmtree(tmp_path / "merged_jax")
    # a byte of a zstd record flipped under a recomputed crc32
    payload = msgpack.unpackb(bytes(env["payload"]), raw=False)
    t = payload["tensors"][0]
    data = bytearray(t["data"])
    data[len(data) // 2] ^= 0x10
    t["data"] = bytes(data)
    t["crc"] = zlib.crc32(t["data"]) & 0xFFFFFFFF
    env = dict(env, payload=msgpack.packb(payload, use_bin_type=True))
    path.write_bytes(_msgpack.packb(env))
    with pytest.raises(JaxChunkCorruption):
        jax_merge(JaxRecipe.load(recipes["jax"]), workers=1)
    with pytest.raises(ChunkCorruption):
        merge(Recipe.load(recipes["port"]), workers=1, device="cpu")
    assert ManifestStore(tmp_path / "merged_port").all_steps() == []


# -------------------------------------------------------------- blob level
def test_the_copy_reads_each_source_object_once(tmp_path):
    src = tmp_path / "src"
    _write_store(src, "port")
    store = ChunkStore(src)
    digest = _weights_digest(src, 6, "block_000")
    blob = store.read_object_bytes(digest)
    assert store.backend_reads == 1
    info = store.object_info(digest, blob)
    assert store.backend_reads == 1
    assert info["nbytes"] == blob.nbytes == store.object_size(digest)
    out = ChunkStore(tmp_path / "out")
    assert out.write_object_bytes(digest, blob) == blob.nbytes
    assert _objects(tmp_path / "out") == {f"{digest}.chunk": bytes(blob)}
    out.drain_spill()
    assert out.durability() == {"durable_tier": "local", "pending_spill": 0,
                                "durable_on": "durable", "backend": "local"}
    # the saver records the store's answer, which is the JAX store's
    m = ManifestStore(src).load(6)
    assert m.meta["storage"] == store.durability()


def test_merge_reads_each_copied_object_once_from_its_source(tmp_path,
                                                             monkeypatch):
    src = tmp_path / "src"
    _write_store(src, "port")
    reads = []
    orig = ChunkStore._read_blob

    def counting(self, digest, alloc=None):
        if Path(self.root) == src:
            reads.append(digest)
        return orig(self, digest, alloc)

    monkeypatch.setattr(ChunkStore, "_read_blob", counting)
    recipes = _recipes(tmp_path, src)
    stats = merge(Recipe.load(recipes["port"]), workers=3, verify=False,
                  device="cpu")
    assert sorted(reads) == sorted(set(reads))
    assert len(reads) == len(_objects(tmp_path / "merged_port"))
    assert stats["chunks"] == 2 * len(UNITS)


# --------------------------------------------------------------------- CLI
def _cli(args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", "repro_torch.core.tailor",
                           *map(str, args)], capture_output=True, text=True,
                          env=env, timeout=300)


def test_cli_merges_on_the_cpu_and_refuses_without_a_card(tmp_path):
    src = tmp_path / "src"
    _write_store(src, "port")
    recipes = _recipes(tmp_path, src)
    jax_merge(JaxRecipe.load(recipes["jax"]), workers=2)
    out = _cli([recipes["port"], "--workers", 2, "--device", "cpu"])
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("[llmtailor] merged 7 units")
    stats = json.loads(lines[-1])
    assert stats["units"] == 7 and stats["chunks"] == 14
    assert _tree_bytes(tmp_path / "merged_port") == \
        _tree_bytes(tmp_path / "merged_jax")
    shutil.rmtree(tmp_path / "merged_port")
    refused = _cli([recipes["port"]], {"CUDA_VISIBLE_DEVICES": ""})
    assert refused.returncode != 0
    assert "device='cpu'" in refused.stderr
    assert not (tmp_path / "merged_port" / "LATEST").exists()


def test_merge_defaults_to_the_card_and_never_falls_back(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    recipe = Recipe(base=CheckpointRef(tmp_path / "none", 1),
                    output=tmp_path / "out", select=[])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        merge(recipe)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        merge(recipe, verify=False)
    with pytest.raises(tailor.MergeError, match="no manifest"):
        merge(recipe, device="cpu")


def test_a_legacy_entry_without_a_digest_raises(tmp_path):
    src = tmp_path / "src"
    _write_store(src, "port")
    ms = ManifestStore(src)
    m = ms.load(6)
    m.entries["final_norm"]["weights"] = dataclasses.replace(
        m.entries["final_norm"]["weights"], digest="")
    ms.commit(Manifest(step=8, entries=m.entries, meta=m.meta))
    recipe = Recipe(base=CheckpointRef(src, 8), output=tmp_path / "out",
                    select=[])
    with pytest.raises(tailor.MergeError, match="legacy"):
        merge(recipe, device="cpu")
