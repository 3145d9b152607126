"""Variant serving in the port: ``core.tailor.variant_manifest``,
``checkpoint.swap.VariantSet`` and the server's ``--variant-*`` flags,
against the JAX package's ``variant_manifest`` and against the explicit
weights-only merge of the same selection.

The store: the reduced Yi-9B, JAX-initialized state through numpy, events
at steps 2, 4 and 6 (parity; the later ones drift a few elements of
block_001), 4 KiB fingerprint blocks.  Manifests and weights are byte
data, so every comparison is exact.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.manifest import ManifestStore as JaxManifestStore
from repro.core.tailor import MergeError as JaxMergeError
from repro.core.tailor import variant_manifest as jax_variant_manifest
from repro.configs import get_config as jax_get_config
from repro.launch import steps as jax_steps
from repro.launch.serve import parse_variant_select as jax_parse
from repro.models import build_model as jax_build_model
from repro_torch.checkpoint.saver import CheckpointManager
from repro_torch.checkpoint.serial import flatten_with_paths
from repro_torch.checkpoint.swap import VariantSet
from repro_torch.configs import get_config
from repro_torch.convert import state_from_numpy
from repro_torch.core import Recipe, merge
from repro_torch.core.layer_registry import LayerRegistry
from repro_torch.core.manifest import ManifestStore
from repro_torch.core.policies import make_policy
from repro_torch.core.tailor import MergeError, variant_manifest
from repro_torch.launch import steps
from repro_torch.launch.serve import parse_variant_select, serve
from repro_torch.models import build_model

torch.set_num_threads(1)

ARCH = "yi-9b"
BB = 4096
CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("variants") / "run"
    jmodel = jax_build_model(jax_get_config(ARCH, reduced=True))
    s = jax.tree.map(np.asarray, jax_steps.init_state(jmodel,
                                                      jax.random.key(0)))
    rng = np.random.RandomState(1)
    model = build_model(get_config(ARCH, reduced=True))
    reg = LayerRegistry(model)
    mgr = CheckpointManager(root, reg, make_policy("parity",
                                                   model.layer_units()),
                            async_save=False, fp_block_bytes=BB)
    for step in (2, 4, 6):
        mgr.save(state_from_numpy(s, "cpu"), step=step)
        s = jax.tree.map(np.array, s)
        for tree in (s["params"], s["opt"]["master"], s["opt"]["m"]):
            w = tree["blocks"]["mlp"]["w_gate"]
            w[1, 0, :5] = (w[1, 0, :5].astype(np.float32)
                           + rng.rand(5).astype(np.float32)).astype(w.dtype)
    mgr.close()
    return root


def _mgr(root):
    model = build_model(get_config(ARCH, reduced=True))
    return model, CheckpointManager(
        root, LayerRegistry(model), make_policy("full", model.layer_units()),
        async_save=False, fp_block_bytes=BB)


def _refs(m):
    return {u: {k: r.to_json() for k, r in kinds.items()}
            for u, kinds in m.entries.items()}


@pytest.mark.parametrize("base_step,select", [
    (6, [("block_000..block_002", 4)]),
    (None, [(["block_*"], 2), ("block_001", 4)]),     # later rules win
    (4, [{"units": ["embed", "final_norm"], "step": 2}]),
    (6, []),
])
def test_variant_manifest_equals_jax(store, base_step, select):
    got = variant_manifest(ManifestStore(store), base_step=base_step,
                           select=select, name="v")
    want = jax_variant_manifest(JaxManifestStore(store), base_step=base_step,
                                select=select, name="v")
    assert (got.step, got.saved_units) == (want.step, want.saved_units)
    assert got.meta == want.meta
    assert _refs(got) == {u: {k: r.to_json() for k, r in kinds.items()}
                          for u, kinds in want.entries.items()}
    assert got.meta["variant"]["name"] == "v"


@pytest.mark.parametrize("base_step,select,error", [
    (6, [("no_such_unit", 4)], KeyError),
    (6, [("block_000", 999)], "merge"),
    (999, [], "merge"),
])
def test_variant_manifest_errors_match_jax(store, base_step, select, error):
    want = JaxMergeError if error == "merge" else error
    got = MergeError if error == "merge" else error
    with pytest.raises(want):
        jax_variant_manifest(JaxManifestStore(store), base_step=base_step,
                             select=select)
    with pytest.raises(got):
        variant_manifest(ManifestStore(store), base_step=base_step,
                         select=select)


@pytest.mark.parametrize("specs", [
    ["block_000..block_003@900"], ["block_001, embed@4", "lm_head@2"],
    ["a@b@3"]])
def test_parse_variant_select_agrees_with_jax(specs):
    assert parse_variant_select(specs) == jax_parse(specs)


@pytest.mark.parametrize("spec", ["block_000", "@4", "block_000@x"])
def test_parse_variant_select_rejects_what_jax_rejects(spec):
    with pytest.raises(ValueError):
        jax_parse([spec])
    with pytest.raises(ValueError):
        parse_variant_select([spec])


def _assert_trees_equal(a, b):
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), p


def test_variant_set_params_equal_cold_loads_of_their_sources(store):
    model, mgr = _mgr(store)
    reg = mgr.registry
    like = steps.state_specs(model)
    try:
        vs = VariantSet(mgr, like, device="cpu")
        vs.materialize("base", base_step=6)
        svc = vs.materialize("mix", base_step=6,
                             select=[(["block_001", "embed"], 2)])
        assert vs["mix"] is svc and svc.step == 6
        cold = {s: mgr.restore({"params": like["params"]}, device=CPU,
                               parts=("params",), step=s)["params"]
                for s in (2, 6)}
        for unit in reg.unit_names():
            src = 2 if unit in ("block_001", "embed") else 6
            _assert_trees_equal(reg.extract_unit(vs.params("mix"), unit),
                                reg.extract_unit(cold[src], unit))
            _assert_trees_equal(reg.extract_unit(vs.params("base"), unit),
                                reg.extract_unit(cold[6], unit))
        # block_001 drifted after step 2: the variants serve other weights
        assert not torch.equal(
            reg.extract_unit(vs.params("mix"), "block_001")["mlp"]["w_gate"],
            reg.extract_unit(vs.params("base"), "block_001")["mlp"]["w_gate"])
        stats = vs.stats()
        assert set(stats["variants"]) == {"base", "mix"}
        assert stats["cache"] is None
        assert stats["backend_reads"] >= sum(
            v["targets"] for v in stats["variants"].values())
        # weights only: no optimizer object was read
        assert all(v["targets"] == len(reg.unit_names())
                   for v in stats["variants"].values())
    finally:
        mgr.close()


SERVE = dict(arch=ARCH, batch=2, prompt_len=8, new_tokens=3, device="cpu")


def test_variant_serve_equals_the_explicit_weights_only_merge(store,
                                                              tmp_path):
    recipe = tmp_path / "r.yaml"
    recipe.write_text(f"base: {store}@6\noutput: {tmp_path / 'm'}\n"
                      "optimizer: false\nselect:\n"
                      f"  - units: [block_001, embed]\n    from: {store}@2\n")
    merge(Recipe.load(recipe), device="cpu")
    explicit = serve(from_ckpt=str(tmp_path / "m"), **SERVE)
    variant = serve(from_ckpt=str(store), variant_base_step=6,
                    variant_select=["block_001,embed@2"], **SERVE)
    assert explicit["served_step"] == variant["served_step"] == 6
    assert explicit["tokens_digest"] == variant["tokens_digest"]
    # the CLI flags reach the same variant
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", ARCH, "--batch", "2", "--prompt-len", "8",
         "--new-tokens", "3", "--from-ckpt", str(store),
         "--variant-base-step", "6", "--variant-select", "block_*@2",
         "--variant-select", "block_000,embed@4"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    cli = json.loads(out.stdout)
    both = serve(from_ckpt=str(store), variant_base_step=6,
                 variant_select=["block_*@2", "block_000,embed@4"],
                 **SERVE)
    assert cli["tokens_digest"] == both["tokens_digest"]
