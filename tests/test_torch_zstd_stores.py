"""Stores the JAX package wrote with zstd (``codec="zstd"``, and ``"auto"``
where ``zstandard`` is installed, its manager's default) read in the port
through its own zstd decoder: full objects, block deltas (BD02) and XOR
deltas (XD01) compressed with zstd, and int8 records with ``comp: zstd``.
Each store restores in the port bit-exactly to JAX's restore of it, a
weights-only load gives JAX's parameters, and a verifying merge of a recipe
over it is byte-identical to JAX's merge of the same recipe.
"""
from pathlib import Path

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.checkpoint.workers as jax_workers
from repro.checkpoint.saver import CheckpointManager as JaxManager
from repro.configs import get_config as jax_get_config
from repro.core import LayerRegistry as JaxRegistry
from repro.core.policies import make_policy as jax_make_policy
from repro.core.recipe import Recipe as JaxRecipe
from repro.core.tailor import merge as jax_merge
from repro.launch import steps as jax_steps
from repro.models import build_model as jax_build_model
from repro_torch.checkpoint import workers
from repro_torch.checkpoint.saver import CheckpointManager
from repro_torch.checkpoint.serial import flatten_with_paths
from repro_torch.configs import get_config
from repro_torch.convert import state_to_numpy
from repro_torch.core import Recipe, merge
from repro_torch.core.layer_registry import LayerRegistry
from repro_torch.core.manifest import ManifestStore
from repro_torch.core.policies import make_policy
from repro_torch.launch import steps
from repro_torch.models import build_model

ARCH = "yi-9b"
BB = 4096
BF16 = ml_dtypes.bfloat16
CPU = torch.device("cpu")

# (JAX codec, fingerprint path): the fp path writes full objects and BD02
# block deltas, the canonical path full objects and XD01 XOR deltas
CASES = {
    "zstd_fp": ("zstd", True),
    "zstd_canonical": ("zstd", False),
    "auto_fp": ("auto", True),
    "int8_zstd": ("int8", True),
}


@pytest.fixture(autouse=True)
def _jax_with_zstd(monkeypatch):
    # zstandard is installed here; pin it so "auto" means zstd
    assert jax_workers._zstd is not None
    monkeypatch.setattr(jax_workers, "HAVE_ZSTD", True)


def _states(seed=0):
    """Three numpy train states: JAX's init, then two drifts of a few
    elements of block_001 (weights, master and m) drawn by a numpy seed."""
    jmodel = jax_build_model(jax_get_config(ARCH, reduced=True))
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


def _jax_mgr(root, codec, fingerprint):
    jmodel = jax_build_model(jax_get_config(ARCH, reduced=True))
    return jmodel, JaxManager(
        root, JaxRegistry(jmodel),
        jax_make_policy("parity", jmodel.layer_units()), codec=codec,
        fingerprint=fingerprint, async_save=False, fp_block_bytes=BB)


def _write_jax_store(root, codec, fingerprint):
    """Steps 2, 4, 6 of ``_states`` under the parity policy."""
    _, mgr = _jax_mgr(root, codec, fingerprint)
    for step, s in zip((2, 4, 6), _states()):
        mgr.save(s, step=step)
    mgr.close()


def _zstd_kinds(root):
    """What of the store is compressed with zstd: full objects, BD02 and
    XD01 bodies, int8 records."""
    kinds = set()
    for p in sorted((Path(root) / "objects").glob("*/*.chunk")):
        env = workers.parse_envelope(p.read_bytes(), p.stem)
        payload = bytes(env["payload"])
        if env["format"] == "full":
            _, items = workers.decode_chunk_items(payload)
            if env.get("codec") == "zstd":
                kinds.add("full")
            if env.get("codec") == "int8" and any(
                    isinstance(raw, workers.Int8Record)
                    for *_, raw in items):
                kinds.add("int8")
        elif payload[4] == 1:
            kinds.add({b"BD02": "bd02", b"XD01": "xd01"}[payload[:4]])
    return kinds


def _assert_np_equal(a, b):
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, p
        assert x.tobytes() == y.tobytes(), p


def _port_mgr(root):
    model = build_model(get_config(ARCH, reduced=True))
    return model, CheckpointManager(
        root, LayerRegistry(model),
        make_policy("parity", model.layer_units()), async_save=False,
        fp_block_bytes=BB)


@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_zstd_store_restores_bit_exactly(tmp_path, case):
    codec, fp = CASES[case]
    _write_jax_store(tmp_path, codec, fp)
    want_kinds = {"zstd_fp": {"full", "bd02"},
                  "zstd_canonical": {"full", "xd01"},
                  "auto_fp": {"full", "bd02"},
                  "int8_zstd": {"int8"}}[case]
    assert want_kinds <= _zstd_kinds(tmp_path)
    jmodel, jm = _jax_mgr(tmp_path, codec, fp)
    want = jax.tree.map(np.asarray, jm.restore(jax_steps.state_specs(jmodel)))
    for step in (2, 4):
        want_w = jax.tree.map(np.asarray, jm.restore(
            {"params": jax_steps.state_specs(jmodel)["params"]}, step=step,
            parts=("params",)))
        pmodel, pm = _port_mgr(tmp_path)
        got_w = pm.restore({"params": steps.state_specs(pmodel)["params"]},
                           device=CPU, step=step, parts=("params",))
        pm.close()
        _assert_np_equal(state_to_numpy(got_w["params"], bf16_dtype=BF16),
                         want_w["params"])
    jm.close()
    pmodel, pm = _port_mgr(tmp_path)
    got = pm.restore(steps.state_specs(pmodel), device=CPU)
    stats = pm.last_restore_stats
    pm.close()
    assert int(got["step"]) == int(want["step"]) == 6
    assert not stats["fallback_units"]
    _assert_np_equal(
        state_to_numpy({"params": got["params"], "opt": got["opt"]},
                       bf16_dtype=BF16),
        {"params": want["params"], "opt": want["opt"]})


@pytest.mark.parametrize("case", ["zstd_fp", "zstd_canonical", "int8_zstd"])
def test_verifying_merge_of_a_jax_zstd_store_is_byte_identical(tmp_path,
                                                               case):
    codec, fp = CASES[case]
    src = tmp_path / "src"
    _write_jax_store(src, codec, fp)
    recipes = {}
    for pkg in ("jax", "port"):
        p = tmp_path / f"recipe_{pkg}.yaml"
        p.write_text(f"base: {src}@6\noutput: {tmp_path / f'merged_{pkg}'}\n"
                     f"optimizer: true\nselect:\n"
                     f"  - units: block_001\n    from: {src}@4\n"
                     f"  - units: [embed, final_norm]\n    from: {src}@2\n")
        recipes[pkg] = p
    want = jax_merge(JaxRecipe.load(recipes["jax"]), workers=1)
    got = merge(Recipe.load(recipes["port"]), workers=1, device="cpu")

    def tree(root):
        return {str(p.relative_to(root)): p.read_bytes()
                for p in sorted(Path(root).rglob("*")) if p.is_file()}

    assert tree(tmp_path / "merged_port") == tree(tmp_path / "merged_jax")
    assert {k: got[k] for k in ("units", "bytes", "chunks", "sources")} == \
        {k: want[k] for k in ("units", "bytes", "chunks", "sources")}
    assert ManifestStore(tmp_path / "merged_port").load().step == 6
