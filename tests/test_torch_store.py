"""Cross-package checkpoint store: the port (repro_torch) and the JAX
package (repro) write the same bytes and read each other's stores.

Both packages get the same train state: JAX-initialized, converted to the
port through numpy (``repro_torch.convert``).  Everything checked here is
integer/byte data, so every comparison is exact.
"""
import random
import zlib

import jax
import ml_dtypes
import msgpack
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
from repro_torch.checkpoint.saver import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core.layer_registry import LayerRegistry
from repro_torch.core.policies import make_policy
from repro_torch.launch import steps
from repro_torch.models import build_model

# The suite runs in several worker processes at once: one intra-op
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

BB = 4096  # fingerprint block bytes: several blocks per leaf, ragged tails


def _jax_side(arch):
    model = jax_build_model(jax_get_config(arch, reduced=True))
    return model, JaxRegistry(model)


def _port_side(arch):
    model = build_model(get_config(arch, reduced=True))
    return model, LayerRegistry(model)


def _jax_state(model, seed=0):
    st = jax_steps.init_state(model, jax.random.key(seed))
    return jax.tree.map(np.asarray, st)


def _perturb(np_state, frac_units=("block_001",), seed=1):
    """A copy of a numpy state with a few elements of the listed stacked
    units changed (so the next save writes block deltas)."""
    rng = np.random.RandomState(seed)
    out = jax.tree.map(np.array, np_state)
    for tree in (out["params"], out["opt"]["master"], out["opt"]["m"]):
        w = tree["blocks"]["mlp"]["w_gate"]
        w[1, 0, :5] = (w[1, 0, :5].astype(np.float32)
                       + rng.rand(5).astype(np.float32)).astype(w.dtype)
    return out


def _entries(mgr, step):
    m = mgr.manifests.load(step)
    return {u: {k: (r.digest, r.stored, r.delta_base, r.nbytes, r.step)
                for k, r in kinds.items()}
            for u, kinds in m.entries.items()}


def _objects(root):
    return {p.name: p.read_bytes()
            for p in sorted((root / "objects").glob("*/*.chunk"))}


def _jax_mgr(root, arch, policy):
    model, reg = _jax_side(arch)
    return JaxManager(root, reg, jax_make_policy(policy, model.layer_units()),
                      codec="none", async_save=False, fp_block_bytes=BB)


def _port_mgr(root, arch, policy):
    model, reg = _port_side(arch)
    return CheckpointManager(root, reg,
                             make_policy(policy, model.layer_units()),
                             fp_block_bytes=BB)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "yi-9b"])
@pytest.mark.parametrize("policy", ["full", "parity"])
def test_same_state_same_store(tmp_path, arch, policy):
    """Three events (initial, unchanged, perturbed) saved by both packages
    give equal manifest entries and byte-identical object files."""
    jmodel, _ = _jax_side(arch)
    s0 = _jax_state(jmodel)
    s1 = _perturb(s0)
    jm = _jax_mgr(tmp_path / "jax", arch, policy)
    pm = _port_mgr(tmp_path / "port", arch, policy)
    for step, st in ((1, s0), (2, s0), (3, s1), (4, s1)):
        jm.save(st, step=step)
        pm.save(state_from_numpy(st, "cpu"), step=step)
        assert _entries(pm, step) == _entries(jm, step), step
        assert (pm.manifests.load(step).saved_units
                == jm.manifests.load(step).saved_units)
        for k in ("written_bytes", "dedup_hits", "delta_chunks",
                  "full_chunks", "logical_bytes", "d2h_bytes"):
            assert pm.last_save_stats[k] == jm.last_save_stats[k], (step, k)
    assert _objects(tmp_path / "port") == _objects(tmp_path / "jax")
    assert pm.last_save_stats["delta_chunks"] + \
        pm.last_save_stats["dedup_hits"] > 0
    jm.close()
    pm.close()


def _assert_state_equal(np_a, np_b):
    fa = jax.tree.leaves(np_a)
    fb = jax.tree.leaves(np_b)
    assert len(fa) == len(fb)
    for a, b in zip(fa, fb):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("arch", ["llama3.2-3b", "yi-9b"])
def test_jax_store_restores_in_port(tmp_path, arch):
    jmodel, _ = _jax_side(arch)
    s0 = _jax_state(jmodel)
    s1 = _perturb(s0)
    jm = _jax_mgr(tmp_path, arch, "parity")
    jm.save(s0, step=2)
    jm.save(s1, step=4)  # delta objects + carried-over (merged) units
    jm.close()
    pmodel, _ = _port_side(arch)
    pm = _port_mgr(tmp_path, arch, "parity")
    got = pm.restore(steps.state_specs(pmodel), device=torch.device("cpu"))
    want = jm.restore(jax_steps.state_specs(jmodel))
    want = jax.tree.map(np.asarray, want)
    assert int(got["step"]) == int(want["step"]) == 4
    got_np = state_to_numpy({"params": got["params"], "opt": got["opt"]},
                            bf16_dtype=ml_dtypes.bfloat16)
    _assert_state_equal(got_np, {"params": want["params"],
                                 "opt": want["opt"]})
    pm.close()


@pytest.mark.parametrize("arch", ["llama3.2-3b", "yi-9b"])
def test_port_store_restores_in_jax(tmp_path, arch):
    jmodel, _ = _jax_side(arch)
    s0 = _jax_state(jmodel, seed=5)
    s1 = _perturb(s0)
    pm = _port_mgr(tmp_path, arch, "parity")
    pm.save(state_from_numpy(s0, "cpu"), step=2)
    pm.save(state_from_numpy(s1, "cpu"), step=4)
    pm.close()
    jm = _jax_mgr(tmp_path, arch, "parity")
    got = jax.tree.map(np.asarray, jm.restore(jax_steps.state_specs(jmodel)))
    # The merge: step-4 parity (odd event) saved block_001 + embed, the rest
    # carries over from step 2 — exactly the units of s1 vs s0 as saved.
    pmodel, _ = _port_side(arch)
    want = pm.restore(steps.state_specs(pmodel), device=torch.device("cpu"))
    want_np = state_to_numpy({"params": want["params"], "opt": want["opt"]},
                             bf16_dtype=ml_dtypes.bfloat16)
    _assert_state_equal({"params": got["params"], "opt": got["opt"]},
                        want_np)
    m = pm.manifests.load(4)
    assert {r.step for kinds in m.entries.values()
            for r in kinds.values()} == {2, 4}


def test_unchanged_resave_moves_nothing(tmp_path):
    pmodel, _ = _port_side("llama3.2-3b")
    state = steps.init_state(pmodel, 0, torch.device("cpu"))
    pm = _port_mgr(tmp_path, "llama3.2-3b", "full")
    pm.save(state, step=1)
    assert pm.last_save_stats["d2h_bytes"] > 0
    pm.save(state, step=2)
    assert pm.last_save_stats["d2h_bytes"] == 0
    assert pm.last_save_stats["written_bytes"] == 0
    pm.close()
    # After a restart the reference comes from the stored tables.
    pm2 = _port_mgr(tmp_path, "llama3.2-3b", "full")
    restored = pm2.restore(steps.state_specs(pmodel),
                           device=torch.device("cpu"))
    pm2.save(restored, step=3)
    assert pm2.last_save_stats["d2h_bytes"] == 0
    assert pm2.last_save_stats["written_bytes"] == 0
    assert pm2.last_save_stats["dedup_hits"] == 2 * len(pm2.registry.units)
    pm2.close()


def test_corrupt_object_falls_back(tmp_path):
    pmodel, _ = _port_side("llama3.2-3b")
    state = steps.init_state(pmodel, 0, torch.device("cpu"))
    pm = _port_mgr(tmp_path, "llama3.2-3b", "full")
    pm.save(state, step=1)
    first = pm.manifests.load(1).entries["block_000"]["weights"].digest
    with torch.no_grad():
        state["params"]["blocks"]["ln1"][0].add_(1.0)
    pm.save(state, step=2)
    ref = pm.manifests.load(2).entries["block_000"]["weights"]
    assert ref.digest != first
    path = pm.store.object_path(ref.digest)
    blob = bytearray(path.read_bytes())
    blob[-40] ^= 0xFF  # inside the payload
    path.write_bytes(bytes(blob))
    got = pm.restore(steps.state_specs(pmodel), device=torch.device("cpu"))
    assert pm.last_restore_stats["fallback_units"] == {
        "block_000/weights": 1}
    assert float(got["params"]["blocks"]["ln1"][0, 0]) == 1.0
    pm.close()


def _random_value(rng, depth=0):
    kinds = ["int", "str", "bin", "float", "bool", "none"]
    if depth < 3:
        kinds += ["list", "tuple", "dict"]
    k = rng.choice(kinds)
    if k == "int":
        return rng.choice([0, 1, 127, 128, 255, 256, 65535, 65536,
                           2**32 - 1, 2**32, 2**64 - 1, -1, -32, -33, -128,
                           -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
                           rng.randint(-2**63, 2**64 - 1)])
    if k == "str":
        n = rng.choice([0, 1, 31, 32, 255, 256, 70000])
        return "".join(rng.choice("aé字b") for _ in range(n))
    if k == "bin":
        n = rng.choice([0, 1, 255, 256, 65535, 65536, 70000])
        return bytes(rng.getrandbits(8) for _ in range(min(n, 300))) * (
            max(1, n // 300))
    if k == "float":
        return rng.choice([0.0, -1.5, 1e300, float("inf"), rng.random()])
    if k == "bool":
        return rng.random() < 0.5
    if k == "none":
        return None
    n = rng.choice([0, 1, 15, 16, 17])
    if k == "dict":
        return {f"k{i}": _random_value(rng, depth + 1) for i in range(n)}
    items = [_random_value(rng, depth + 1) for _ in range(min(n, 6))]
    return items if k == "list" else tuple(items)


@pytest.mark.parametrize("seed", range(8))
def test_msgpack_matches_reference(seed):
    rng = random.Random(seed)
    for _ in range(12):
        v = _random_value(rng)
        want = msgpack.packb(v, use_bin_type=True)
        assert _msgpack.packb(v) == want
        assert b"".join(bytes(p) for p in _msgpack.pack_parts(v)) == want
        assert _msgpack.unpackb(want) == msgpack.unpackb(want, raw=False)
    # length boundaries of every container and string type
    for n in (15, 16, 65535, 65536):
        for v in (list(range(n)), {str(i): i for i in range(n)}):
            assert _msgpack.packb(v) == msgpack.packb(v, use_bin_type=True)
    with pytest.raises(ValueError):
        _msgpack.unpackb(msgpack.packb([1, 2]) + b"\x00")
    assert zlib.crc32(b"") == 0
