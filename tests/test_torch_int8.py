"""The int8 checkpoint codec in the port against the JAX package: records,
stores, savers, restores, hot-swaps and the trainer.

The JAX side runs with ``repro.checkpoint.workers.HAVE_ZSTD`` patched to
False: with ``zstandard`` installed its int8 records would be compressed
(``comp: zstd``), and the port writes ``comp: none`` (it does not use
``zstandard``).  Both packages get the same JAX-initialized state through
numpy (``repro_torch.convert``).  Records, manifests, objects and restored
tensors are integer or byte data, or dequantized by the same float32
arithmetic, so those comparisons are exact; the trainer's losses are held
to the port's train-step tolerance against JAX (5e-3, as
tests/test_torch_model.py holds five steps).
"""
import shutil

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.checkpoint.workers as jax_workers
from repro.checkpoint.saver import CheckpointManager as JaxManager
from repro.checkpoint.swap import WeightService as JaxWeightService
from repro.configs import get_config as jax_get_config
from repro.core import LayerRegistry as JaxRegistry
from repro.core.policies import make_policy as jax_make_policy
from repro.launch import steps as jax_steps
from repro.launch.train import SimulatedFailure as JaxSimulatedFailure
from repro.launch.train import train as jax_train
from repro.models import build_model as jax_build_model
from repro_torch.checkpoint import workers
from repro_torch.checkpoint.overlap import OverlappedSaver
from repro_torch.checkpoint.saver import CheckpointManager
from repro_torch.checkpoint.serial import ChunkCorruption, flatten_with_paths
from repro_torch.checkpoint.swap import WeightService
from repro_torch.configs import get_config
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core.layer_registry import LayerRegistry
from repro_torch.core.policies import make_policy
from repro_torch.dtypes import byte_view
from repro_torch.kernels import quantize as qz
from repro_torch.launch import steps
from repro_torch.launch.train import SimulatedFailure, train
from repro_torch.models import build_model

# The suite runs in several worker processes at once: one intra-op
# thread each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

BB = 4096
CPU = torch.device("cpu")
BF16 = ml_dtypes.bfloat16


@pytest.fixture(autouse=True)
def _jax_without_zstd(monkeypatch):
    monkeypatch.setattr(jax_workers, "HAVE_ZSTD", False)


def _jax_side(arch):
    model = jax_build_model(jax_get_config(arch, reduced=True))
    return model, JaxRegistry(model)


def _port_side(arch):
    model = build_model(get_config(arch, reduced=True))
    return model, LayerRegistry(model)


def _jax_state(model, seed=0):
    return jax.tree.map(np.asarray,
                        jax_steps.init_state(model, jax.random.key(seed)))


def _poke(np_state, unit_index=1, seed=1):
    """A copy of a numpy state with a few elements of one stacked unit
    changed in the weights, master and m."""
    rng = np.random.RandomState(seed)
    out = jax.tree.map(np.array, np_state)
    for tree in (out["params"], out["opt"]["master"], out["opt"]["m"]):
        w = tree["blocks"]["mlp"]["w_gate"]
        w[unit_index, 0, :5] = (w[unit_index, 0, :5].astype(np.float32)
                                + rng.rand(5).astype(np.float32)
                                ).astype(w.dtype)
    return out


def _jax_mgr(root, arch, policy="parity"):
    model, reg = _jax_side(arch)
    return JaxManager(root, reg, jax_make_policy(policy, model.layer_units()),
                      codec="int8", async_save=False, fp_block_bytes=BB)


def _port_mgr(root, arch, policy="parity", **kw):
    model, reg = _port_side(arch)
    return CheckpointManager(root, reg,
                             make_policy(policy, model.layer_units()),
                             fp_block_bytes=BB, codec="int8", **kw)


def _entries(mgr, step):
    m = mgr.manifests.load(step)
    return {u: {k: (r.digest, r.stored, r.delta_base, r.nbytes, r.step)
                for k, r in kinds.items()}
            for u, kinds in m.entries.items()}


def _objects(root):
    return {p.name: p.read_bytes()
            for p in sorted((root / "objects").glob("*/*.chunk"))}


def _payload_bytes(n, dtype):
    """Bytes an int8 save moves for one leaf: its record if quantized."""
    if workers.int8_eligible(dtype, (n,)):
        return qz.record_nbytes(n)
    return n * {"bfloat16": 2, "float32": 4, "int32": 4}[dtype]


def _state_payload_bytes(registry, state):
    """What an int8 save of every unit of ``state`` moves: per unit leaf
    (a stacked leaf's slice), its record if quantized, else its bytes."""
    from repro_torch.dtypes import dtype_name

    total = 0
    for name in registry.unit_names():
        for tree in (registry.extract_unit(state["params"], name),
                     registry.extract_opt_unit(state["opt"], name)):
            total += sum(_payload_bytes(x.numel(), dtype_name(x.dtype))
                         for _, x in flatten_with_paths(tree))
    return total


# ------------------------------------------------------------------ records
def _raw_items(seed):
    """Items of every kind the codec meets: float and bf16 tensors at and
    around 256 elements (quantized or not), an all-zero one, int and bool
    tensors (never quantized)."""
    rng = np.random.RandomState(seed)
    arrays = {
        "a/f32_big": (rng.randn(33, 40) * 3).astype(np.float32),
        "a/f32_256": rng.randn(256).astype(np.float32),
        "a/f32_255": rng.randn(255).astype(np.float32),
        "b/bf16_big": (rng.randn(700) * 0.02).astype(BF16),
        "b/bf16_small": rng.randn(17).astype(BF16),
        "c/zeros": np.zeros(513, np.float32),
        "c/f64": rng.randn(300),
        "d/int32": rng.randint(-9, 9, 400).astype(np.int32),
        "d/bool": rng.rand(300) > 0.5,
        "e/scalar": np.float32(rng.randn()),
    }
    return [(k, tuple(v.shape), str(v.dtype), np.ascontiguousarray(v)
             .tobytes()) for k, v in arrays.items()]


def _port_records(items):
    """The port's int8 items: the eligible leaves quantized by the plain
    version (what a CPU save runs), the rest raw."""
    from repro_torch.dtypes import from_bytes

    out = []
    for name, shape, dtype, raw in items:
        if workers.int8_eligible(dtype, shape):
            x = from_bytes(bytearray(raw), shape, dtype)
            unit = qz.quantize_unit([x])
            nb = unit.n_blocks(0)
            rec = workers.Int8Record(
                unit.record(0).numpy().tobytes(), nb * 256, nb, shape, dtype)
            out.append((name, shape, dtype, rec))
        else:
            out.append((name, shape, dtype, raw))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_records_equal_the_jax_codec_byte_for_byte(seed):
    items = _raw_items(seed)
    want = jax_workers.encode_chunk_items(items, {}, "int8")
    got = b"".join(workers.encode_chunk_blob(_port_records(items),
                                             {}).parts)
    assert got == want
    # and they decode to the records, not to dequantized tensors
    _, back = workers.decode_chunk_items(got)
    kinds = {n: type(d).__name__ for n, _, _, d in back}
    assert kinds["a/f32_big"] == kinds["b/bf16_big"] == "Int8Record"
    assert kinds["a/f32_255"] == kinds["d/int32"] == "memoryview"


def test_codec_resolution():
    assert workers.resolve_codec("auto") == "none"
    assert workers.resolve_codec("none") == "none"
    assert workers.resolve_codec("int8") == "int8"
    with pytest.raises(workers.CodecUnavailable, match="zstandard"):
        workers.resolve_codec("zstd")
    with pytest.raises(ValueError):
        workers.resolve_codec("lz4")
    assert workers.int8_eligible("float32", (16, 16))
    assert not workers.int8_eligible("float32", (255,))
    assert not workers.int8_eligible("int32", (1024,))


def test_zstd_compressed_int8_records_raise_codec_unavailable(tmp_path,
                                                              monkeypatch):
    monkeypatch.setattr(jax_workers, "HAVE_ZSTD", True)
    items = _raw_items(0)
    blob = jax_workers.encode_chunk_items(items, {}, "int8")
    with pytest.raises(workers.CodecUnavailable, match="zstandard"):
        workers.decode_chunk_items(blob)
    # a JAX store written so does not restore in the port, naming why
    jmodel, _ = _jax_side("yi-9b")
    jm = _jax_mgr(tmp_path, "yi-9b")
    jm.save(_jax_state(jmodel), step=2)
    jm.close()
    pmodel, _ = _port_side("yi-9b")
    pm = _port_mgr(tmp_path, "yi-9b")
    with pytest.raises(workers.CodecUnavailable, match="zstandard"):
        pm.restore(steps.state_specs(pmodel), device=CPU)
    pm.close()


# ------------------------------------------------------------------- stores
@pytest.mark.parametrize("arch", ["llama3.2-3b", "yi-9b"])
@pytest.mark.parametrize("policy", ["full", "parity"])
def test_same_state_same_store(tmp_path, arch, policy):
    """Four events (initial, unchanged, perturbed twice) saved by both
    packages with codec int8 give equal manifest entries and byte-identical
    object files; the port moves only the records of the quantized
    leaves device->host."""
    jmodel, _ = _jax_side(arch)
    s0 = _jax_state(jmodel)
    s1 = _poke(s0)
    s2 = _poke(s1, unit_index=0, seed=2)
    jm = _jax_mgr(tmp_path / "jax", arch, policy)
    pm = _port_mgr(tmp_path / "port", arch, policy)
    for step, st in ((1, s0), (2, s0), (3, s1), (4, s2)):
        jm.save(st, step=step)
        pm.save(state_from_numpy(st, "cpu"), step=step)
        assert _entries(pm, step) == _entries(jm, step), step
        for k in ("written_bytes", "dedup_hits", "delta_chunks",
                  "full_chunks", "logical_bytes"):
            assert pm.last_save_stats[k] == jm.last_save_stats[k], (step, k)
        assert pm.last_save_stats["delta_chunks"] == 0
        if step == 1:   # every unit, weights and optimizer state
            want = _state_payload_bytes(pm.registry,
                                        state_from_numpy(st, "cpu"))
            assert pm.last_save_stats["d2h_bytes"] == want
            assert want < 0.4 * jm.last_save_stats["d2h_bytes"]
        if step == 2:
            assert pm.last_save_stats["d2h_bytes"] == 0
    assert _objects(tmp_path / "port") == _objects(tmp_path / "jax")
    jm.close()
    pm.close()


def _assert_np_equal(a, b):
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, p
        assert x.tobytes() == y.tobytes(), p


def _np_state(st):
    return {"params": st["params"], "opt": st["opt"]}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stores_restore_across_packages(tmp_path, writer):
    """An int8 store either package wrote restores in both to equal
    tensors (the merge of two events, dequantized)."""
    arch = "yi-9b"
    jmodel, _ = _jax_side(arch)
    s0 = _jax_state(jmodel, seed=5)
    s1 = _poke(s0)
    if writer == "jax":
        m = _jax_mgr(tmp_path, arch)
        m.save(s0, step=2)
        m.save(s1, step=4)
    else:
        m = _port_mgr(tmp_path, arch)
        m.save(state_from_numpy(s0, "cpu"), step=2)
        m.save(state_from_numpy(s1, "cpu"), step=4)
    m.close()
    pmodel, _ = _port_side(arch)
    pm = _port_mgr(tmp_path, arch)
    got = pm.restore(steps.state_specs(pmodel), device=CPU)
    stats = pm.last_restore_stats
    pm.close()
    jm = _jax_mgr(tmp_path, arch)
    want = jax.tree.map(np.asarray, jm.restore(jax_steps.state_specs(jmodel)))
    jm.close()
    assert int(got["step"]) == int(want["step"]) == 4
    _assert_np_equal(state_to_numpy(_np_state(got), bf16_dtype=BF16),
                     _np_state(want))
    # lossy: the merge differs from the saved state, by the quantization
    assert state_to_numpy(got["opt"])["master"]["final_norm"]["scale"] \
        .tobytes() == s1["opt"]["master"]["final_norm"]["scale"].tobytes()
    big = s1["opt"]["master"]["embed"]["w"]
    assert np.abs(state_to_numpy(got["opt"])["master"]["embed"]["w"]
                  - big).max() <= np.abs(big).max() / 254 * 1.0001
    # only records and raw leaves crossed host->device
    assert stats["h2d_bytes"] == _state_payload_bytes(
        LayerRegistry(pmodel), state_from_numpy(s1, "cpu"))


def test_a_lossy_object_is_never_delta_encoded(tmp_path):
    pmodel, _ = _port_side("yi-9b")
    state = steps.init_state(pmodel, 0, CPU)
    pm = _port_mgr(tmp_path, "yi-9b", policy="full")
    pm.save(state, step=1)
    for step in (2, 3):
        with torch.no_grad():
            state["params"]["blocks"]["mlp"]["w_gate"][1].view(-1)[:3] += 1
        pm.save(state, step=step)
        assert pm.last_save_stats["delta_chunks"] == 0
        assert pm.last_save_stats["full_chunks"] == 1
        ref = pm.manifests.load(step).entries["block_001"]["weights"]
        assert ref.stored == "full" and ref.delta_base is None
    for d in pm.store.iter_digests():
        env = pm.store.read_envelope(d)
        assert env["format"] == "full" and env["codec"] == "int8"
    pm.close()


def test_a_flipped_byte_in_an_int8_record_raises(tmp_path):
    pmodel, _ = _port_side("yi-9b")
    state = steps.init_state(pmodel, 0, CPU)
    pm = _port_mgr(tmp_path, "yi-9b", policy="full")
    pm.save(state, step=1)
    ref = pm.manifests.load(1).entries["embed"]["weights"]
    path = pm.store.object_path(ref.digest)
    blob = bytearray(path.read_bytes())
    # the embed table's q, as the quantize kernel's plain version wrote it
    q, _ = qz.quantize_plain(state["params"]["embed"]["w"])
    at = blob.find(q.numpy().tobytes()[:64])
    assert at > 0
    blob[at + 10] ^= 0x01
    path.write_bytes(bytes(blob))
    with pytest.raises(ChunkCorruption, match="crc"):
        pm.store.read_items(ref.digest)
    pm.close()


# ------------------------------------------------------------------- savers
def test_sync_and_overlapped_int8_saves_commit_the_same_bytes(tmp_path):
    """A five-event chain (full base, clean re-save, one unit drifted,
    every leaf drifted, clean) saved sync and overlapped with codec int8,
    the state overwritten in place right after every ``begin``."""
    pmodel, _ = _port_side("llama3.2-3b")
    s0 = steps.init_state(pmodel, 0, CPU)
    chain = [s0, s0]
    for how in ("one", "all", "same"):
        st = {k: (v if k == "step" else
                  jax.tree.map(lambda t: t.clone(), chain[-1][k]))
              for k, v in chain[-1].items()}
        with torch.no_grad():
            if how == "one":
                st["params"]["blocks"]["ln1"][0].add_(1)
            elif how == "all":
                for part in ("params", "opt"):
                    for _, x in flatten_with_paths(st[part]):
                        x.view(-1)[:1] += 1
        chain.append(st)
    sync = _port_mgr(tmp_path / "sync", "llama3.2-3b", policy="full")
    for i, st in enumerate(chain):
        sync.save(st, step=10 * (i + 1))
    mgr = _port_mgr(tmp_path / "ov", "llama3.2-3b", policy="full")
    ov = OverlappedSaver(mgr, spread_steps=2)
    d2h = []
    for i, st in enumerate(chain):
        live = {k: (v if k == "step" else
                    jax.tree.map(lambda t: t.clone(), v))
                for k, v in st.items()}
        ov.begin(live, 10 * (i + 1))
        with torch.no_grad():
            for part in ("params", "opt"):
                for _, x in flatten_with_paths(live[part]):
                    x.add_(1)
        while ov.tick() is None:
            pass
        d2h.append(mgr.last_save_stats["d2h_bytes"])
    for i in range(len(chain)):
        assert _entries(mgr, 10 * (i + 1)) == _entries(sync, 10 * (i + 1))
    assert _objects(tmp_path / "ov") == _objects(tmp_path / "sync")
    assert d2h[1] == d2h[4] == 0 and d2h[0] > 0
    ov.close()
    mgr.close()
    sync.close()


# --------------------------------------------------------------------- swap
def test_port_swap_on_a_jax_int8_store_matches_the_jax_service(tmp_path):
    arch = "yi-9b"
    jmodel, jreg = _jax_side(arch)
    s1 = _jax_state(jmodel)
    s2 = _poke(s1)
    jm = JaxManager(tmp_path, jreg,
                    jax_make_policy("full", jmodel.layer_units()),
                    codec="int8", async_save=False, fp_block_bytes=BB)
    jm.save(s1, step=10)
    jm.save(s2, step=20)
    try:
        jsvc = JaxWeightService(jm, jax_steps.state_specs(jmodel), step=10)
        jstats = jsvc.poll()
        want = jax.tree.map(np.asarray, jsvc.current())
    finally:
        jm.close()
    pmodel, _ = _port_side(arch)
    pm = _port_mgr(tmp_path, arch, policy="full")
    try:
        svc = WeightService(pm, steps.state_specs(pmodel), device="cpu",
                            step=10)
        stats = svc.poll()
        got = svc.current()
        cold = pm.restore({"params": steps.state_specs(pmodel)["params"]},
                          device=CPU, parts=("params",), step=20)["params"]
    finally:
        pm.close()
    for k in ("units_swapped", "units_skipped", "units_full",
              "units_scattered"):
        assert stats[k] == jstats[k], k
    assert stats["units_full"] == 1 and stats["units_scattered"] == 0
    _assert_np_equal(state_to_numpy(got, bf16_dtype=BF16), want)
    for (p, x), (_, y) in zip(flatten_with_paths(got),
                              flatten_with_paths(cold)):
        assert torch.equal(byte_view(x), byte_view(y)), p
    # the swapped unit crossed as its records
    unit = pm.registry.extract_unit(got, "block_001")
    assert stats["h2d_bytes"] == sum(
        _payload_bytes(x.numel(), "bfloat16")
        for _, x in flatten_with_paths(unit))


# ------------------------------------------------------------------ trainer
def _seed_store(root, arch):
    """A store holding the JAX-initialized state at step 0 (codec none),
    from which both trainers start: the same parameters for both."""
    jmodel, jreg = _jax_side(arch)
    m = JaxManager(root, jreg, jax_make_policy("full", jmodel.layer_units()),
                   codec="none", async_save=False)
    m.save(_jax_state(jmodel), step=0)
    m.close()


@pytest.mark.parametrize("codec", ["int8", "none"])
def test_trainer_fail_and_resume_tracks_jax(tmp_path, codec):
    """Both trainers start from the same parameters (a JAX-written step-0
    store), save every 2 steps (parity policy), fail at step 5 and resume
    from the step-4 merge.  Held to 5e-3 against JAX: every resumed loss
    under the lossless codec; under int8 the loss of the restored merge
    itself (step 4).  The next step is not comparable under int8: the
    restored v holds zeros wherever an element sat below 1/254 of its
    block's largest, and the first update after the resume divides m by
    the square root of that v plus one fresh gradient term, so it swings
    with the last bits of the gradient (scripts/int8_resume_gap.py at
    this config: from the JAX package's int8 store the JAX trainer's next
    loss is 12.87 and the port's 6.94, their first resumed losses within
    3e-4)."""
    kw = dict(arch="yi-9b", total_steps=6, batch=2, seq_len=32,
              policy_name="parity", ckpt_interval=2, seed=0, lr=3e-3,
              codec=codec)
    _seed_store(tmp_path / "jax", "yi-9b")
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    with pytest.raises(JaxSimulatedFailure):
        jax_train(ckpt_dir=str(tmp_path / "jax"), resume=True, fail_at=5,
                  ckpt_async=False, **kw)
    jres = jax_train(ckpt_dir=str(tmp_path / "jax"), resume=True,
                     ckpt_async=False, **kw)
    with pytest.raises(SimulatedFailure) as e:
        train(ckpt_dir=str(tmp_path / "port"), resume=True, fail_at=5,
              device="cpu", ckpt_async=False, **kw)
    assert [ev["step"] for ev in e.value.save_events] == [2, 4]
    res = train(ckpt_dir=str(tmp_path / "port"), resume=True, device="cpu",
                ckpt_async=False, **kw)
    assert res["codec"] == workers.resolve_codec(codec)
    assert res["restore_stats"]["step"] == 4
    assert [s for s, _ in res["losses"]] == [4, 5]
    want = dict(jres["losses"])
    compared = res["losses"] if codec == "none" else res["losses"][:1]
    for step, loss in compared:
        assert abs(loss - want[step]) < 5e-3, (step, loss, want[step])
    for _, loss in res["losses"]:
        assert np.isfinite(loss)
    pm = _port_mgr(tmp_path / "port", "yi-9b")
    jm = _jax_mgr(tmp_path / "jax", "yi-9b")
    for step in (2, 4, 6):
        got, ref = _entries(pm, step), _entries(jm, step)
        assert {u: {k: v[1:3] + v[4:] for k, v in kinds.items()}
                for u, kinds in got.items()} == \
            {u: {k: v[1:3] + v[4:] for k, v in kinds.items()}
             for u, kinds in ref.items()}
    if codec == "int8":       # lossy objects are never delta-encoded
        assert all(pm.store.read_envelope(d)["format"] == "full"
                   for d in pm.store.iter_digests())
    pm.close()
    jm.close()


def test_cli_takes_codec_int8(tmp_path):
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = Path(__file__).resolve().parent.parent / "src"
    env = dict(os.environ, PYTHONPATH=str(src), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device",
           "cpu", "--arch", "yi-9b", "--steps", "2", "--batch", "2",
           "--seq-len", "16", "--policy", "parity", "--ckpt-interval", "2",
           "--ckpt-dir", str(tmp_path / "run"), "--codec", "int8"]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=300, check=True)
    r = json.loads(out.stdout)
    assert r["codec"] == "int8" and len(r["save_events"]) == 1
    pm = _port_mgr(tmp_path / "run", "yi-9b")
    env = pm.store.read_envelope(
        pm.manifests.load(2).entries["embed"]["weights"].digest)
    assert env["codec"] == "int8"
    pm.close()
