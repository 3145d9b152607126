"""The port's weight hot-swap (``repro_torch.checkpoint.swap``), the
weights-only partial restore and the read session, against cold restores
and against the JAX package's ``WeightService`` on a store the JAX package
wrote.

The cases of ``tests/test_serve_swap.py`` on the ``local`` backend with a
dense arch: the JAX-initialized train state reaches the port through numpy;
4 KiB fingerprint blocks, so a one-element drift per leaf lands as
block-sparse (BD02) deltas, the shape the scatter path exists for.  Every
comparison of weights is bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.saver import CheckpointManager as JaxManager
from repro.checkpoint.swap import WeightService as JaxWeightService
from repro.configs import get_config as jax_get_config
from repro.core import LayerRegistry as JaxRegistry
from repro.core.policies import make_policy as jax_make_policy
from repro.launch import steps as jax_steps
from repro.models import build_model as jax_build_model
from repro_torch.checkpoint import faults
from repro_torch.checkpoint.chunk_store import ChunkRef, ReadSession
from repro_torch.checkpoint.faults import InjectedCrash
from repro_torch.checkpoint.saver import CheckpointManager
from repro_torch.checkpoint.serial import flatten_with_paths
from repro_torch.checkpoint.swap import SwapError, WeightService
from repro_torch.configs import get_config
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core.layer_registry import LayerRegistry
from repro_torch.core.manifest import Manifest
from repro_torch.core.policies import make_policy
from repro_torch.launch import steps
from repro_torch.launch.serve import serve
from repro_torch.models import build_model

torch.set_num_threads(1)

ARCH = "yi-9b"
BB = 4096
CPU = torch.device("cpu")
SWAP_COUNTS = ("units_swapped", "units_skipped", "units_scattered",
               "units_full", "blocks_applied", "step_from", "step_to")


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.disarm()
    yield
    faults.disarm()


def _poke_np(tree):
    def poke(x):
        x = np.array(x)
        x.flat[:1] += 1
        return x
    return jax.tree.map(poke, tree)


@pytest.fixture(scope="module")
def setup():
    jmodel = jax_build_model(jax_get_config(ARCH, reduced=True))
    s1 = jax.tree.map(np.asarray, jax_steps.init_state(jmodel,
                                                       jax.random.key(0)))
    # every leaf drifts by one element: block-sparse deltas at 4 KiB
    s2 = {"step": np.array(s1["step"]), "params": _poke_np(s1["params"]),
          "opt": _poke_np(s1["opt"])}
    model = build_model(get_config(ARCH, reduced=True))
    return model, LayerRegistry(model), s1, s2


def _mgr(root, registry, model):
    return CheckpointManager(root, registry,
                             make_policy("full", model.layer_units()),
                             async_save=False, fp_block_bytes=BB)


def _port(np_state):
    return state_from_numpy(np_state, "cpu")


def _like(model):
    return steps.state_specs(model)


def _cold(mgr, model, step):
    return mgr.restore({"params": _like(model)["params"]}, device=CPU,
                       parts=("params",), step=step)["params"]


def _assert_params_equal(a, b):
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), p


def test_swap_parity_bit_exact(tmp_path, setup):
    """Load step 10, hot-swap to 20, compare bit for bit with a cold
    weights-only restore of 20; the swap reads less than the cold load."""
    model, reg, s1, s2 = setup
    mgr = _mgr(tmp_path, reg, model)
    try:
        mgr.save(_port(s1), step=10)
        mgr.save(_port(s2), step=20)
        svc = WeightService(mgr, _like(model), device="cpu", step=10)
        assert svc.step == 10
        stats = svc.poll()
        assert stats is not None and svc.step == 20
        assert stats["units_swapped"] > 0
        assert stats["units_swapped"] + stats["units_skipped"] == len(
            model.layer_units())
        cold = _cold(mgr, model, 20)
        _assert_params_equal(svc.current(), cold)
        assert stats["bytes_read"] < mgr.last_restore_stats["bytes_read"]
        assert stats["peak_device_bytes"] is None      # CPU
    finally:
        mgr.close()


def test_swap_scatter_is_dirty_block_sized(tmp_path, setup):
    """One unit drifts: only it is read and moved, through the scatter
    path, by dirty blocks; a repeat poll is a no-op."""
    model, reg, s1, _ = setup
    mgr = _mgr(tmp_path, reg, model)
    try:
        st = _port(s1)
        mgr.save(st, step=10)
        unit = model.layer_units()[1].name
        with torch.no_grad():
            for _, x in flatten_with_paths(reg.extract_unit(st["params"],
                                                            unit)):
                x.view(-1)[:1] += 1
        mgr.save(st, step=20)
        svc = WeightService(mgr, _like(model), device="cpu", step=10)
        served = svc.current()
        stats = svc.poll()
        n_units = len(model.layer_units())
        assert stats["units_swapped"] == 1
        assert stats["units_skipped"] == n_units - 1
        assert stats["units_scattered"] == 1 and stats["units_full"] == 0
        total = sum(x.numel() * x.element_size()
                    for _, x in flatten_with_paths(svc.current()))
        assert 0 < stats["h2d_bytes"] < total // 10
        assert stats["blocks_applied"] > 0
        _assert_params_equal(svc.current(), _cold(mgr, model, 20))
        # copy-on-write: the served tree of step 10 was never written, and
        # leaves the swap did not touch are shared, not copied
        _assert_params_equal(served, _cold(mgr, model, 10))
        assert svc.current()["embed"]["w"] is served["embed"]["w"]
        assert svc.poll() is None
    finally:
        mgr.close()


def test_swap_across_skipped_manifests(tmp_path, setup):
    """10 -> 40 in one swap across manifests never served."""
    model, reg, s1, _ = setup
    mgr = _mgr(tmp_path, reg, model)
    try:
        st = _port(s1)
        mgr.save(st, step=10)
        for step in (20, 30, 40):
            with torch.no_grad():
                for _, x in flatten_with_paths(st["params"]):
                    x.add_(1)
            mgr.save(st, step=step)
        svc = WeightService(mgr, _like(model), device="cpu", step=10)
        stats = svc.poll()
        assert stats["step_from"] == 10 and stats["step_to"] == 40
        _assert_params_equal(svc.current(), _cold(mgr, model, 40))
    finally:
        mgr.close()


def test_swap_rollback_to_older_manifest(tmp_path, setup):
    """LATEST pointed back at an older step swaps back bit for bit."""
    model, reg, s1, s2 = setup
    mgr = _mgr(tmp_path, reg, model)
    try:
        mgr.save(_port(s1), step=10)
        mgr.save(_port(s2), step=20)
        svc = WeightService(mgr, _like(model), device="cpu", step=20)
        mgr.manifests.commit(mgr.manifests.load(10))
        stats = svc.poll()
        assert stats["step_to"] == 10
        _assert_params_equal(svc.current(), _cold(mgr, model, 10))
    finally:
        mgr.close()


def test_swap_apply_crash_leaves_old_weights_serving(tmp_path, setup):
    """A crash at the second changed unit publishes nothing; the next poll
    completes the same swap."""
    model, reg, s1, s2 = setup
    mgr = _mgr(tmp_path, reg, model)
    try:
        mgr.save(_port(s1), step=10)
        mgr.save(_port(s2), step=20)
        svc = WeightService(mgr, _like(model), device="cpu", step=10)
        before = svc.current()
        served_before = dict(svc._served)
        with faults.scoped("swap_apply", hit=2):
            with pytest.raises(InjectedCrash):
                svc.poll()
        assert svc.step == 10
        assert svc._served == served_before
        assert svc.current() is before
        _assert_params_equal(svc.current(), _cold(mgr, model, 10))
        stats = svc.poll()
        assert stats is not None and svc.step == 20
        _assert_params_equal(svc.current(), _cold(mgr, model, 20))
    finally:
        mgr.close()


def test_shard_set_entries_raise(tmp_path, setup):
    model, reg, s1, _ = setup
    mgr = _mgr(tmp_path, reg, model)
    try:
        mgr.save(_port(s1), step=10)
        svc = WeightService(mgr, _like(model), device="cpu", step=10)
        m = mgr.manifests.load(10)
        unit = model.layer_units()[1].name
        ref = m.entries[unit]["weights"]
        shards = (ChunkRef(**{**ref.to_json(), "digest": "a" * 40}),
                  ChunkRef(**{**ref.to_json(), "digest": "b" * 40}))
        entries = {u: dict(k) for u, k in m.entries.items()}
        entries[unit]["weights"] = shards
        with pytest.raises(SwapError, match="A3"):
            svc.swap(Manifest(step=30, entries=entries))
        assert svc.step == 10
    finally:
        mgr.close()


def test_missing_manifest_raises(tmp_path, setup):
    model, reg, s1, _ = setup
    mgr = _mgr(tmp_path, reg, model)
    try:
        mgr.save(_port(s1), step=10)
        with pytest.raises(SwapError):
            WeightService(mgr, _like(model), device="cpu", step=99)
    finally:
        mgr.close()


def _opt_digests(mgr):
    return {r.digest for s in mgr.manifests.all_steps()
            for kinds in mgr.manifests.load(s).entries.values()
            for k, r in kinds.items() if k == "opt"}


def test_weights_only_restore_opens_no_optimizer_object(tmp_path, setup):
    model, reg, s1, s2 = setup
    mgr = _mgr(tmp_path, reg, model)
    try:
        mgr.save(_port(s1), step=10)
        mgr.save(_port(s2), step=20)
        opened = []
        read = mgr.store.read_envelope

        def spy(digest, *a, **kw):
            opened.append(digest)
            return read(digest, *a, **kw)

        mgr.store.read_envelope = spy
        full = mgr.restore(_like(model), device=CPU, step=20)
        full_bytes = mgr.last_restore_stats["bytes_read"]
        assert _opt_digests(mgr) & set(opened)
        opened.clear()
        part = mgr.restore({"params": _like(model)["params"]}, device=CPU,
                           parts=("params",), step=20)
        assert opened and not _opt_digests(mgr) & set(opened)
        assert set(part) == {"params", "step"}
        assert mgr.last_restore_stats["bytes_read"] < full_bytes
        _assert_params_equal(part["params"], full["params"])
        # a caller-supplied manifest replaces the step lookup
        m10 = mgr.manifests.load(10)
        got = mgr.restore({"params": _like(model)["params"]}, device=CPU,
                          parts=("params",), manifest=m10)
        assert int(got["step"]) == 10
        _assert_params_equal(got["params"], _cold(mgr, model, 10))
    finally:
        mgr.close()


def test_read_session_reads_each_object_once(tmp_path, setup):
    model, reg, s1, s2 = setup
    mgr = _mgr(tmp_path, reg, model)
    try:
        mgr.save(_port(s1), step=10)
        mgr.save(_port(s2), step=20)
        ref = mgr.manifests.load(20).entries["embed"]["weights"]
        assert ref.stored == "delta"
        session = ReadSession(mgr.store)
        tree, fp_blob = session.read(ref.digest)
        assert session.stats["object_reads"] == 2        # delta + base
        assert session.stats["bytes_read"] == (
            mgr.store.object_size(ref.digest)
            + mgr.store.object_size(ref.delta_base))
        assert session.read(ref.digest)[0] is tree
        session.envelope(ref.delta_base)
        assert session.stats["object_reads"] == 2
        assert fp_blob is not None
        _assert_params_equal(tree, reg.extract_unit(_cold(mgr, model, 20),
                                                    "embed"))
    finally:
        mgr.close()


# ------------------------------------------------------------ across packages
def _jax_store(root, s1, s2, drift):
    jmodel = jax_build_model(jax_get_config(ARCH, reduced=True))
    jreg = JaxRegistry(jmodel)
    mgr = JaxManager(root, jreg,
                     jax_make_policy("full", jmodel.layer_units()),
                     codec="none", async_save=False, fp_block_bytes=BB)
    mgr.save(s1, step=10)
    if drift == "one":
        unit = jmodel.layer_units()[1].name
        p2 = jreg.insert_unit(dict(s1["params"]), unit, _poke_np(
            jreg.extract_unit(s1["params"], unit)))
        s2 = {"step": s1["step"], "params": p2, "opt": s1["opt"]}
    mgr.save(s2, step=20)
    return jmodel, mgr


@pytest.mark.parametrize("drift", ["all", "one"])
def test_port_swap_on_a_jax_store_matches_the_jax_service(tmp_path, setup,
                                                          drift):
    """On a store the JAX package wrote (codec none, 4 KiB blocks), the
    port's service gives weights equal byte for byte to the JAX service's
    and the same unit counts."""
    model, reg, s1, s2 = setup
    jmodel, jmgr = _jax_store(tmp_path, s1, s2, drift)
    try:
        jsvc = JaxWeightService(jmgr, jax_steps.state_specs(jmodel), step=10)
        jstats = jsvc.poll()
        want = jax.tree.map(np.asarray, jsvc.current())
    finally:
        jmgr.close()
    mgr = _mgr(tmp_path, reg, model)
    try:
        svc = WeightService(mgr, _like(model), device="cpu", step=10)
        stats = svc.poll()
        got = state_to_numpy(svc.current())
    finally:
        mgr.close()
    assert {k: stats[k] for k in SWAP_COUNTS} == \
        {k: jstats[k] for k in SWAP_COUNTS}
    assert stats["units_scattered"] > 0
    fw, fg = flatten_with_paths(want), flatten_with_paths(got)
    assert [p for p, _ in fw] == [p for p, _ in fg]
    for (p, w), (_, g) in zip(fw, fg):
        assert w.tobytes() == g.tobytes(), p


def test_serve_hot_swap_from_a_port_store(tmp_path, setup):
    """``serve`` cold-loads step 10, hot-swaps to 20 and generates the same
    tokens as a server cold-loaded at 20."""
    model, reg, s1, s2 = setup
    mgr = _mgr(tmp_path, reg, model)
    mgr.save(_port(s1), step=10)
    mgr.save(_port(s2), step=20)
    mgr.close()
    kw = dict(arch=ARCH, batch=2, prompt_len=8, new_tokens=3,
              from_ckpt=str(tmp_path), device="cpu")
    hot = serve(from_step=10, hot_swap=True, swap_wait=0.0, **kw)
    cold = serve(**kw)
    assert hot["served_step"] == cold["served_step"] == 20
    assert hot["restore"]["step"] == 10 and hot["swap"]["step_to"] == 20
    assert hot["tokens_digest"] == cold["tokens_digest"]
    assert cold["swap"] is None
