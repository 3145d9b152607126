"""The process half of the port's IO stack (``io_backend="process"``):
subprocess workers over shared memory, held against the thread backend
and the JAX package.

A process-backend store is byte-identical to a thread-backend store and to
the JAX package's (manifest entries and object files), on the fingerprint
and the canonical path, codec none and int8, with inline writes and with
the asynchronous ones, and through the tiered backend (its spills in the
workers), and a resume from each gives the same state; a crash mid-event
leaves the previous manifest authoritative.  Then
the workers' hygiene (neither torch nor jax in a worker; no ``/dev/shm``
segment outlives its pool; a dead owner's segments are swept), the error
kinds (a worker's failure raises what the inline path raises), and the
failure modes (a killed worker fails its task loudly and is respawned; a
pool whose workers cannot start raises).  Every pool here holds at most
two workers.

The JAX side runs with ``repro.checkpoint.workers.HAVE_ZSTD`` patched to
False, as ``tests/test_torch_int8.py`` does: its int8 records are then
``comp: none``, as the port writes them.
"""
import glob
import os
import signal
import subprocess
import sys
import threading
import time

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
from repro.launch import steps as jax_steps
from repro.models import build_model as jax_build_model
from repro_torch.checkpoint import _msgpack, async_io, faults, workers
from repro_torch.checkpoint.async_io import (INLINE_DISPATCH, AsyncWriteError,
                                             IoDispatch, ProcessWorkerPool,
                                             TransferPool)
from repro_torch.checkpoint.overlap import OverlappedSaver
from repro_torch.checkpoint.saver import CheckpointManager
from repro_torch.checkpoint.serial import ChunkCorruption
from repro_torch.configs import get_config
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core.layer_registry import LayerRegistry
from repro_torch.core.policies import make_policy
from repro_torch.launch import steps
from repro_torch.models import build_model

torch.set_num_threads(1)

ARCH = "llama3.2-3b"
BB = 4096
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _jax_without_zstd(monkeypatch):
    monkeypatch.setattr(jax_workers, "HAVE_ZSTD", False)


def _own_shm():
    """Shared-memory files this process's pools created."""
    return sorted(glob.glob(f"/dev/shm/repro-io-{os.getpid():x}-*"))


@pytest.fixture(scope="module")
def states():
    """A JAX-initialized state (numpy) and two drifts of it: a few
    elements of block_001 (block deltas, XOR deltas) and every leaf's
    first element (every (unit, kind) written again)."""
    model = jax_build_model(jax_get_config(ARCH, reduced=True))
    s0 = jax.tree.map(np.asarray,
                      jax_steps.init_state(model, jax.random.key(0)))
    rng = np.random.RandomState(1)
    s1 = jax.tree.map(np.array, s0)
    for tree in (s1["params"], s1["opt"]["master"], s1["opt"]["m"]):
        w = tree["blocks"]["mlp"]["w_gate"]
        w[1, 0, :5] = (w[1, 0, :5].astype(np.float32)
                       + rng.rand(5).astype(np.float32)).astype(w.dtype)

    def poke(x):
        x = np.array(x)
        if x.size:
            x.flat[:1] += 1
        return x

    s2 = {"step": s1["step"], "params": jax.tree.map(poke, s1["params"]),
          "opt": jax.tree.map(poke, s1["opt"])}
    return model, (s0, s1, s2)


def _port_model():
    model = build_model(get_config(ARCH, reduced=True))
    return model, LayerRegistry(model)


def _port_mgr(root, *, io_backend="thread", policy="parity", **kw):
    model, reg = _port_model()
    return CheckpointManager(root, reg,
                             make_policy(policy, model.layer_units()),
                             fp_block_bytes=BB, io_backend=io_backend,
                             io_workers=2, **kw)


def _entries(mgr, step):
    m = mgr.manifests.load(step)
    return {u: {k: (r.digest, r.stored, r.delta_base, r.nbytes, r.step)
                for k, r in kinds.items()}
            for u, kinds in m.entries.items()}


def _objects(root):
    return {p.name: p.read_bytes()
            for p in sorted((root / "objects").glob("*/*.chunk"))}


def _np(state):
    return state_to_numpy({"params": state["params"], "opt": state["opt"]},
                          bf16_dtype=ml_dtypes.bfloat16)


def _assert_np_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


EVENTS = ((1, 0), (2, 1), (3, 1), (4, 2))     # (step, state index)


def _save_port(root, io_backend, codec, fingerprint, mode, states_):
    """The four events through the port; ``mode`` "sync" writes inline,
    "async" through the overlapped saver on the fingerprint path and the
    async writer on the canonical path (the overlapped saver takes the
    fingerprint path only)."""
    mgr = _port_mgr(root, io_backend=io_backend, codec=codec,
                    fingerprint=fingerprint, async_save=mode == "async")
    ov = OverlappedSaver(mgr, spread_steps=2) \
        if mode == "async" and fingerprint else None
    events = []
    for step, si in EVENTS:
        st = state_from_numpy(states_[si], "cpu")
        if ov is not None:
            ov.begin(st, step)
            assert ov.finish().step == step
        else:
            mgr.save(st, step=step)
        events.append(dict(mgr.last_save_stats))
    entries = {s: _entries(mgr, s) for s, _ in EVENTS}
    if ov is not None:
        ov.close()
    mgr.close()
    return entries, events


@pytest.mark.process_io
@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("fingerprint", [True, False],
                         ids=["fingerprint", "canonical"])
@pytest.mark.parametrize("codec", ["none", "int8"])
def test_conformance_matrix_bit_exact(states, tmp_path, codec, fingerprint,
                                      mode):
    """Thread backend, process backend and the JAX package: the same
    manifest entries and object files at every step; a fresh manager on
    each port store (a new worker fleet on the process one) restores the
    JAX package's restore of its own store, bit for bit, with the workers
    doing the decodes on the process backend."""
    jmodel, states_ = states
    jm = JaxManager(tmp_path / "jax", JaxRegistry(jmodel),
                    jax_make_policy("parity", jmodel.layer_units()),
                    codec=codec, async_save=False, fp_block_bytes=BB,
                    fingerprint=fingerprint)
    for step, si in EVENTS:
        jm.save(states_[si], step=step)
    jentries = {s: _entries(jm, s) for s, _ in EVENTS}
    want = jax.tree.map(np.asarray, jm.restore(jax_steps.state_specs(jmodel)))
    jm.close()
    pmodel, _ = _port_model()
    restored = {}
    for be in ("thread", "process"):
        entries, events = _save_port(tmp_path / be, be, codec, fingerprint,
                                     mode, states_)
        assert entries == jentries, be
        assert _objects(tmp_path / be) == _objects(tmp_path / "jax"), be
        assert {e["io_backend"] for e in events} == {be}
        if be == "process":
            w = events[0]["workers"]
            assert w["worker_restarts"] == 0
            assert sum(l["tasks"] for l in w["lanes"].values()) > 0
            assert sum(l["bytes_shm"] for l in w["lanes"].values()) > 0
        else:
            assert "workers" not in events[0]
        mgr = _port_mgr(tmp_path / be, io_backend=be, codec=codec,
                        async_save=False)
        got = mgr.restore(steps.state_specs(pmodel), device=CPU)
        rs = dict(mgr.last_restore_stats)
        mgr.close()
        assert int(got["step"]) == 4 and not rs["fallback_units"]
        assert rs["io_backend"] == be and rs["pipelined"]
        if be == "process":
            assert rs["workers"]["tasks"] > 0
            assert rs["workers"]["worker_restarts"] == 0
        restored[be] = _np(got)
    _assert_np_equal(restored["thread"], restored["process"])
    _assert_np_equal(restored["process"],
                     {"params": want["params"], "opt": want["opt"]})
    assert not _own_shm()


@pytest.mark.process_io
def test_tiered_store_parity_thread_vs_process(states, tmp_path):
    """Through the tiered backend the disk tier's writes (the spills, on
    the spill lane) run in the workers: the same disk tree as the thread
    backend's, and a new manager restores it from the disk alone."""
    _, (s0, s1, s2) = states
    pmodel, _ = _port_model()
    got = {}
    for be in ("thread", "process"):
        mgr = _port_mgr(tmp_path / be, io_backend=be, policy="full",
                        store_backend="tiered", async_save=False)
        for step, st in ((1, s0), (2, s1), (3, s2)):
            mgr.save(state_from_numpy(st, "cpu"), step=step)
        mgr.drain_spill()
        if be == "process":
            lanes = mgr.last_save_stats["workers"]["lanes"]
            assert lanes["spill"]["tasks"] > 0
        mgr.close()
        again = _port_mgr(tmp_path / be, io_backend=be, async_save=False)
        got[be] = _np(again.restore(steps.state_specs(pmodel), device=CPU))
        again.close()
    assert _objects(tmp_path / "thread") == _objects(tmp_path / "process")
    _assert_np_equal(got["thread"], got["process"])
    _assert_np_equal(got["process"], {"params": s2["params"],
                                      "opt": s2["opt"]})
    assert not _own_shm()


@pytest.mark.process_io
@pytest.mark.parametrize("point", ["gather", "object_write",
                                   "manifest_commit"])
def test_crash_points_on_the_process_backend(states, tmp_path, point):
    """A crash mid-event on the process backend leaves the previous
    manifest authoritative, and it restores bit for bit with no
    fallback."""
    _, (s0, _, s2) = states
    pmodel, _ = _port_model()
    faults.disarm()
    mgr = _port_mgr(tmp_path, io_backend="process", policy="full")
    mgr.save(state_from_numpy(s0, "cpu"), step=10)
    try:
        with faults.scoped(point):
            with pytest.raises((faults.InjectedCrash, AsyncWriteError)):
                mgr.save(state_from_numpy(s2, "cpu"), step=20)
        assert not faults.pending()
    finally:
        faults.disarm()
        try:
            mgr.close()
        except (AsyncWriteError, faults.InjectedCrash):
            pass
    again = _port_mgr(tmp_path, io_backend="process", async_save=False)
    assert again.manifests.latest_step() == 10
    got = again.restore(steps.state_specs(pmodel), device=CPU)
    assert int(got["step"]) == 10
    assert not again.last_restore_stats["fallback_units"]
    _assert_np_equal(_np(got), {"params": s0["params"], "opt": s0["opt"]})
    again.close()
    assert not _own_shm()


@pytest.mark.process_io
def test_gc_parity_thread_vs_process(states, tmp_path):
    """Retention GC sweeps the same objects under either backend, and the
    latest event still restores bit for bit."""
    _, (s0, _, s2) = states
    pmodel, _ = _port_model()
    survivors = {}
    for be in ("thread", "process"):
        mgr = _port_mgr(tmp_path / be, io_backend=be, policy="full", keep=1)
        mgr.save(state_from_numpy(s0, "cpu"), step=10)
        mgr.save(state_from_numpy(s2, "cpu"), step=20)
        assert mgr.manifests.all_steps() == [20]
        survivors[be] = sorted(mgr.store.iter_digests())
        got = mgr.restore(steps.state_specs(pmodel), device=CPU)
        _assert_np_equal(_np(got), {"params": s2["params"],
                                    "opt": s2["opt"]})
        mgr.close()
    assert survivors["thread"] == survivors["process"]
    assert not _own_shm()


@pytest.mark.process_io
def test_workers_load_neither_torch_nor_jax():
    pool = ProcessWorkerPool(1)
    try:
        info = pool.call("ping")
        assert info["pid"] != os.getpid()
        assert info["torch"] is False and info["jax"] is False
        mods = pool.call("modules")
        bad = [m for m in mods
               if m.split(".")[0] in ("torch", "jax", "jaxlib", "repro")]
        assert not bad, bad
        assert "repro_torch.checkpoint.workers" in mods
    finally:
        pool.close()


@pytest.mark.process_io
@pytest.mark.parametrize("backend", ["thread", "process"])
def test_worker_errors_map_to_inline_exceptions(tmp_path, backend):
    """A task's failure raises the same exception type on either backend
    (the process backend maps the worker's error kind back)."""
    tp = TransferPool(2, worker_backend=backend, io_workers=1,
                      shm_min_bytes=1024)
    try:
        d = tp.dispatch
        assert d.backend == backend
        with pytest.raises(ChunkCorruption):
            d.call("decode_object", b"not msgpack", "ab" * 20, None, True)
        with pytest.raises(ChunkCorruption):
            d.call("decode_object", b"\x81\xa1v\x07", "ab" * 20, None, True)
        # a compressed XD01 body that is no zstd frame: corrupt
        with pytest.raises(ChunkCorruption, match="zstd"):
            d.call("delta_decode", b"XD01\x01" + b"\x00" * 2000, b"")
        with pytest.raises(FileNotFoundError):
            d.call("file_read", str(tmp_path / "missing" / "nope.chunk"))
        with pytest.raises(AsyncWriteError if backend == "process"
                           else RuntimeError, match="kaput"):
            d.call("boom", "kaput")
        if backend == "process":
            # the pool survives its tasks' errors
            assert tp.workers.stats()["worker_restarts"] == 0
        assert d.call("echo", 7) == 7
    finally:
        tp.close()
    assert not _own_shm()


@pytest.mark.process_io
def test_worker_file_io_roundtrip_via_shm(tmp_path):
    pool = ProcessWorkerPool(1, shm_min_bytes=1024)
    try:
        data = os.urandom(200_000)
        path = str(tmp_path / "ab" / "obj.chunk")
        blob = _msgpack.Blob([data[:70_000], data[70_000:]])
        assert pool.call("file_write_atomic", path, blob, False,
                         "deadbeef-1") == len(data)
        got = pool.call("file_read", path, alloc=bytearray)
        assert bytes(got) == data
        # the worker renamed its tmp file into place
        assert os.listdir(tmp_path / "ab") == ["obj.chunk"]
        st = pool.stats()["lanes"]["io"]
        assert st["bytes_shm"] >= 2 * len(data) and st["tasks"] == 2
        assert st["shm_seconds"] > 0
    finally:
        pool.close()
    assert not _own_shm()


@pytest.mark.process_io
def test_pool_start_sweeps_dead_owner_shm_debris():
    """A killed process cannot unlink its own segments: the next pool's
    start removes files whose creator pid is dead, and leaves a live
    pid's alone."""
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    dead = f"/dev/shm/repro-io-{proc.pid:x}-feed00-s1"
    live = f"/dev/shm/repro-io-{os.getpid():x}-feed00-s1"
    for p in (dead, live):
        with open(p, "wb") as f:
            f.write(b"x")
    try:
        pool = ProcessWorkerPool(1)
        pool.close()
        assert not os.path.exists(dead)
        assert os.path.exists(live)
    finally:
        for p in (dead, live):
            try:
                os.unlink(p)
            except OSError:
                pass


@pytest.mark.process_io
@pytest.mark.parametrize("backend", ["thread", "process"])
def test_drain_lane_isolated_from_flooded_lane(backend):
    """Draining one lane neither waits on nor takes the errors of a lane
    flooded with slow and failing work."""
    tp = TransferPool(4, worker_backend=backend, io_workers=2)
    gate = threading.Event()
    try:
        blockers = [tp.submit("slow", gate.wait, 30) for _ in range(3)]
        p = tp.submit_task("fast", "echo", 42)
        t0 = time.time()
        tp.drain("fast")
        assert time.time() - t0 < 5.0
        assert p.result() == 42
        assert tp.outstanding("slow") == 3
        tp.submit_task("slow", "boom", "flooded")
        gate.set()
        tp.drain("fast")
        with pytest.raises(AsyncWriteError, match="lane 'slow'"):
            tp.drain("slow")
        assert tp.outstanding("slow") == 0
        assert all(b.result() for b in blockers)
        assert tp.stats()["lanes"]["fast"]["tasks"] == 1
    finally:
        gate.set()
        tp.close()
    assert not _own_shm()


@pytest.mark.process_io
def test_worker_sigkill_mid_task_fails_loudly_and_respawns():
    pool = ProcessWorkerPool(1, shm_min_bytes=1024)
    try:
        pid0 = pool.worker_pids()[0]
        res = {}

        def victim():
            try:
                pool.call("sleep", 30.0)
            except BaseException as e:  # noqa: BLE001
                res["exc"] = e

        th = threading.Thread(target=victim)
        th.start()
        time.sleep(0.5)
        os.kill(pid0, signal.SIGKILL)
        th.join(timeout=30)
        assert not th.is_alive(), "a call hung on a killed worker"
        assert isinstance(res.get("exc"), AsyncWriteError)
        assert str(pid0) in str(res["exc"])
        assert pool.stats()["worker_restarts"] == 1
        assert pool.call("ping")["pid"] != pid0
    finally:
        pool.close()
    assert not _own_shm()


@pytest.mark.process_io
def test_worker_death_mid_sequence_prior_event_survives(states, tmp_path):
    """Kill every worker between events: the next save fails loudly on
    the write lane's drain, the workers are respawned, a retry of the step
    commits, and both events restore bit for bit."""
    _, (s0, _, s2) = states
    pmodel, _ = _port_model()
    mgr = _port_mgr(tmp_path, io_backend="process", policy="full")
    mgr.save(state_from_numpy(s0, "cpu"), step=10)
    for pid in mgr.transfer_pool.workers.worker_pids():
        os.kill(pid, signal.SIGKILL)
    with pytest.raises(AsyncWriteError):
        mgr.save(state_from_numpy(s2, "cpu"), step=20)
    assert mgr.manifests.latest_step() == 10
    assert mgr.transfer_pool.workers.stats()["worker_restarts"] >= 1
    assert mgr.save(state_from_numpy(s2, "cpu"), step=20).step == 20
    like = steps.state_specs(pmodel)
    for step, st in ((10, s0), (20, s2)):
        got = mgr.restore(like, device=CPU, step=step)
        _assert_np_equal(_np(got), {"params": st["params"],
                                    "opt": st["opt"]})
    mgr.close()
    assert not _own_shm()


@pytest.mark.process_io
def test_no_segment_outlives_its_pool():
    """Payloads above the threshold ride arena segments and worker scratch
    files while the pool lives; close() unlinks every one."""
    tp = TransferPool(2, worker_backend="process", io_workers=2,
                      shm_min_bytes=1024)
    data = np.random.RandomState(0).bytes(300_000)
    pend = [tp.submit_task("io", "canonical_object",
                           _msgpack.packb(
                               {"v": 1, "format": "full", "codec": "none",
                                "base": None, "payload": data}),
                           workers.blake2_hex(data), None, True)
            for _ in range(6)]
    tp.drain("io")
    assert all(bytes(p.result()) == data for p in pend)
    assert _own_shm(), "no segment was used"
    assert tp.workers.arena.segment_names()
    tp.close()
    assert not _own_shm()


@pytest.mark.process_io
def test_pool_whose_workers_cannot_start_raises(monkeypatch):
    """No quiet inline fallback: a worker that exits at start-up fails the
    pool's construction, and the manager's."""
    monkeypatch.setattr(async_io, "_BOOTSTRAP", "import sys; sys.exit(3)")
    with pytest.raises(AsyncWriteError, match="failed to start"):
        ProcessWorkerPool(2)
    with pytest.raises(AsyncWriteError, match="failed to start"):
        TransferPool(2, worker_backend="process")
    assert not _own_shm()


def test_unknown_io_backend_raises(tmp_path):
    with pytest.raises(ValueError, match="io_backend"):
        _port_mgr(tmp_path, io_backend="fiber")
    with pytest.raises(ValueError, match="worker_backend"):
        TransferPool(2, worker_backend="fiber")


def test_inline_dispatch_runs_the_worker_functions():
    """The thread backend's dispatch is the same code in this process."""
    assert INLINE_DISPATCH.backend == "thread"
    assert not INLINE_DISPATCH.is_process and INLINE_DISPATCH.stats() is None
    assert IoDispatch().call("echo", b"abc") == 3
    items = [("w", (3,), "float32", np.arange(3, dtype=np.float32).tobytes())]
    blob = INLINE_DISPATCH.call("encode_chunk", items, {"k": 1})
    meta, back = workers.decode_chunk_items(
        b"".join(bytes(p) for p in blob.parts))
    assert meta == {"k": 1} and bytes(back[0][3]) == items[0][3]


@pytest.mark.process_io
def test_stress_interleaved_submit_drain():
    """Hundreds of worker tasks submitted and drained from six threads
    over three lanes finish in bounded time with exact task accounting,
    no restart and no segment left."""
    tp = TransferPool(4, worker_backend="process", io_workers=2,
                      shm_min_bytes=1024)
    errors = []
    per_thread, n_threads = 60, 6

    def hammer(idx):
        rs = np.random.RandomState(idx)
        lane = f"lane{idx % 3}"
        for i in range(per_thread):
            tp.submit_task(lane, "echo", rs.bytes(int(rs.randint(16, 5000))))
            if i % 7 == idx % 7:
                try:
                    tp.drain(lane)
                except AsyncWriteError as e:  # pragma: no cover
                    errors.append(e)

    threads = [threading.Thread(target=hammer, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "the stress run hung"
    for lane in ("lane0", "lane1", "lane2"):
        tp.drain(lane)
    assert not errors
    st = tp.stats()
    assert sum(l["tasks"] for l in st["lanes"].values()) \
        == per_thread * n_threads
    assert sum(l["worker_tasks"] for l in st["lanes"].values()) \
        == per_thread * n_threads
    assert st["worker_restarts"] == 0
    tp.close()
    assert not _own_shm()


@pytest.mark.process_io
def test_stress_close_races_submitters():
    """close() racing live submitters: accepted work drains, a late
    submitter gets AsyncWriteError, nothing hangs, no segment is left."""
    for _ in range(3):
        tp = TransferPool(3, worker_backend="process", io_workers=2,
                          shm_min_bytes=1024)

        def submitter():
            while True:
                try:
                    tp.submit_task("w", "echo", b"x" * 2048)
                except AsyncWriteError:
                    return

        threads = [threading.Thread(target=submitter) for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.15)
        tp.close()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads), "a submitter hung"
        assert not _own_shm()
