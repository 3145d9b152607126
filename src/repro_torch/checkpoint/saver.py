"""CheckpointManager — LLMTailor's selective, layer-wise checkpointing in
the port.

Save path (the fingerprint path, the default), per event:
  1. the policy picks this event's layer units (every unit on the first
     event, so later manifests always reference a complete base),
  2. for each selected (unit, kind) the ``block_fp`` kernel reduces the
     unit's device tensors to per-block checksum pairs in one launch, and
     the pairs are compared on the device with the unit's previous vector:
     - unchanged: a dedup hit by the stored digest, with no payload moved
       device->host and nothing hashed or written,
     - changed: only the dirty blocks are gathered and copied to the host
       (all of the unit's bytes when there is no usable base or too many
       blocks changed), in one batched copy into pinned memory; with
       ``codec="int8"`` every unit is written whole and its float leaves
       of at least 256 elements are quantized on the device first (the
       ``quantize`` kernel, one launch per unit), so only their int8 values
       and scales cross to the host,
  3. the chunk store writes a block-sparse delta or a full object: on the
     async writer's threads (``async_save=True``, the default), while the
     training thread fingerprints and gathers the next unit, or inline
     (``async_save=False``),
  4. once every object has landed, the manifest commits last through
     ``_commit_event``, the one commit seam shared with the overlapped
     saver (``checkpoint/overlap.py``): every unit maps to the newest object
     holding it (units skipped this event keep their previous refs — the
     implicit Frankenstein merge),
  5. refcounted GC drops manifests beyond ``keep`` and unreferenced
     objects.

``fingerprint=False`` selects the canonical (legacy full-gather) path of
step 2: each selected unit crosses to the host whole, in one batched copy
into pinned memory (with ``codec="int8"``, its eligible leaves are also
quantized on the device and their records copied beside it), and the
store addresses the object by the blake2b of the unit's canonical payload
and writes it full or as an XOR delta (XD01) against the unit's previous
full object (``ChunkStore.write``); no fingerprint is taken.  Where that
base is an fp object (a store that switched paths across a restart), its
table is checked on the unit's device before the XOR
(``restore.device_materializer``).  Objects of both paths coexist in one
store and restore alike; the overlapped saver takes the fingerprint path
only.

Restore (``restore``) is the streaming restore of
``repro_torch.checkpoint.restore`` on ``restore_threads`` reader threads,
checking what it reads unless ``restore_verify=False``.

IO backend (``io_backend``, the JAX manager's knob): "thread" runs the
byte work of writes and restores in this process; "process" runs it in
``io_workers`` subprocess workers (``async_io.ProcessWorkerPool``), and
then always builds a transfer pool, for synchronous saves too.  The
stores are byte-identical either way; ``last_save_stats`` records the
``io_backend`` and, on the process backend, the event's worker traffic
per lane (``workers``).

Storage tiers (``store_backend``, the JAX manager's knob): "local" (the
POSIX tree), "memory" (volatile RAM), "tiered" (a RAM hot tier spilling to
the disk tree on the pool's ``spill`` lane), "remote" (the simulated
bucket) or "remote3" (RAM -> disk -> remote).  One transfer pool carries
the write lane and the spill lanes; a commit records the backend's
durability under ``meta["storage"]`` and, with ``spill_barrier`` (or a
save's ``durability_barrier=True``), first waits until every object is on
the durable tier.

Block cache (``block_cache``, ``block_cache_bytes``, ``block_cache_shm``,
the JAX manager's knobs): a ``checkpoint.block_cache.BlockCache`` under
every object read of the store, so the variants and hot-swaps a serving
process materializes read each shared object off the backend once.  A
cache passed in may be shared across managers and is never closed here;
``block_cache_bytes`` builds one this manager owns and closes.

Crash points (``checkpoint/faults.py``): ``fingerprint`` after a unit's
device fingerprint pass, ``gather`` after its payload crossed to the host,
``object_write`` in the store, ``manifest_commit``/``manifest_latest`` in
the manifest store, ``pool:write`` before each writer task.
"""
from __future__ import annotations

import logging
import time
from collections import Counter
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.checkpoint import faults, workers
from repro_torch.checkpoint import fingerprint as fputil
from repro_torch.checkpoint.async_io import (WORKER_BACKENDS, AsyncWriter,
                                             PendingResult, TransferPool,
                                             lane_delta)
from repro_torch.checkpoint.backends import StorageBackend, make_backend
from repro_torch.checkpoint.block_cache import BlockCache
from repro_torch.checkpoint.chunk_store import (REBASE_EVERY, ChunkRef,
                                                ChunkStore)
from repro_torch.checkpoint.restore import (DEFAULT_IO_THREADS, PARTS,
                                            RestoreEngine,
                                            device_materializer)
from repro_torch.checkpoint.serial import flatten_with_paths
from repro_torch.checkpoint.sharded import WantedFn, _usable_prev
from repro_torch.core.layer_registry import LayerRegistry
from repro_torch.core.manifest import (Manifest, ManifestStore, entry_refs,
                                       is_sharded)
from repro_torch.core.policies import CheckpointPolicy, PolicyContext
from repro_torch.dtypes import byte_view, dtype_name
from repro_torch.kernels import block_fp as bfp
from repro_torch.kernels import quantize as qz

log = logging.getLogger("repro_torch.checkpoint")

PyTree = Any

_TIMINGS = ("fingerprint_seconds", "d2h_seconds", "write_seconds")
# Above this dirty fraction a block-sparse delta stops paying (index
# overhead plus a near-full payload): write a full object instead.
MAX_DIRTY_FRAC = 0.5


def stage_to_host(srcs: Sequence[torch.Tensor]) -> List[memoryview]:
    """Copy flat uint8 tensors to the host and return one memoryview per
    source.  CUDA sources land in one pinned buffer through async copies
    and one stream sync; CPU sources are returned as views (no copy)."""
    if not srcs:
        return []
    dev = srcs[0].device
    if dev.type != "cuda":
        return [memoryview(s.numpy()) for s in srcs]
    total = sum(s.numel() for s in srcs)
    host = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    off = 0
    for s in srcs:
        host[off:off + s.numel()].copy_(s, non_blocking=True)
        off += s.numel()
    torch.cuda.current_stream(dev).synchronize()
    mv = memoryview(host.numpy())
    out, off = [], 0
    for s in srcs:
        out.append(mv[off:off + s.numel()])
        off += s.numel()
    return out


def full_sources(flat: Sequence[Tuple[str, torch.Tensor]], codec: str, *,
                 clone: bool) -> Tuple[List[torch.Tensor],
                                       List[Optional[Tuple[int, int]]]]:
    """A unit's full write on its device: one flat uint8 buffer per leaf,
    in leaf order, and each leaf's ``(n_q, n_scale)`` where the buffer is
    its int8 record.  Under codec int8 the eligible leaves are quantized in
    one launch into new buffers; the other buffers are the leaves' bytes,
    cloned first when ``clone`` (the caller lets the live tensors change
    before it copies them)."""
    quant = ([workers.int8_eligible(dtype_name(a.dtype), a.shape)
              for _, a in flat] if codec == "int8" else [False] * len(flat))
    picked = [a.detach() for (_, a), q in zip(flat, quant) if q]
    unit = qz.quantize_unit(picked) if picked else None
    srcs, recs, j = [], [], 0
    for (_, a), q in zip(flat, quant):
        if q:
            srcs.append(unit.record(j))
            recs.append((unit.n_blocks(j) * qz.QUANT_BLOCK,
                         unit.n_blocks(j)))
            j += 1
        else:
            srcs.append(byte_view(a.clone() if clone else a.detach()))
            recs.append(None)
    return srcs, recs


class CheckpointManager:
    def __init__(self, root: Path | str, registry: LayerRegistry,
                 policy: CheckpointPolicy, *, keep: int = 8,
                 fp_block_bytes: int = fputil.DEFAULT_BLOCK_BYTES,
                 async_save: bool = True, writer_threads: int = 2,
                 codec: str = "auto", fingerprint: bool = True,
                 store_backend: "str | StorageBackend" = "local",
                 spill_threads: int = 2,
                 hot_budget_bytes: Optional[int] = None,
                 spill_barrier: bool = False,
                 remote_opts: Optional[Dict[str, Any]] = None,
                 restore_threads: int = DEFAULT_IO_THREADS,
                 restore_verify: bool = True,
                 io_backend: str = "thread",
                 io_workers: Optional[int] = None,
                 block_cache: Optional[BlockCache] = None,
                 block_cache_bytes: Optional[int] = None,
                 block_cache_shm: bool = False):
        self.root = Path(root)
        self.registry = registry
        self.policy = policy
        self.fingerprint = fingerprint
        # One pool carries the write lane and the tiered backend's spill
        # lanes (remote3 has two), sized for all of them; a backend
        # instance keeps the pool it was built with.
        tiered = (not isinstance(store_backend, StorageBackend)
                  and store_backend in ("tiered", "remote3"))
        spill_lanes = 2 if store_backend == "remote3" else 1
        if io_backend not in WORKER_BACKENDS:
            raise ValueError(f"io_backend must be one of {WORKER_BACKENDS}, "
                             f"got {io_backend!r}")
        self.transfer_pool: Optional[TransferPool] = None
        # The process backend always needs a pool (it owns the workers and
        # the shared-memory arena), for synchronous saves too.
        if async_save or tiered or io_backend == "process":
            # The write lane's queue is bounded (backpressure on the
            # training thread) unless the pool carries spill lanes: a write
            # task submits a spill task, and a bounded queue could deadlock
            # with every thread blocked on a full put.
            self.transfer_pool = TransferPool(
                writer_threads + (spill_threads * spill_lanes
                                  if tiered else 0),
                max_queue=0 if tiered else 64,
                worker_backend=io_backend, io_workers=io_workers)
        dispatch = (self.transfer_pool.dispatch
                    if self.transfer_pool is not None else None)
        backend = make_backend(store_backend, self.root,
                               pool=self.transfer_pool,
                               spill_threads=spill_threads,
                               hot_budget_bytes=hot_budget_bytes,
                               remote_opts=remote_opts, dispatch=dispatch)
        # Only a cache built here is closed by ``close``.
        self._own_block_cache = (block_cache is None
                                 and block_cache_bytes is not None)
        if self._own_block_cache:
            block_cache = BlockCache(int(block_cache_bytes),
                                     shm=block_cache_shm)
        self.block_cache = block_cache
        self.store = ChunkStore(self.root, codec=codec, backend=backend,
                                dispatch=dispatch, block_cache=block_cache)
        self.manifests = ManifestStore(self.root)
        self.keep = keep
        self.restorer = RestoreEngine(self.store, self.manifests, registry,
                                      io_threads=restore_threads,
                                      verify=restore_verify)
        self.fp_block_bytes = fp_block_bytes
        self.async_save = async_save
        # False: commit once every object is on the fast tier (the manifest
        # records durable_on="hot") and let the spill overlap training;
        # True: wait for the durable tier before every commit.
        self.spill_barrier = spill_barrier
        self.writer: Optional[AsyncWriter] = (
            AsyncWriter(self.transfer_pool) if async_save else None)
        self._event_index = self._infer_event_index()
        self._rebuild_refcounts()
        # (unit, kind) -> fingerprint vector of the content behind the
        # last committed manifest entry (advanced only after a commit).
        self._fp_refs: Dict[Tuple[str, str], Any] = {}
        self.last_save_stats: Dict[str, Any] = {}
        self._commit_split: Dict[str, float] = {}

    def _infer_event_index(self) -> int:
        m = self.manifests.load()
        if m is not None and "event_index" in m.meta:
            return int(m.meta["event_index"]) + 1
        return len(self.manifests.all_steps())

    def reserve_event_index(self) -> int:
        """The index the next event will commit under.  The overlapped
        saver captures it at ``begin`` (the policy keys off the event
        counter, but the commit lands steps later) and passes it back
        through ``_commit_event(event_index=...)``."""
        return self._event_index

    def _rebuild_refcounts(self) -> None:
        """Object refcounts and per-unit delta-run lengths, derived from the
        committed manifests (neither is persisted).  A shard object's run
        is its participant's, keyed ``unit@p<pid>`` as the sharded saver
        writes it."""
        counts: Counter = Counter()
        runs: Dict[Tuple[str, str], int] = {}
        last_digest: Dict[Tuple[str, str], str] = {}
        for s in self.manifests.all_steps():
            m = self.manifests.load(s)
            if m is None:
                continue
            counts.update(m.referenced_digests())
            for unit, kinds in m.entries.items():
                for kind, entry in kinds.items():
                    for ref in entry_refs(entry):
                        ukey = (unit if ref.spec is None else
                                f"{unit}@p{ref.spec.get('participant', 0)}")
                        key = (ukey, kind)
                        if last_digest.get(key) == ref.digest:
                            continue  # carried-over entry, not a new write
                        last_digest[key] = ref.digest
                        runs[key] = (runs.get(key, 0) + 1
                                     if ref.stored == "delta" else 0)
        self.store.set_refcounts(counts)
        self.store.seed_delta_runs(runs)

    # ------------------------------------------------------------------ save
    def save(self, state: Dict[str, PyTree], *, step: Optional[int] = None,
             meta: Optional[Dict] = None,
             drift_scores: Optional[Dict[str, float]] = None,
             units: Optional[Sequence[str]] = None,
             durability_barrier: Optional[bool] = None) -> Manifest:
        """Persist one checkpoint event and commit its manifest.  ``units``
        overrides the policy's selection for this event; ``drift_scores``
        feeds the ``topk_delta`` policy; ``durability_barrier`` overrides
        ``spill_barrier`` for this event."""
        t0 = time.perf_counter()
        step = int(state["step"]) if step is None else int(step)
        ctx = PolicyContext(event_index=self._event_index, step=step,
                            drift_scores=drift_scores)
        prev = _usable_prev(self.manifests.load())
        if prev is None:
            selected = self.policy.all_units()
        elif units is not None:
            selected = list(dict.fromkeys(units))
        else:
            selected = list(dict.fromkeys(self.policy.select(ctx)))
        entries: Dict[str, Dict[str, ChunkRef]] = (
            {u: dict(k) for u, k in prev.entries.items()} if prev else {})
        self.store.reset_stats()
        sec0 = self.store.seconds_snapshot()
        workers0 = self.store.dispatch.stats()
        acc = {"d2h_bytes": 0, "blocks_moved": 0, "blocks_total": 0,
               **{k: 0.0 for k in _TIMINGS}}
        pending: Dict[Tuple[str, str], PendingResult] = {}
        new_fps: Dict[Tuple[str, str], Any] = {}
        for name in selected:
            for kind in ("weights", "opt"):
                tree = (self.registry.extract_unit(state["params"], name)
                        if kind == "weights" else
                        self.registry.extract_opt_unit(state["opt"], name))
                pref = self._prev_entry(prev, name, kind)
                if self.fingerprint:
                    res, cur = self._save_unit_fp(step, name, kind, tree,
                                                  pref, acc)
                    new_fps[(name, kind)] = cur
                else:
                    res = self._save_unit_canonical(step, name, kind, tree,
                                                    pref, acc)
                if isinstance(res, PendingResult):
                    pending[(name, kind)] = res
                else:
                    entries.setdefault(name, {})[kind] = res
        t_snapshot = time.perf_counter() - t0

        # Every object must land before the manifest commits.
        t_wb = time.perf_counter()
        if self.writer is not None:
            self.writer.drain()
            for (name, kind), p in pending.items():
                entries.setdefault(name, {})[kind] = p.result()
        t_writeback = time.perf_counter() - t_wb
        manifest, storage = self._commit_event(
            step=step, entries=entries, selected=selected, meta=meta,
            new_fps=new_fps, durability_barrier=durability_barrier)
        total = time.perf_counter() - t0
        sec1 = self.store.seconds_snapshot()
        # The synchronous save blocks the caller end to end: its stall is
        # the whole event (the overlapped saver is where they diverge).
        stats = self._event_stats(
            step=step, selected=selected, d2h_bytes=acc["d2h_bytes"],
            blocks_moved=acc["blocks_moved"],
            blocks_total=acc["blocks_total"], storage=storage,
            workers0=workers0,
            timings={"snapshot_seconds": t_snapshot,
                     "stage_seconds": 0.0,
                     "writeback_seconds": t_writeback,
                     "stall_seconds": total,
                     "total_seconds": total})
        stats.update({k: acc[k] for k in _TIMINGS})
        # host split of the object writes (summed over writer threads):
        # framing + crc32, file writes
        stats["encode_seconds"] = sec1["encode"] - sec0["encode"]
        stats["write_io_seconds"] = sec1["write_io"] - sec0["write_io"]
        stats["save_mode"] = "sync"
        self.last_save_stats = stats
        return manifest

    def _prev_entry(self, prev: Optional[Manifest], name: str,
                    kind: str) -> Optional[ChunkRef]:
        """The unit's previous global object: its dedup and delta anchor.
        A shard set anchors no global object (another payload layout), so
        a global save over a sharded chain starts the unit on a full base;
        the shard set itself still carries over for unselected units."""
        if prev is None:
            return None
        e = prev.entries.get(name, {}).get(kind)
        if e is None or is_sharded(e):
            return None
        return e

    def _commit_event(self, *, step: int, entries, selected, meta,
                      new_fps, event_index: Optional[int] = None,
                      durability_barrier: Optional[bool] = None
                      ) -> Tuple[Manifest, Dict[str, Any]]:
        """Manifest commit + refcount/GC bookkeeping: the single commit
        seam shared by ``save`` and the overlapped saver, which is what
        makes them bit-exact peers (only *when* the work ran differs).

        ``event_index`` lets an overlapped event commit under the index
        reserved when it began; the counter itself only moves forward.
        ``durability_barrier`` (``spill_barrier`` when None) waits for the
        durable tier first."""
        barrier = (self.spill_barrier if durability_barrier is None
                   else durability_barrier)
        if barrier:
            self.store.drain_spill()
        # which tier holds the event's objects at commit time
        storage = self.store.durability()
        idx = self._event_index if event_index is None else int(event_index)
        manifest = Manifest(step=step, entries=entries,
                            meta=dict(meta or {}, event_index=idx,
                                      policy=self.policy.name,
                                      storage=storage),
                            saved_units=list(selected))
        # Re-saving a step overwrites its manifest: release the replaced
        # manifest's references or its objects leak until restart.
        replaced = self.manifests.load(step)
        t0 = time.perf_counter()
        self.manifests.commit(manifest)
        t1 = time.perf_counter()
        self.store.incref(manifest.referenced_digests().elements())
        if replaced is not None:
            self.store.decref(replaced.referenced_digests().elements())
        self._event_index = max(self._event_index, idx + 1)
        # The commit is durable: only now may the references advance.
        self._fp_refs.update(new_fps)
        self.gc()
        # The manifest's fsync waits for the filesystem to write back the
        # event's objects (published unsynced); GC unlinks unreferenced ones.
        self._commit_split = {"commit_seconds": t1 - t0,
                              "gc_seconds": time.perf_counter() - t1}
        return manifest, storage

    def _event_stats(self, *, step: int, selected, d2h_bytes: int,
                     blocks_moved: int, blocks_total: int, storage,
                     workers0, timings: Dict[str, float]) -> Dict[str, Any]:
        """One event's ``last_save_stats``.  ``timings`` is the four-way
        split: ``snapshot_seconds`` (device fingerprint/gather dispatch and
        the decisions), ``stage_seconds`` (host staging of the copies),
        ``writeback_seconds`` (the drain of the writes before the commit)
        and ``stall_seconds``, the time the caller's step loop blocked;
        plus the commit's ``commit_seconds`` (manifest write and fsync) and
        ``gc_seconds``, which are part of the stall.  On the process
        backend, ``workers`` is the event's worker traffic per lane since
        ``workers0`` (the dispatch's stats when the event began)."""
        io = self.store.stats_snapshot()
        dispatch = self.store.dispatch
        stats = {
            "step": step,
            "selected_units": len(selected),
            "total_units": len(self.registry.units),
            "snapshot_bytes": d2h_bytes,
            **timings,
            **self._commit_split,
            "seconds": timings["total_seconds"],
            "d2h_bytes": d2h_bytes,
            "hashed_bytes": io["hashed_bytes"],
            "dirty_block_frac": (blocks_moved / blocks_total if blocks_total
                                 else 0.0 if self.fingerprint else 1.0),
            "logical_bytes": io["logical_bytes"],
            "written_bytes": io["written_bytes"],
            "dedup_hits": io["dedup_hits"],
            "delta_chunks": io["delta_chunks"],
            "full_chunks": io["full_chunks"],
            "backend": storage["backend"],
            "durable_on": storage["durable_on"],
            "spill_pending": storage["pending_spill"],
            "io_backend": dispatch.backend,
        }
        if workers0 is not None:
            stats["workers"] = lane_delta(workers0, dispatch.stats())
        return stats

    def _save_unit_fp(self, step: int, name: str, kind: str, tree: Any,
                      pref: Optional[ChunkRef], acc: Dict[str, Any]):
        """Fingerprint save path for one (unit, kind): returns
        ``(chunk ref or pending write, device fingerprint vectors)`` and
        adds the payload bytes/blocks that crossed device->host to
        ``acc``."""
        bb = self.fp_block_bytes
        t0 = time.perf_counter()
        cur = bfp.fingerprint_tree(tree, block_bytes=bb)
        faults.crash_point("fingerprint")
        nb_total = sum(l.n_blocks for l in cur)
        logical = sum(l.nbytes for l in cur)
        acc["blocks_total"] += nb_total

        ref_fp = self._fp_refs.get((name, kind))
        if ref_fp is None and pref is not None and pref.digest:
            ref_fp = self.store.load_fp_table(pref.digest)
        if (ref_fp is not None and pref is not None and pref.digest
                and bfp.leaves_match(cur, ref_fp)):
            acc["fingerprint_seconds"] += time.perf_counter() - t0
            return (self.store.note_dedup(step, name, kind, pref.digest,
                                          prev_ref=pref,
                                          logical_bytes=logical), cur)
        host = bfp.tree_to_host(cur)
        tblob = fputil.pack_table(host)
        digest = fputil.fp_digest(tblob)
        acc["fingerprint_seconds"] += time.perf_counter() - t0
        if self.store.has(digest):
            # Content reverted to (or collided with) an object on disk.
            return (self.store.note_dedup(step, name, kind, digest,
                                          prev_ref=pref,
                                          logical_bytes=logical), cur)

        t1 = time.perf_counter()
        flat = flatten_with_paths(tree)
        base_digest, base_tbl = self._delta_base(name, kind, pref, host)
        dirty = None
        if base_tbl is not None:
            dirty = [bfp.dirty_block_indices(h, b)
                     for h, b in zip(host, base_tbl)]
            if sum(len(d) for d in dirty) > MAX_DIRTY_FRAC * nb_total:
                dirty = None
        leaves = []
        if dirty is not None:
            srcs = [bfp.gather_blocks(arr, idx, block_bytes=bb).reshape(-1)
                    for (_, arr), idx in zip(flat, dirty) if len(idx)]
            staged = iter(stage_to_host(srcs))
            for (path, _), leaf, idx in zip(flat, host, dirty):
                data = next(staged) if len(idx) else b""
                acc["d2h_bytes"] += len(data)
                acc["blocks_moved"] += len(idx)
                leaves.append(fputil.LeafPayload(
                    path=path, shape=leaf.shape, dtype=leaf.dtype,
                    nbytes=leaf.nbytes, block_bytes=bb, idx=idx, data=data))
            packet = fputil.FingerprintPacket(
                digest=digest, table=tblob, leaves=leaves, full=False,
                base_digest=base_digest, logical_bytes=logical)
        else:
            srcs, recs = full_sources(flat, self.store.codec, clone=False)
            staged = stage_to_host(srcs)
            del srcs
            for (path, _), leaf, data, rec in zip(flat, host, staged, recs):
                acc["d2h_bytes"] += len(data)
                leaves.append(fputil.LeafPayload(
                    path=path, shape=leaf.shape, dtype=leaf.dtype,
                    nbytes=leaf.nbytes, block_bytes=bb, idx=None, data=data,
                    quant=rec))
            acc["blocks_moved"] += nb_total
            packet = fputil.FingerprintPacket(
                digest=digest, table=tblob, leaves=leaves, full=True,
                base_digest=None, logical_bytes=logical)
        # The payload has crossed device->host; nothing is written yet.
        faults.crash_point("gather")
        t2 = time.perf_counter()
        acc["d2h_seconds"] += t2 - t1
        if self.writer is not None:
            return (self.writer.submit(self.store.write_fp, step, name,
                                       kind, packet, prev_ref=pref), cur)
        ref = self.store.write_fp(step, name, kind, packet, prev_ref=pref)
        acc["write_seconds"] += time.perf_counter() - t2
        return ref, cur

    def _save_unit_canonical(self, step: int, name: str, kind: str,
                             tree: Any, pref: Optional[ChunkRef],
                             acc: Dict[str, Any]):
        """Canonical save path for one (unit, kind): the whole unit crosses
        to the host in one batched copy (under codec int8, with its
        eligible leaves' records, quantized on the device) and the store
        writes it (``ChunkStore.write``).  Returns the chunk ref or the
        pending write."""
        t1 = time.perf_counter()
        flat = flatten_with_paths(tree)
        srcs = [byte_view(a.detach()) for _, a in flat]
        quant, recs = [], []
        if self.store.codec != "none":
            qsrcs, recs = full_sources(flat, self.store.codec, clone=False)
            quant = [q for q, r in zip(qsrcs, recs) if r is not None]
        staged = stage_to_host(srcs + quant)
        acc["d2h_bytes"] += sum(len(m) for m in staged)
        del srcs, quant
        items = [(path, tuple(a.shape), dtype_name(a.dtype), data)
                 for (path, a), data in zip(flat, staged)]
        full_items = None
        if recs:
            qdata = iter(staged[len(flat):])
            full_items = [
                (path, shape, dtype, data if rec is None
                 else workers.Int8Record(next(qdata), rec[0], rec[1], shape,
                                         dtype))
                for (path, shape, dtype, data), rec in zip(items, recs)]
        materialize = device_materializer(flat[0][1].device)
        # The unit has crossed device->host; nothing is written yet.
        faults.crash_point("gather")
        t2 = time.perf_counter()
        acc["d2h_seconds"] += t2 - t1
        if self.writer is not None:
            return self.writer.submit(self.store.write, step, name, kind,
                                      items, full_items=full_items,
                                      prev_ref=pref, materialize=materialize)
        ref = self.store.write(step, name, kind, items,
                               full_items=full_items, prev_ref=pref,
                               materialize=materialize)
        acc["write_seconds"] += time.perf_counter() - t2
        return ref

    def _delta_base(self, name: str, kind: str, pref: Optional[ChunkRef],
                    metas) -> Tuple[Optional[str], Optional[list]]:
        """A structurally usable delta base for (unit, kind), or
        ``(None, None)``: the previous entry must be digest-addressed, the
        store codec lossless (a block delta patches exact bytes onto its
        base, which a lossy base cannot provide), the rebase bound unspent,
        and the base's table meta-comparable."""
        if not (pref is not None and pref.digest
                and self.store.codec not in workers.LOSSY_CODECS
                and self.store.delta_run(name, kind) < REBASE_EVERY):
            return None, None
        base_digest = (pref.digest if pref.stored == "full"
                       else pref.delta_base)
        base_tbl = (self.store.load_fp_table(base_digest)
                    if base_digest else None)
        if (base_tbl is None or len(base_tbl) != len(metas)
                or not all(m.meta_matches(b)
                           for m, b in zip(metas, base_tbl))):
            return None, None
        if (self.store.object_info(base_digest).get("codec")
                not in (None, "none", "zstd")):
            return None, None  # a lossy base cannot anchor exact patches
        return base_digest, base_tbl

    # --------------------------------------------------------------- restore
    def restore(self, state_like: Dict[str, PyTree], *,
                device: torch.device, step: Optional[int] = None,
                parts: Sequence[str] = PARTS,
                units: Optional[Sequence[str]] = None,
                pipelined: bool = True,
                owned: Optional[WantedFn] = None,
                manifest: Optional[Manifest] = None) -> Dict[str, PyTree]:
        """Rebuild the state (or, with ``parts=("params",)``, the weights
        alone, reading no optimizer object; with ``units``, the units of
        those name prefixes) from the manifest at ``step`` or the given
        ``manifest``, on ``restore_threads`` reader threads unless
        ``pipelined=False``; ``owned`` (``sharded.participant_wanted``)
        reads only the shard objects meeting a participant's blocks; see
        ``RestoreEngine.restore``."""
        return self.restorer.restore(state_like, device=device, step=step,
                                     parts=parts, units=units,
                                     pipelined=pipelined, owned=owned,
                                     manifest=manifest)

    @property
    def last_restore_stats(self) -> Dict[str, Any]:
        return self.restorer.last_stats

    def restore_meta(self, step: Optional[int] = None) -> Dict:
        m = self.manifests.load(step)
        return dict(m.meta) if m else {}

    # ------------------------------------------------------------------- gc
    def gc(self) -> int:
        steps = self.manifests.all_steps()
        for s in steps[:-self.keep] if len(steps) > self.keep else []:
            m = self.manifests.load(s)
            self.manifests.delete(s)
            if m is not None:
                self.store.decref(m.referenced_digests().elements())
        return self.store.gc_objects()

    def drain_spill(self) -> None:
        """Durability barrier: returns once every written object is on the
        durable tier (nothing to wait for on one tier)."""
        self.store.drain_spill()

    def scrub(self, *, repair: bool = True, device=None) -> Dict[str, Any]:
        """The store-wide integrity scrub and repair (fsck) over every
        committed manifest, tables verified on ``device`` (the card unless
        the caller asks for the CPU); returns the report.  See
        :class:`repro_torch.checkpoint.scrub.StoreScrubber`."""
        from repro_torch.checkpoint.scrub import StoreScrubber
        return StoreScrubber(self.store, self.manifests,
                             device=device).scrub(repair=repair)

    def close(self) -> None:
        """Drain and stop the writer (raising a write error it collected)
        and close the store, whose tiered backend drains its spills first;
        the pool's threads stop, and a block cache this manager built is
        closed, either way."""
        try:
            if self.writer is not None:
                self.writer.close()
        finally:
            try:
                self.store.close()
            finally:
                try:
                    if self.transfer_pool is not None:
                        self.transfer_pool.close()
                finally:
                    if self._own_block_cache:
                        self.block_cache.close()

    def disk_usage(self) -> Dict[str, int]:
        total = objects = 0
        for d in self.store.iter_digests():
            total += self.store.object_size(d)
            objects += 1
        return {"total": total, "objects": objects,
                "manifests": len(self.manifests.all_steps())}

