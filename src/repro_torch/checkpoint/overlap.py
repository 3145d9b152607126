"""Zero-stall checkpointing: the overlapped snapshot/writeback pipeline of
the port.

The synchronous ``CheckpointManager.save`` blocks the training loop for
the whole event: fingerprint, gather, device->host copy, encode, write,
commit.  This module keeps only the device-side dispatch and the decisions
at the step that triggers the event, and spreads the host-side work over
the next ``spread_steps`` steps:

``begin(state, step)``  the only window that reads the live train state.
    Per selected unit it launches the fused ``block_gather`` kernel
    (fingerprint + compare with the delta base + dirty-block compaction in
    one pass; the buffer's capacity comes from the advisory
    :class:`DirtyPredictor`) or, without a usable delta base, the
    ``block_fp`` kernel and ``clone()`` s of the full leaves (under codec
    int8, the ``quantize`` kernel's records of the eligible leaves, which
    are new buffers already, and clones of the rest), and it makes
    the exact dedup/delta decisions the sync path makes.  Every one of
    those device reads is enqueued on the compute stream, so stream order
    makes it read the pre-step values even though the next optimizer step
    (``fused_adamw``) overwrites params, master, m and v in place.  The
    device->host copies of the NEW buffers (gathers, clones) then go on a
    side copy stream, after it waits on an event recorded behind those
    reads, into pinned ``StagingArena`` slots, so the copy engines run
    while the next step computes.  When ``begin`` returns, nothing of the
    event reads the live state again.

``tick()``  once per training step, between dispatching the step and
    reading its loss.  Each tick waits for one spread slice's copies (their
    CUDA events), builds the units' packets over the pinned slots and
    submits the writes to the manager's writer threads; the slot goes back
    to the arena when its write has landed.  The tick after the last slice
    drains the writer and commits through the SAME
    ``CheckpointManager._commit_event`` seam as a sync save.

``finish()``  forces the event to completion now (end of run, or a new
    ``begin`` arriving mid-spread: events are strictly FIFO).

Invariants (those of the JAX package's ``checkpoint/overlap.py``):

- **Prediction is advisory, the fingerprint compare is authoritative.**
  Predicted-dirty-but-clean costs a wasted device gather; predicted-clean-
  but-dirty overflows the buffer, which the kernel's count reports, and
  ``begin`` gathers again at the true size.  Mispredictions cost
  bandwidth, never bytes in the checkpoint.
- **Bit-exactness.**  Decision order, packet bytes, digests and the commit
  sequence are the sync path's, so an overlapped save and a sync save of
  the same state commit identical manifests.
- **Crash mid-overlap loses nothing.**  No manifest commits until the last
  slice; the ``snapshot_overlap``/``spread_slice`` crash points sit inside
  the new windows, and the previous manifest stays LATEST.
- **No interleaved commits.**  While an event is in flight the manager
  must not commit other manifests; a violation is detected at commit time
  and the carried entries re-anchor on the newest manifest.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import faults
from repro_torch.checkpoint import fingerprint as fputil
from repro_torch.checkpoint.async_io import (PendingResult, StagingArena,
                                             StagingSlot)
from repro_torch.checkpoint.saver import (MAX_DIRTY_FRAC, CheckpointManager,
                                          _usable_prev, full_sources)
from repro_torch.checkpoint.serial import flatten_with_paths
from repro_torch.core.manifest import Manifest
from repro_torch.core.policies import PolicyContext
from repro_torch.kernels import block_fp as bfp
from repro_torch.kernels import block_gather as bgather
from repro_torch.kernels.block_fp.ref import LeafFP

log = logging.getLogger("repro_torch.checkpoint")

PyTree = Any


class DirtyPredictor:
    """Advisory per-leaf dirty-block predictor.

    Seeds the fused kernel's gather capacity from the leaf's dirty count at
    the last event scaled by ``margin``, widened when the unit's drift
    score (``DeltaTracker``) says this event moved more.  First sight of a
    leaf predicts everything dirty, the only guess that cannot overflow.
    Wrong guesses cost device bandwidth, never bytes in the checkpoint."""

    def __init__(self, margin: float = 1.5):
        self.margin = float(margin)
        self._last: Dict[Tuple[str, str, str], int] = {}

    def predict(self, name: str, kind: str, path: str, n_blocks: int,
                drift: Optional[float]) -> int:
        last = self._last.get((name, kind, path))
        if last is None:
            return n_blocks
        scale = self.margin * (1.0 + min(max(drift or 0.0, 0.0), 1.0))
        return min(n_blocks, max(1, math.ceil(last * scale)))

    def observe(self, name: str, kind: str, path: str, count: int) -> None:
        self._last[(name, kind, path)] = int(count)


@dataclasses.dataclass
class _StagedLeaf:
    meta: LeafFP                    # path/shape/dtype/nbytes/block_bytes
    mode: str                       # "delta" | "full"
    dev: Optional[torch.Tensor]     # flat uint8 bytes to copy (new buffer)
    idx: Optional[np.ndarray] = None   # delta: dirty indices (host, exact)
    count: int = 0                  # delta: dirty blocks staged
    host: Optional[torch.Tensor] = None  # its region of the staging slot
    quant: Optional[Tuple[int, int]] = None  # full int8: (n_q, n_scale)


@dataclasses.dataclass
class _StagedUnit:
    name: str
    kind: str
    pref: Any                       # previous ChunkRef (or None)
    digest: str
    tblob: bytes
    logical: int
    nb_total: int
    full: bool                      # write mode when not dedup'd
    base_digest: Optional[str]
    leaves: List[_StagedLeaf]
    slot: Optional[StagingSlot] = None
    copied: Optional[torch.cuda.Event] = None  # the slot's D2H is done

    def staged_bytes(self) -> int:
        return sum(l.dev.numel() for l in self.leaves if l.dev is not None)


@dataclasses.dataclass
class _Event:
    step: int
    event_index: int
    prev_step: Optional[int]
    entries: Dict[str, Dict[str, Any]]
    selected: List[str]
    meta: Optional[Dict]
    durability_barrier: Optional[bool]
    queue: List[_StagedUnit]
    per_slice: int
    wall0: float
    resolved: Dict[Tuple[str, str], Any] = dataclasses.field(
        default_factory=dict)
    pending: Dict[Tuple[str, str], PendingResult] = dataclasses.field(
        default_factory=dict)
    new_fps: Dict[Tuple[str, str], Any] = dataclasses.field(
        default_factory=dict)
    snapshot_fps: Dict[str, List[LeafFP]] = dataclasses.field(
        default_factory=dict)
    begin_seconds: float = 0.0
    stage_seconds: float = 0.0
    writeback_seconds: float = 0.0
    stall_seconds: float = 0.0
    slices: int = 0
    d2h_bytes: int = 0
    staged_bytes: int = 0
    blocks_moved: int = 0
    blocks_total: int = 0
    overflows: int = 0


class OverlappedSaver:
    """Drives overlapped checkpoint events against a
    :class:`CheckpointManager`.  One instance per manager; events are
    strictly FIFO.  The manager's ``last_save_stats`` is set at commit with
    the sync save's keys plus ``save_mode``, ``spread_*``, ``staged_bytes``,
    ``overflow_redispatches`` and ``staging_host_bytes`` (the host memory
    the staging slots hold, pinned on a CUDA device)."""

    def __init__(self, mgr: CheckpointManager, *, spread_steps: int = 2,
                 margin: float = 1.5):
        self.mgr = mgr
        self.spread_steps = max(1, int(spread_steps))
        self.predictor = DirtyPredictor(margin=margin)
        self.arena: Optional[StagingArena] = None   # made at first begin
        self._copy_stream: Optional[torch.cuda.Stream] = None
        self._event: Optional[_Event] = None
        self.last_snapshot_fps: Dict[str, List[LeafFP]] = {}

    # ------------------------------------------------------------- begin
    def begin(self, state: Dict[str, PyTree], step: int, *,
              meta: Optional[Dict] = None,
              drift_scores: Optional[Dict[str, float]] = None,
              units: Optional[Sequence[str]] = None,
              durability_barrier: Optional[bool] = None) -> None:
        """Open an event for ``step``: enqueue every device read of
        ``state`` and make every content decision.  When ``begin``
        returns, the caller may overwrite the state in place."""
        if self._event is not None:
            self.finish()
        mgr = self.mgr
        t0 = time.perf_counter()
        mgr.store.reset_stats()
        step = int(step)
        event_index = mgr.reserve_event_index()
        ctx = PolicyContext(event_index=event_index, step=step,
                            drift_scores=drift_scores)
        prev = _usable_prev(mgr.manifests.load())
        if prev is None:
            selected = mgr.policy.all_units()
        elif units is not None:
            selected = list(dict.fromkeys(units))
        else:
            selected = list(dict.fromkeys(mgr.policy.select(ctx)))
        entries: Dict[str, Dict[str, Any]] = (
            {u: dict(k) for u, k in prev.entries.items()} if prev else {})

        ev = _Event(step=step, event_index=event_index,
                    prev_step=prev.step if prev else None,
                    entries=entries, selected=selected, meta=meta,
                    durability_barrier=durability_barrier, queue=[],
                    per_slice=1, wall0=t0)
        for name in selected:
            drift = (drift_scores or {}).get(name)
            for kind in ("weights", "opt"):
                tree = (mgr.registry.extract_unit(state["params"], name)
                        if kind == "weights" else
                        mgr.registry.extract_opt_unit(state["opt"], name))
                pref = mgr._prev_entry(prev, name, kind)
                self._begin_unit(ev, name, kind, tree, pref, drift)
        # Batch-resolve the deferred store-wide dedup probes: one
        # concurrent ``store.has`` per still-queued unit (see
        # ``_begin_unit``); same decision, same order of authority.
        if ev.queue:
            pool = mgr.transfer_pool
            if pool is not None:
                probes = [(u, pool.submit("probe", mgr.store.has, u.digest))
                          for u in ev.queue]
                hits = [(u, p.result()) for u, p in probes]
            else:
                hits = [(u, mgr.store.has(u.digest)) for u in ev.queue]
            for u, hit in hits:
                if hit:
                    ev.resolved[(u.name, u.kind)] = mgr.store.note_dedup(
                        ev.step, u.name, u.kind, u.digest, prev_ref=u.pref,
                        logical_bytes=u.logical)
                    ev.queue.remove(u)
        self._start_copies(ev, state)
        ev.per_slice = max(1, -(-len(ev.queue) // self.spread_steps))
        # Everything is dispatched and every decision is made; nothing has
        # been written, no manifest moved: the "died with a whole event in
        # flight" drill.
        faults.crash_point("snapshot_overlap")
        self._event = ev
        ev.begin_seconds = time.perf_counter() - t0
        ev.stall_seconds += ev.begin_seconds

    def _begin_unit(self, ev: _Event, name: str, kind: str, tree: PyTree,
                    pref, drift: Optional[float]) -> None:
        mgr = self.mgr
        bb = mgr.fp_block_bytes
        arrs = [a.detach() for _, a in flatten_with_paths(tree)]
        metas = fputil.meta_table(tree, bb)
        nb_total = sum(m.n_blocks for m in metas)
        ev.blocks_total += nb_total

        # Delta base planned from structure alone (meta_matches never reads
        # checksums), so the fused kernel compares against it in the same
        # pass that fingerprints.
        base_digest, base_tbl = mgr._delta_base(name, kind, pref, metas)
        results = None
        if base_tbl is not None:
            caps = [self.predictor.predict(name, kind, m.path, m.n_blocks,
                                           drift) for m in metas]
            results = bgather.gather_tree_dirty(
                arrs, [b.fp for b in base_tbl], caps, block_bytes=bb)
            cur = [LeafFP(path=m.path, shape=m.shape, dtype=m.dtype,
                          nbytes=m.nbytes, block_bytes=bb, fp=r.fp,
                          sumsq=r.sumsq)
                   for m, r in zip(metas, results)]
        else:
            cur = bfp.fingerprint_tree(tree, block_bytes=bb)
        faults.crash_point("fingerprint")

        # Host sync 1: the fingerprint tables (~0.02% of the data), which
        # every decision below hangs off.
        host = bfp.tree_to_host(cur)
        del cur
        tblob = fputil.pack_table(host)
        digest = fputil.fp_digest(tblob)
        logical = sum(l.nbytes for l in host)
        ev.new_fps[(name, kind)] = host
        if kind == "weights":
            ev.snapshot_fps[name] = host

        # Decision order: byte for byte the sync ``_save_unit_fp`` tree.
        ref_fp = mgr._fp_refs.get((name, kind))
        if ref_fp is None and pref is not None and pref.digest:
            ref_fp = mgr.store.load_fp_table(pref.digest)
        if (ref_fp is not None and pref is not None and pref.digest
                and bfp.leaves_match(host, ref_fp)):
            # Unchanged: a predicted-dirty gather (if any) is discarded on
            # the device, the clean misprediction that costs nothing.
            ev.resolved[(name, kind)] = mgr.store.note_dedup(
                ev.step, name, kind, pref.digest, prev_ref=pref,
                logical_bytes=logical)
            for m in metas:
                self.predictor.observe(name, kind, m.path, 0)
            return
        # The store-wide dedup probe (``store.has``) is deferred to the
        # batch in ``begin``; a probe hit un-queues the unit (decision
        # unchanged, its device buffers are dropped before any copy).

        use_delta = base_tbl is not None
        counts: List[int] = []
        idxs: List[np.ndarray] = []
        if use_delta:
            # Host sync 2: the dirty counts, with the index prefixes.
            counts, idxs = _counts_and_idx(results)
            if sum(counts) > MAX_DIRTY_FRAC * nb_total:
                use_delta = False

        leaves: List[_StagedLeaf] = []
        if use_delta:
            redo = [i for i, (r, c) in enumerate(zip(results, counts))
                    if c > r.capacity]
            for i, (m, r, c) in enumerate(zip(metas, results, counts)):
                if i in redo:
                    # Under-prediction: the count is authoritative and the
                    # state is still intact: gather again at the true size.
                    ev.overflows += 1
                    results[i] = bgather.gather_dirty(
                        arrs[i], base_tbl[i].fp, capacity=c, block_bytes=bb)
                self.predictor.observe(name, kind, m.path, c)
            if redo:
                _, again = _counts_and_idx([results[i] for i in redo])
                for i, ix in zip(redo, again):
                    idxs[i] = ix
            for m, r, c, ix in zip(metas, results, counts, idxs):
                dev = r.block_bytes()[:c].reshape(-1) if c else None
                leaves.append(_StagedLeaf(meta=m, mode="delta", dev=dev,
                                          idx=ix[:c].copy(), count=c))
        else:
            # Free the discarded gather buffers before taking the copies:
            # a first-sight leaf's buffer is as large as the leaf.
            results = None
            # Fresh buffers on the compute stream: the live tensors are
            # overwritten in place by the next step, the copies (or int8
            # records) are not.
            copies, recs = full_sources(
                [(m.path, a) for m, a in zip(metas, arrs)], mgr.store.codec,
                clone=True)
            for m, dev, rec in zip(metas, copies, recs):
                leaves.append(_StagedLeaf(meta=m, mode="full", dev=dev,
                                          quant=rec))
            for m in metas:
                self.predictor.observe(name, kind, m.path, m.n_blocks)
        ev.queue.append(_StagedUnit(
            name=name, kind=kind, pref=pref, digest=digest, tblob=tblob,
            logical=logical, nb_total=nb_total, full=not use_delta,
            base_digest=base_digest if use_delta else None, leaves=leaves))

    def _start_copies(self, ev: _Event, state: Dict[str, PyTree]) -> None:
        """Issue the device->host copy of every queued unit into its own
        staging slot: on a side stream that first waits for the compute
        stream's reads above (CUDA), or at once (CPU)."""
        if not ev.queue:
            return
        dev = flatten_with_paths(state["params"])[0][1].device
        if self.arena is None:
            self.arena = StagingArena(pin=dev.type == "cuda")
        if dev.type != "cuda":
            for unit in ev.queue:
                self._fill_slot(unit)
            return
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=dev)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(dev))
        self._copy_stream.wait_event(ready)
        with torch.cuda.stream(self._copy_stream):
            for unit in ev.queue:
                self._fill_slot(unit)
                unit.copied = torch.cuda.Event()
                unit.copied.record(self._copy_stream)

    def _fill_slot(self, unit: _StagedUnit) -> None:
        unit.slot = self.arena.acquire(unit.staged_bytes())
        for leaf in unit.leaves:
            if leaf.dev is not None:
                leaf.host = unit.slot.view(leaf.dev.numel())
                leaf.host.copy_(leaf.dev, non_blocking=True)

    # -------------------------------------------------------------- tick
    def tick(self) -> Optional[Manifest]:
        """Advance one spread slice; returns the manifest on the tick that
        completes (and commits) the event, else None.  The commit comes on
        the tick AFTER the one that staged the last slice, which gives the
        last writes a compute step to drain in the background."""
        ev = self._event
        if ev is None:
            return None
        t0 = time.perf_counter()
        faults.crash_point("spread_slice")
        if ev.queue:
            for _ in range(min(ev.per_slice, len(ev.queue))):
                self._stage_and_submit(ev, ev.queue.pop(0))
            ev.slices += 1
            dt = time.perf_counter() - t0
            ev.stage_seconds += dt
            ev.stall_seconds += dt
            return None
        return self._commit(ev, t0)

    def finish(self) -> Optional[Manifest]:
        """Run the event to completion NOW (end of run, or a new event
        beginning mid-spread)."""
        ev = self._event
        if ev is None:
            return None
        t0 = time.perf_counter()
        while ev.queue:
            faults.crash_point("spread_slice")
            self._stage_and_submit(ev, ev.queue.pop(0))
        ev.slices += 1
        ev.stage_seconds += time.perf_counter() - t0
        return self._commit(ev, t0)

    @property
    def active(self) -> bool:
        return self._event is not None

    @property
    def event_step(self) -> Optional[int]:
        """Step of the event in flight, or None."""
        return self._event.step if self._event is not None else None

    def _stage_and_submit(self, ev: _Event, unit: _StagedUnit) -> None:
        mgr = self.mgr
        slot = unit.slot
        try:
            if unit.copied is not None:
                unit.copied.synchronize()  # the slot holds the bytes now
            payloads: List[fputil.LeafPayload] = []
            for leaf in unit.leaves:
                m = leaf.meta
                data: Any = b""
                if leaf.host is not None:
                    data = memoryview(leaf.host.numpy())
                    ev.d2h_bytes += data.nbytes
                if leaf.mode == "delta":
                    ev.blocks_moved += leaf.count
                else:
                    ev.blocks_moved += m.n_blocks
                payloads.append(fputil.LeafPayload(
                    path=m.path, shape=m.shape, dtype=m.dtype,
                    nbytes=m.nbytes, block_bytes=m.block_bytes,
                    idx=leaf.idx if leaf.mode == "delta" else None,
                    data=data, quant=leaf.quant))
                leaf.dev = None  # the device buffer is no longer needed
            ev.staged_bytes += sum(l.host.numel() for l in unit.leaves
                                   if l.host is not None)
            packet = fputil.FingerprintPacket(
                digest=unit.digest, table=unit.tblob, leaves=payloads,
                full=unit.full, base_digest=unit.base_digest,
                logical_bytes=unit.logical)
            faults.crash_point("gather")
        except BaseException:
            self.arena.release(slot)
            raise
        key = (unit.name, unit.kind)
        if mgr.writer is not None:
            ev.pending[key] = mgr.writer.submit(
                self._write_and_release, ev.step, unit, packet, slot)
        else:
            ev.resolved[key] = self._write_and_release(
                ev.step, unit, packet, slot)

    def _write_and_release(self, step: int, unit: _StagedUnit, packet,
                           slot: StagingSlot):
        """Runs on a writer thread: the store frames and writes straight
        from the pinned slot, which goes back to the arena afterwards."""
        try:
            return self.mgr.store.write_fp(step, unit.name, unit.kind,
                                           packet, prev_ref=unit.pref)
        finally:
            for l in packet.leaves:
                l.data = b""
            self.arena.release(slot)

    # ------------------------------------------------------------ commit
    def _commit(self, ev: _Event, slice_t0: float) -> Manifest:
        """Drain, commit, account.  ``slice_t0`` is when the completing
        tick/finish started blocking the caller: everything from there to
        the end of the commit is stall."""
        mgr = self.mgr
        t0 = time.perf_counter()
        if mgr.writer is not None:
            mgr.writer.drain()
            for key, p in ev.pending.items():
                ev.resolved[key] = p.result()
        ev.writeback_seconds = time.perf_counter() - t0

        latest = mgr.manifests.load()
        latest_step = latest.step if latest is not None else None
        if latest_step != ev.prev_step:
            # A direct save committed mid-event.  The event's own objects
            # are content-addressed and final; only the carried-forward
            # entries must re-anchor.
            log.warning(
                "manifest for step %s committed while overlapped event "
                "for step %s was in flight; re-anchoring carried entries",
                latest_step, ev.step)
            lat = _usable_prev(latest)
            base_entries = ({u: dict(k) for u, k in lat.entries.items()}
                            if lat else {})
        else:
            base_entries = ev.entries
        for (name, kind), ref in ev.resolved.items():
            base_entries.setdefault(name, {})[kind] = ref
        manifest, storage = mgr._commit_event(
            step=ev.step, entries=base_entries, selected=ev.selected,
            meta=ev.meta, new_fps=ev.new_fps, event_index=ev.event_index,
            durability_barrier=ev.durability_barrier)
        ev.stall_seconds += time.perf_counter() - slice_t0
        stats = mgr._event_stats(
            step=ev.step, selected=ev.selected, d2h_bytes=ev.d2h_bytes,
            blocks_moved=ev.blocks_moved, blocks_total=ev.blocks_total,
            storage=storage,
            timings={"snapshot_seconds": ev.begin_seconds,
                     "stage_seconds": ev.stage_seconds,
                     "writeback_seconds": ev.writeback_seconds,
                     "stall_seconds": ev.stall_seconds,
                     "total_seconds": time.perf_counter() - ev.wall0})
        stats["save_mode"] = "overlapped"
        stats["spread_steps"] = self.spread_steps
        stats["spread_slices"] = ev.slices
        stats["staged_bytes"] = ev.staged_bytes
        stats["overflow_redispatches"] = ev.overflows
        stats["staging_host_bytes"] = (self.arena.allocated_bytes
                                       if self.arena is not None else 0)
        mgr.last_save_stats = stats
        self.last_snapshot_fps = ev.snapshot_fps
        self._event = None
        return manifest

    def abort(self) -> None:
        """Drop an in-flight event without committing (error paths; a real
        crash needs no clean-up).  Objects already written are unreferenced
        and the next commit's GC sweeps them."""
        ev, self._event = self._event, None
        if ev is None:
            return
        for unit in ev.queue:
            if unit.copied is not None:
                unit.copied.synchronize()  # no copy may outlive its buffers
            for leaf in unit.leaves:
                leaf.dev = leaf.host = None
            if unit.slot is not None:
                self.arena.release(unit.slot)
        ev.queue.clear()
        if self.mgr.writer is not None:
            try:
                self.mgr.writer.drain()
            except Exception:  # noqa: BLE001 - writes may have crashed
                pass

    def close(self) -> None:
        self.abort()
        if self.arena is not None:
            self.arena.close()


def _counts_and_idx(results: Sequence[bgather.GatherResult]
                    ) -> Tuple[List[int], List[np.ndarray]]:
    """Every leaf's total dirty count and index vector, in one transfer."""
    flat = torch.cat([torch.stack([r.count for r in results])]
                     + [r.idx for r in results]).cpu().numpy()
    n = len(results)
    counts = [int(c) for c in flat[:n]]
    idxs, lo = [], n
    for r in results:
        idxs.append(flat[lo:lo + r.capacity])
        lo += r.capacity
    return counts, idxs
