"""Delta-push weight hot-swap: a server follows the manifest chain and
promotes a new checkpoint by digest diff.

A manifest is a unit -> digest map, so a running server diffs the newest
manifest against what it serves and touches only the units whose content
moved:

- **unchanged unit** (same digest): no object read, nothing copied to the
  device;
- **block-delta unit whose base is exactly what is served**: read only the
  BD02 object (never its base: the device holds those bytes) and scatter
  its dirty blocks onto the unit's tensors;
- **anything else** (a full object, a delta against another base):
  a verified read of the unit through the session, copied in whole; an
  int8 leaf crosses as its q and scales and is dequantized on the device
  (``restore.place_leaves``, the cold load's route, so a swap stays
  bit-identical to a cold load), and a lossy object is checked by crc32.

Atomic publish with copy-on-write.  The JAX service stages every change in
a functional copy of the tree.  Here the served tensors are never written:
the first time a swap changes a leaf it clones the leaf once on the device
(for a stacked ``blocks`` leaf, the whole stacked leaf) into a staged tree
that shares every untouched leaf with the served one, and scatters or
copies into the clone.  After the last unit, and after the device has
finished (``torch.cuda.synchronize``, the JAX ``block_until_ready``),
``{params, served digests, step}`` are published together under a lock, so
a reader of :meth:`WeightService.current` never sees a half-applied swap.
The ``swap_apply`` crash point fires before each unit is applied: a crash
mid-swap leaves the old weights served and the next ``poll`` redoes the
whole swap (the digest diff makes it idempotent).

Scatter granularity: the JAX service moves one int32 index per element.
The port views a leaf as ``(n_blocks, block_elems)`` and ``index_copy_``s
the whole dirty blocks (one int64 index per block), then copies the tail
block's valid part on its own; ``h2d_bytes`` counts what the port moves.
Every applied unit is fingerprinted where it lies (the ``block_fp`` kernel
on the card) and held against the object's stored table before anything
is published.

Memory: copy-on-write clones every leaf a swap touches, and a block unit
lives in the stacked ``blocks`` leaves, so swapping any one layer stages a
second copy of every stacked leaf it touches until the publish frees the
old one.  At full depth that is close to twice the weights' memory.

Not ported yet: swapping a sharded (shard-set) entry, which raises
``SwapError`` (ROADMAP A3), and ``VariantSet`` with the block cache (A2,
A6).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import faults, workers
from repro_torch.checkpoint.chunk_store import ReadSession
from repro_torch.checkpoint.restore import place_leaves, verify_placed
from repro_torch.checkpoint.serial import flatten_with_paths
from repro_torch.core.manifest import Manifest
from repro_torch.devices import resolve_device
from repro_torch.dtypes import torch_dtype

PyTree = Any


class SwapError(RuntimeError):
    pass


class _ScatterUnsupported(Exception):
    """Internal: this unit cannot take the scatter path; read it in full
    instead (never user-visible)."""


def _is_sharded(entry) -> bool:
    return isinstance(entry, (list, tuple))


def _entry_key(entry) -> Any:
    """The served-content identity of a manifest entry: the object digest
    (the sorted digest tuple for a shard set).  Equal keys mean
    bit-identical served bytes."""
    if _is_sharded(entry):
        return tuple(sorted(r.digest for r in entry))
    return entry.digest


def _check_record(dst: torch.Tensor, rec: Dict[str, Any]) -> None:
    """Raise ``_ScatterUnsupported`` unless a BD02 record fits ``dst``
    exactly: dtype, shape, byte length, whole-element blocks, in-range
    indices and one padded block of data per index."""
    try:
        dtype = torch_dtype(rec["dtype"])
    except TypeError:
        raise _ScatterUnsupported from None
    size = dst.element_size()
    block, nbytes = int(rec["block"]), int(rec["nbytes"])
    n_blocks = max(1, -(-nbytes // block))
    idx = rec["idx"]
    if (dtype != dst.dtype or tuple(rec["shape"]) != tuple(dst.shape)
            or block % size or nbytes != dst.numel() * size
            or not dst.is_contiguous()
            or memoryview(rec["data"]).nbytes != len(idx) * block
            or any(not 0 <= int(i) < n_blocks for i in idx)):
        raise _ScatterUnsupported


def _scatter_leaf(dst: torch.Tensor, rec: Dict[str, Any]) -> int:
    """Copy one BD02 record's dirty blocks into ``dst`` (a contiguous
    tensor it fits, see ``_check_record``) in place: the whole blocks by
    one ``index_copy_`` over the ``(n_blocks, block_elems)`` view, the
    ragged tail block's valid elements by one copy.  Returns the bytes
    moved to ``dst``'s device."""
    idx = np.asarray([int(i) for i in rec["idx"]], dtype=np.int64)
    if idx.size == 0:
        return 0
    block = int(rec["block"])
    be = block // dst.element_size()        # elements per block
    n = dst.numel()
    n_full = n // be                        # blocks without a ragged tail
    rows = np.frombuffer(rec["data"], np.uint8).reshape(idx.size, block)
    flat = dst.view(-1)
    moved = 0
    full = idx < n_full
    if full.any():
        vals = torch.from_numpy(np.ascontiguousarray(rows[full])).view(
            dst.dtype).to(dst.device)
        ids = torch.from_numpy(idx[full]).to(dst.device)
        flat[:n_full * be].view(n_full, be).index_copy_(0, ids, vals)
        moved += vals.numel() * vals.element_size() + ids.numel() * 8
    if not full.all():
        tail = n - n_full * be
        raw = np.ascontiguousarray(rows[~full][0, :tail * dst.element_size()])
        flat[n_full * be:].copy_(torch.from_numpy(raw).view(dst.dtype))
        moved += raw.nbytes
    return moved


def _fresh_stats() -> Dict[str, Any]:
    return {"units_swapped": 0, "units_skipped": 0, "units_scattered": 0,
            "units_full": 0, "blocks_applied": 0, "h2d_bytes": 0,
            "bytes_read": 0, "objects_read": 0}


def _copy_dicts(tree: PyTree) -> PyTree:
    """The same tree with fresh dicts and the same leaf tensors."""
    if isinstance(tree, dict):
        return {k: _copy_dicts(v) for k, v in tree.items()}
    return tree


class WeightService:
    """One served weight set with live delta-push promotion.

    The constructor cold-loads the weights (a ``parts=("params",)``
    restore: no optimizer object is opened) from ``step`` or ``manifest``
    onto ``device`` (the card by default); :meth:`poll` follows the
    manifest chain and :meth:`swap` applies digest diffs.  ``current()``
    always returns a complete, consistent tree.

    ``last_swap_stats``: bytes and objects read, bytes moved to the device,
    unit counts per path (``units_swapped``/``skipped``/``scattered``/
    ``full``), ``blocks_applied``, ``step_from``/``step_to``, wall
    ``seconds`` and, on the card, ``peak_device_bytes`` (the swap resets
    the device's peak-memory counter when it starts).
    """

    def __init__(self, manager, state_like: Dict[str, PyTree], *,
                 device=None, step: Optional[int] = None,
                 manifest: Optional[Manifest] = None):
        self.mgr = manager
        self.registry = manager.registry
        self.store = manager.store
        self.manifests = manager.manifests
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        if manifest is None:
            manifest = self.manifests.load(step)
            if manifest is None:
                raise SwapError(f"no manifest at step {step!r} under "
                                f"{self.manifests.root}")
        state = manager.restore({"params": state_like["params"]},
                                device=self.device, parts=("params",),
                                manifest=manifest)
        self.params: PyTree = state["params"]
        self.step: int = int(manifest.step)
        self.restore_stats = dict(manager.last_restore_stats)
        self._served: Dict[str, Any] = self._digest_keys(manifest)
        self.last_swap_stats: Dict[str, Any] = {}

    # ------------------------------------------------------------- helpers
    def _digest_keys(self, manifest: Manifest) -> Dict[str, Any]:
        return {unit: _entry_key(self._weights_entry(manifest, unit))
                for unit in self.registry.unit_names()}

    @staticmethod
    def _weights_entry(manifest: Manifest, unit: str):
        kinds = manifest.entries.get(unit)
        if kinds is None or "weights" not in kinds:
            raise SwapError(f"manifest {manifest.step} has no weights entry "
                            f"for unit {unit!r}")
        return kinds["weights"]

    def current(self) -> PyTree:
        """The served params tree (atomic reference read)."""
        with self._lock:
            return self.params

    # ---------------------------------------------------------------- poll
    def poll(self) -> Optional[Dict[str, Any]]:
        """Swap to LATEST if it moved; returns the swap stats, or None when
        already current (no read at all, not even a manifest parse)."""
        latest = self.manifests.latest_step()
        if latest is None or latest == self.step:
            return None
        manifest = self.manifests.load(latest)
        if manifest is None:
            return None  # torn commit in progress; the next poll catches up
        return self.swap(manifest)

    # ---------------------------------------------------------------- swap
    def swap(self, manifest: Manifest) -> Dict[str, Any]:
        """Promote ``manifest``: apply per-unit digest diffs onto a staged
        copy-on-write tree, then publish it atomically.

        The plan is the digest diff, not step arithmetic, so a swap across
        several skipped manifests, or backwards for a rollback, is the same
        single pass."""
        t0 = time.perf_counter()
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        session = ReadSession(self.store)
        stats = _fresh_stats()
        step_from = self.step
        staged = _copy_dicts(self.current())
        cloned: set = set()
        staged_keys: Dict[str, Any] = {}
        for unit in self.registry.unit_names():
            entry = self._weights_entry(manifest, unit)
            key = _entry_key(entry)
            if key == self._served.get(unit):
                stats["units_skipped"] += 1
                continue
            # A crash here, any unit deep into the loop, must leave the
            # served tree untouched and the swap redoable.
            faults.crash_point("swap_apply")
            self._apply_unit(staged, cloned, unit, entry, session, stats)
            staged_keys[unit] = key
            stats["units_swapped"] += 1
        if cuda:
            torch.cuda.synchronize(self.device)
        with self._lock:
            self.params = staged
            self._served.update(staged_keys)
            self.step = int(manifest.step)
        stats.update(step_from=step_from, step_to=int(manifest.step),
                     seconds=time.perf_counter() - t0,
                     bytes_read=session.stats["bytes_read"],
                     objects_read=session.stats["object_reads"],
                     peak_device_bytes=(torch.cuda.max_memory_allocated(
                         self.device) if cuda else None))
        self.last_swap_stats = stats
        return stats

    # ---------------------------------------------------------- unit apply
    def _writable_unit(self, staged: PyTree, cloned: set,
                       unit: str) -> PyTree:
        """The unit's tensors in ``staged``, each leaf of its subtree
        cloned once per swap (copy-on-write; a stacked leaf whole)."""
        u = self.registry.by_name[unit]
        node = staged
        for p in u.path[:-1]:
            node = node[p]
        sub = node[u.path[-1]]
        if isinstance(sub, dict):
            for path, leaf in flatten_with_paths(sub):
                parts = path.split("/")
                parent = sub
                for p in parts[:-1]:
                    parent = parent[p]
                if id(leaf) not in cloned:
                    parent[parts[-1]] = leaf.clone()
                    cloned.add(id(parent[parts[-1]]))
        elif id(sub) not in cloned:
            node[u.path[-1]] = sub.clone()
            cloned.add(id(node[u.path[-1]]))
        return self.registry.extract_unit(staged, unit)

    def _apply_unit(self, staged: PyTree, cloned: set, unit: str, entry,
                    session: ReadSession, stats: Dict[str, Any]) -> None:
        if _is_sharded(entry):
            raise SwapError(f"unit {unit!r} is a shard set: swapping shard "
                            "sets is not ported yet (ROADMAP A3)")
        served = self._served.get(unit)
        if (isinstance(served, str) and served and entry.stored == "delta"
                and entry.delta_base == served):
            # The new object is a delta whose base is exactly what the
            # device holds: never read the base, scatter the dirty blocks.
            env = session.envelope(entry.digest)
            if env.get("format") == "block_delta" \
                    and env.get("fp") is not None:
                try:
                    self._scatter_unit(staged, cloned, unit, entry.digest,
                                       env, stats)
                    return
                except _ScatterUnsupported:
                    pass  # the full read below (and its verify) decides
        tree, fp_blob = session.read(entry.digest)
        stats["units_full"] += 1
        self._replace_unit(staged, cloned, unit, entry.digest, tree,
                           fp_blob, stats)

    def _scatter_unit(self, staged: PyTree, cloned: set, unit: str,
                      digest: str, env: Dict[str, Any],
                      stats: Dict[str, Any]) -> None:
        records = workers.block_delta_decode(env["payload"])
        current = dict(flatten_with_paths(
            self.registry.extract_unit(staged, unit)))
        for rec in records:
            if rec["name"] not in current:
                raise _ScatterUnsupported
            _check_record(current[rec["name"]], rec)
        dst = self._writable_unit(staged, cloned, unit)
        leaves = dict(flatten_with_paths(dst))
        with torch.no_grad():
            for rec in records:
                stats["h2d_bytes"] += _scatter_leaf(leaves[rec["name"]], rec)
                stats["blocks_applied"] += len(rec["idx"])
        verify_placed(dst, env["fp"], digest)
        stats["units_scattered"] += 1

    def _replace_unit(self, staged: PyTree, cloned: set, unit: str,
                      digest: str, value: PyTree, fp_blob,
                      stats: Dict[str, Any]) -> None:
        """Wholesale unit replacement from a decoded host tree (the unit's
        full byte size moves: the slow path the diff and the scatter exist
        to avoid)."""
        dst = self._writable_unit(staged, cloned, unit)
        want = flatten_with_paths(dst)
        got = dict(flatten_with_paths(value))
        if set(got) != {p for p, _ in want}:
            raise SwapError(f"object {digest} holds leaves {sorted(got)}, "
                            f"unit {unit!r} has {[p for p, _ in want]}")
        for path, t in want:
            if tuple(got[path].shape) != tuple(t.shape):
                raise SwapError(f"{unit}/{path}: object holds "
                                f"{list(got[path].shape)}, the unit "
                                f"{list(t.shape)}")
        stats["h2d_bytes"] += place_leaves([(t, got[path])
                                            for path, t in want])
        if fp_blob is not None:
            verify_placed(dst, fp_blob, digest)
