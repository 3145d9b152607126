"""Shard-native checkpoints of the port: per-participant sharded saves, the
two-phase manifest commit and slice-aware restores, writing the JAX
package's ``checkpoint/sharded.py`` format byte for byte.

The unit of IO is a **shard object**: ``(unit, kind, shard spec)``, the
spec naming the participant and, per leaf, its path, global shape, dtype
and the index blocks the object holds.  Below the manifest a shard object
is an ordinary content-addressed chunk (its records named
``path#b<i>``), so dedup, block deltas, the device fingerprint compare,
the tiers, refcounted GC and the merge all work per shard object.

Roles:

- :class:`ShardedSaver`: one participant.  It fingerprints and copies only
  its owned blocks of every selected unit (views of the unit's tensors on
  their device: an axis-0 block of a contiguous leaf is contiguous), writes
  its shard objects through the manager's store and writer, waits for them
  (and, unless waived, for the durable tier), then publishes its record
  under ``root/shards/step-<N>/`` (phase one).  A participant's delta runs
  live under the store key ``unit@p<pid>``.
- :class:`ShardCoordinator`: phase two.  Once every participant of the
  cohort has published, it checks that the records agree on the selection
  and the event index, that every selected unit's shard set tiles the
  model's leaves exactly and that every object and delta base is in the
  store, and commits the manifest; a crash anywhere before that leaves
  the previous manifest authoritative.  The commit sweeps the records of
  this and older steps.
- :class:`ShardedCheckpointer`: N virtual participants on threads over
  one :class:`CheckpointManager`, and the commit: the trainer's
  ``--shard-participants N``.  One manifest parse per event; the
  fingerprint references advance only after the commit.

Ownership comes from :func:`participant_wanted`, the mesh-free contiguous
axis-0 split (``parallel/sharding.uniform_blocks``); the ``NamedSharding``
ownership of a device mesh is ROADMAP A4.2.  The same resolver drives the
restore: ``plan_restore(..., owned=)`` plans only the shard objects whose
blocks meet the participant's, so a restore at another N reads fewer
bytes than a full one.
"""
from __future__ import annotations

import dataclasses
import logging
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.checkpoint import faults
from repro_torch.checkpoint.async_io import PendingResult
from repro_torch.checkpoint.backends.localfs import atomic_write
from repro_torch.checkpoint.chunk_store import ChunkRef
from repro_torch.checkpoint.serial import (flatten_with_paths,
                                           shard_leaf_key,
                                           unflatten_from_paths)
from repro_torch.core import jsonutil
from repro_torch.core.layer_registry import OPT_KINDS
from repro_torch.core.manifest import Manifest, entry_refs, is_sharded
from repro_torch.core.policies import PolicyContext
from repro_torch.dtypes import dtype_name, torch_dtype
from repro_torch.optim.groups import get_at, tree_map
from repro_torch.parallel import sharding as shd

log = logging.getLogger("repro_torch.checkpoint.sharded")

PyTree = Any
RECORD_VERSION = 1

# wanted(unit, kind, leaf_path, global_shape) -> the blocks a participant
# owns (() = nothing), or None meaning "everything".
WantedFn = Callable[[str, str, str, Tuple[int, ...]],
                    Optional[Tuple[shd.Block, ...]]]


class ShardBarrierError(RuntimeError):
    """The two-phase commit cannot proceed (missing, incomplete or
    inconsistent participant records, or a shard object not in the
    store)."""


# ---------------------------------------------------------------------------
# The shard spec a manifest ref carries
# ---------------------------------------------------------------------------

def _blk(b) -> shd.Block:
    """A JSON block (lists) as the tuple form of the block math."""
    return tuple((int(s), int(e)) for s, e in b)


def spec_leaves(spec: Dict[str, Any]) -> List[Dict[str, Any]]:
    return list(spec.get("leaves", ()))


def leaf_blocks(leaf: Dict[str, Any]) -> Tuple[shd.Block, ...]:
    return tuple(_blk(b) for b in leaf["blocks"])


def spec_key(spec: Dict[str, Any]) -> Tuple:
    """Hashable identity of a shard layout (leaf paths, shapes, dtypes and
    blocks), whatever the participant id: how a shard finds its previous
    incarnation (its delta anchor) and its older-manifest fallbacks."""
    return tuple(sorted(
        (leaf["path"], tuple(int(d) for d in leaf["shape"]),
         str(leaf["dtype"]), leaf_blocks(leaf))
        for leaf in spec_leaves(spec)))


def spec_overlaps(spec: Dict[str, Any], wanted: WantedFn,
                  unit: str, kind: str) -> bool:
    """Whether any block of this shard object meets the caller's owned
    blocks: the plan-time shard filter."""
    for leaf in spec_leaves(spec):
        shape = tuple(int(d) for d in leaf["shape"])
        want = wanted(unit, kind, leaf["path"], shape)
        if want is None:
            return True
        for blk in leaf_blocks(leaf):
            for w in want:
                if blk == w or (len(blk) == len(w)
                                and shd.intersect_blocks(blk, w)):
                    return True
    return False


def _block_view(buf: torch.Tensor, blk: shd.Block) -> torch.Tensor:
    return buf[shd.block_slices(blk)] if blk else buf


def shard_views(spec: Dict[str, Any],
                leaves: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``path#b<i>`` -> the view of block i of leaf ``path`` in
    ``leaves`` (path -> tensor): the shard object's tensors where they lie
    in the unit, in the payload's record order (a flat dict flattens by
    its sorted keys, as the saver's shard tree does)."""
    out: Dict[str, torch.Tensor] = {}
    for leaf in spec_leaves(spec):
        buf = leaves[leaf["path"]]
        for i, blk in enumerate(leaf_blocks(leaf)):
            out[shard_leaf_key(leaf["path"], i)] = _block_view(buf, blk)
    return out


def check_spec(spec: Dict[str, Any], leaves: Dict[str, torch.Tensor],
               tree: PyTree) -> List[Tuple[torch.Tensor, Any]]:
    """``(destination view, decoded value)`` of every block of a decoded
    shard object ``tree`` inside ``leaves`` (path -> the unit's tensor);
    raises ``ValueError`` where the spec does not fit them (a leaf the
    unit lacks, another global shape or dtype, a block out of range) or
    the payload does not hold the spec's records at the blocks' shapes."""
    for leaf in spec_leaves(spec):
        path = leaf["path"]
        buf = leaves.get(path)
        shape = tuple(int(d) for d in leaf["shape"])
        if buf is None:
            raise ValueError(f"shard leaf {path!r} is not in the unit "
                             f"{sorted(leaves)}")
        if (shape != tuple(buf.shape)
                or torch_dtype(str(leaf["dtype"])) != buf.dtype):
            raise ValueError(f"shard leaf {path!r} is {leaf['dtype']}"
                             f"{list(shape)}, the unit holds "
                             f"{dtype_name(buf.dtype)}{list(buf.shape)}")
        for blk in leaf_blocks(leaf):
            if len(blk) != len(shape) or any(
                    not 0 <= s < e <= d for (s, e), d in zip(blk, shape)):
                raise ValueError(f"block {blk} out of {path!r}{shape}")
    flat = dict(flatten_with_paths(tree))
    views = shard_views(spec, leaves)
    if set(flat) != set(views):
        raise ValueError(f"shard object holds records {sorted(flat)}, its "
                         f"spec names {sorted(views)}")
    for key, view in views.items():
        if tuple(flat[key].shape) != tuple(view.shape):
            raise ValueError(f"record {key!r} holds "
                             f"{list(flat[key].shape)}, its block "
                             f"{list(view.shape)}")
    return [(view, flat[key]) for key, view in views.items()]


def check_tiles(specs: Sequence[Dict[str, Any]],
                leaves: Dict[str, torch.Tensor]) -> None:
    """Raise ``ValueError`` unless the blocks of ``specs`` tile every leaf
    of ``leaves`` (path -> tensor) exactly: a whole shard set."""
    per_leaf: Dict[str, list] = {path: [] for path in leaves}
    for spec in specs:
        for leaf in spec_leaves(spec):
            if leaf["path"] not in per_leaf:
                raise ValueError(f"shard leaf {leaf['path']!r} is not in "
                                 f"the unit {sorted(leaves)}")
            per_leaf[leaf["path"]].extend(leaf_blocks(leaf))
    for path, blocks in per_leaf.items():
        shape = tuple(leaves[path].shape)
        if not shd.blocks_cover_exactly(shape, blocks):
            raise ValueError(f"the shard set's blocks of {path!r} do not "
                             f"tile {shape}: {blocks}")


def assemble_shards(parts: Sequence[Tuple[Dict[str, Any], PyTree]], *,
                    partial: bool,
                    out: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Tuple[PyTree, int]:
    """Rebuild a unit's (sub)tree from decoded shard objects, each
    ``(spec, tree)``: every block is copied into its place in ``out``
    (path -> destination tensor, on any device; an int8 record is
    dequantized there) or, without ``out``, into host buffers sized from
    the specs' global shapes, zero-filled when ``partial`` (an
    owned-filtered restore that skipped shards: uncovered regions read as
    zeros).  A spec that does not fit, or (unless ``partial``) a set that
    does not tile the leaves, raises ``ValueError`` before any copy.
    Returns the tree of the destination leaves and the bytes moved to
    their device."""
    from repro_torch.checkpoint.restore import place_leaves

    bufs: Dict[str, torch.Tensor] = {} if out is None else dict(out)
    alloc = torch.zeros if partial else torch.empty
    pairs = []
    for spec, tree in parts:
        if out is None:
            for leaf in spec_leaves(spec):
                if leaf["path"] not in bufs:
                    bufs[leaf["path"]] = alloc(
                        tuple(int(d) for d in leaf["shape"]),
                        dtype=torch_dtype(str(leaf["dtype"])))
        pairs += check_spec(spec, bufs, tree)
    if not partial:
        check_tiles([spec for spec, _ in parts], bufs)
    moved = place_leaves(pairs)
    return unflatten_from_paths(bufs), moved


# ---------------------------------------------------------------------------
# Owned slices
# ---------------------------------------------------------------------------

def participant_wanted(registry, participant_id: int, n_participants: int,
                       *, shardings: Optional[Dict[str, PyTree]] = None
                       ) -> WantedFn:
    """The owned-slice resolver of one participant: the contiguous axis-0
    split of every leaf (``uniform_blocks``), the virtual participants'
    ownership.  Ownership from a mesh's shardings is ROADMAP A4.2:
    passing ``shardings`` raises."""
    if shardings is not None:
        raise ValueError("participant_wanted(shardings=...): ownership "
                         "from a device mesh is not ported yet (ROADMAP "
                         "A4.2); the port's participants split axis 0")
    if not (0 <= participant_id < n_participants):
        raise ValueError(
            f"participant {participant_id} outside 0..{n_participants - 1}")

    def wanted(unit: str, kind: str, path: str,
               shape: Tuple[int, ...]) -> Tuple[shd.Block, ...]:
        return shd.uniform_blocks(shape, participant_id, n_participants)
    return wanted


def unit_leaf_shapes(registry, unit: str, kind: str,
                     specs: Optional[PyTree] = None) -> Dict[str, Tuple]:
    """leaf path -> global shape of one (unit, kind), from the model's
    ``param_specs()`` (no state allocated): the coordinator's cover
    oracle.  Pass ``specs`` when calling per unit."""
    u = registry.by_name[unit]
    if specs is None:
        specs = registry.model.param_specs()
    sub = get_at(specs, u.path)
    if kind == "opt":
        sub = {k: sub for k in OPT_KINDS}
    cut = 0 if u.index is None else 1   # a stacked layer's slice
    return {path: tuple(int(d) for d in s.shape[cut:])
            for path, s in flatten_with_paths(sub)}


# ---------------------------------------------------------------------------
# Participant save
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ParticipantResult:
    participant_id: int
    step: int
    record_path: Path
    # (unit, kind) -> shard ChunkRef (spec attached) of the units this
    # participant owns a piece of
    refs: Dict[Tuple[str, str], ChunkRef]
    stats: Dict[str, Any]
    # fingerprint vectors to advance after the coordinator commits
    new_fps: Dict[Tuple[str, str], Any]


def record_dir(root: "Path | str", step: int) -> Path:
    return Path(root) / "shards" / f"step-{int(step):08d}"


def _record_path(root: "Path | str", step: int, pid: int) -> Path:
    return record_dir(root, step) / f"participant-{pid:04d}.json"


# save_shards sentinel: "load the newest manifest yourself" (None means
# "no previous manifest").
_LOAD_PREV = object()


def _usable_prev(prev: Optional[Manifest]) -> Optional[Manifest]:
    """A manifest with digest-less refs cannot be carried forward (the
    store reads by digest only): the event then starts a fresh full base.
    Shared by the sync, overlapped and sharded saves."""
    if prev is None:
        return None
    if any(not r.digest for kinds in prev.entries.values()
           for e in kinds.values() for r in entry_refs(e)):
        log.warning("previous manifest at step %s predates content "
                    "addressing; forcing a full save", prev.step)
        return None
    return prev


class ShardedSaver:
    """One save participant: fingerprints and copies only its owned
    blocks, writes shard objects through the manager's store and writer,
    and publishes a completion record (phase one).  It never commits a
    manifest, advances a fingerprint reference or runs GC: those are the
    coordinator's."""

    def __init__(self, manager, participant_id: int, n_participants: int,
                 *, shardings: Optional[Dict[str, PyTree]] = None):
        self.mgr = manager
        self.participant_id = int(participant_id)
        self.n_participants = int(n_participants)
        self.wanted: WantedFn = participant_wanted(
            manager.registry, self.participant_id, self.n_participants,
            shardings=shardings)

    def _store_key(self, unit: str) -> str:
        """The participant's key of a unit in the store's delta-run
        accounting (its shards drift apart from the others')."""
        return f"{unit}@p{self.participant_id}"

    def _prev_shard_ref(self, prev: Optional[Manifest], unit: str,
                        kind: str, spec: Dict[str, Any]
                        ) -> Optional[ChunkRef]:
        """The unit's previous shard object of the same layout: the dedup
        and delta anchor.  A global entry or another layout (after a
        re-partition) anchors nothing: the shard starts a full base."""
        if prev is None:
            return None
        entry = prev.entries.get(unit, {}).get(kind)
        if entry is None or not is_sharded(entry):
            return None
        key = spec_key(spec)
        for ref in entry_refs(entry):
            if ref.spec is not None and spec_key(ref.spec) == key:
                return ref
        return None

    def _shard_of(self, unit: str, kind: str, tree: PyTree
                  ) -> Tuple[Optional[Dict[str, Any]], Dict[str, Any]]:
        """(spec, shard tree) of this participant's blocks of one (unit,
        kind).  The pieces are views of the unit's tensors on their
        device (contiguous for axis-0 blocks; anything else is copied
        contiguous), keyed ``path#b<i>``."""
        leaves: List[Dict[str, Any]] = []
        shard_tree: Dict[str, torch.Tensor] = {}
        for path, arr in flatten_with_paths(tree):
            shape = tuple(int(d) for d in arr.shape)
            blocks = self.wanted(unit, kind, path, shape)
            if not blocks:
                continue
            for i, blk in enumerate(blocks):
                piece = _block_view(arr.detach(), blk)
                shard_tree[shard_leaf_key(path, i)] = (
                    piece if piece.is_contiguous() else piece.contiguous())
            leaves.append({"path": path, "shape": list(shape),
                           "dtype": dtype_name(arr.dtype),
                           "blocks": [list(map(list, b)) for b in blocks]})
        if not leaves:
            return None, {}
        return {"participant": self.participant_id, "leaves": leaves}, \
            shard_tree

    def save_shards(self, state: Dict[str, PyTree], *,
                    step: Optional[int] = None,
                    meta: Optional[Dict] = None,
                    drift_scores: Optional[Dict[str, float]] = None,
                    prev: Any = _LOAD_PREV,
                    units: Optional[Sequence[str]] = None,
                    durability_barrier: bool = True) -> ParticipantResult:
        """Write this participant's shard objects of one event and publish
        its record.  Returns once every owned object is in the store (and,
        with ``durability_barrier``, on its durable tier): publishing is
        the durability claim the coordinator trusts.  ``prev`` is the
        newest manifest, parsed once by a single-process orchestrator;
        ``units`` overrides the policy (every participant of an event must
        pass the same list)."""
        mgr = self.mgr
        t0 = time.time()
        step = int(state["step"]) if step is None else int(step)
        if prev is _LOAD_PREV:
            prev = mgr.manifests.load()
        prev = _usable_prev(prev)
        # Anchored on the committed chain, so every participant derives the
        # same index (the barrier checks it), past the retention cap too.
        if prev is not None and "event_index" in prev.meta:
            event_index = int(prev.meta["event_index"]) + 1
        else:
            event_index = len(mgr.manifests.all_steps())
        ctx = PolicyContext(event_index=event_index, step=step,
                            drift_scores=drift_scores)
        if prev is None:
            selected = mgr.policy.all_units()
        elif units is not None:
            selected = list(dict.fromkeys(units))
        else:
            selected = list(dict.fromkeys(mgr.policy.select(ctx)))

        acc = {"d2h_bytes": 0, "blocks_moved": 0, "blocks_total": 0,
               "fingerprint_seconds": 0.0, "d2h_seconds": 0.0,
               "write_seconds": 0.0}
        pending: Dict[Tuple[str, str], PendingResult] = {}
        refs: Dict[Tuple[str, str], ChunkRef] = {}
        specs: Dict[Tuple[str, str], Dict[str, Any]] = {}
        new_fps: Dict[Tuple[str, str], Any] = {}
        for name in selected:
            for kind in ("weights", "opt"):
                tree = (mgr.registry.extract_unit(state["params"], name)
                        if kind == "weights" else
                        mgr.registry.extract_opt_unit(state["opt"], name))
                spec, shard_tree = self._shard_of(name, kind, tree)
                if spec is None:
                    continue  # this participant owns nothing of the unit
                specs[(name, kind)] = spec
                pref = self._prev_shard_ref(prev, name, kind, spec)
                ukey = self._store_key(name)
                if mgr.fingerprint:
                    res, cur = mgr._save_unit_fp(step, ukey, kind,
                                                 shard_tree, pref, acc)
                    new_fps[(ukey, kind)] = cur
                else:
                    res = mgr._save_unit_canonical(step, ukey, kind,
                                                   shard_tree, pref, acc)
                if isinstance(res, PendingResult):
                    pending[(name, kind)] = res
                else:
                    refs[(name, kind)] = res
        for key, p in pending.items():
            refs[key] = p.result()
        # The record claims the shard set survives a process loss; the
        # preemption's hot save waives the durable tier.
        if durability_barrier:
            mgr.store.drain_spill()
        # The spec attached, the unit's own name back (the store key is a
        # delta-run namespace only).
        for (name, kind), ref in refs.items():
            refs[(name, kind)] = dataclasses.replace(
                ref, unit=name, spec=specs[(name, kind)])

        by_unit: Dict[str, Dict[str, list]] = {}
        for (name, kind), ref in refs.items():
            by_unit.setdefault(name, {})[kind] = [ref.to_json()]
        record = {
            "version": RECORD_VERSION,
            "step": step,
            "participant": self.participant_id,
            "n_participants": self.n_participants,
            "event_index": event_index,
            "policy": mgr.policy.name,
            "saved_units": list(selected),
            "meta": dict(meta or {}),
            "units": by_unit,
            "storage": mgr.store.durability(),
            "complete": True,
        }
        faults.crash_point("participant_record")
        path = _record_path(mgr.root, step, self.participant_id)
        path.parent.mkdir(parents=True, exist_ok=True)
        atomic_write(path, jsonutil.dumps(record, indent=True))
        stats = {
            "participant": self.participant_id,
            "step": step,
            "selected_units": len(selected),
            "shard_objects": len(refs),
            "d2h_bytes": acc["d2h_bytes"],
            "blocks_moved": acc["blocks_moved"],
            "blocks_total": acc["blocks_total"],
            "fingerprint_seconds": acc["fingerprint_seconds"],
            "d2h_seconds": acc["d2h_seconds"],
            "write_seconds": acc["write_seconds"],
            "seconds": time.time() - t0,
        }
        return ParticipantResult(self.participant_id, step, path, refs,
                                 stats, new_fps)

    def close(self) -> None:
        self.mgr.close()


# ---------------------------------------------------------------------------
# Coordinator (phase two)
# ---------------------------------------------------------------------------

class ShardCoordinator:
    """Collects the participant records of a step and commits the
    manifest, once (a) every participant of the cohort has published a
    complete record, (b) the records agree on the selection and the event
    index, (c) every selected unit's shard set tiles the model's leaves
    exactly and (d) every object and delta base is in the store.  Any
    failure raises :class:`ShardBarrierError` with the previous manifest
    untouched."""

    def __init__(self, manager):
        self.mgr = manager

    def participant_records(self, step: int) -> Dict[int, Dict[str, Any]]:
        out: Dict[int, Dict[str, Any]] = {}
        d = record_dir(self.mgr.root, step)
        if not d.is_dir():
            return out
        for p in sorted(d.glob("participant-*.json")):
            try:
                rec = jsonutil.loads(p.read_bytes())
            except Exception:  # noqa: BLE001 - a torn record is ignored
                log.warning("unreadable participant record %s (ignored)", p)
                continue
            if rec.get("complete") and rec.get("version") == RECORD_VERSION:
                out[int(rec["participant"])] = rec
        return out

    def wait_records(self, step: int, n_participants: int,
                     timeout: float = 60.0, poll: float = 0.05
                     ) -> Dict[int, Dict[str, Any]]:
        """Poll until every participant has published (participants in
        other processes); raises on timeout naming the missing ones."""
        deadline = time.time() + timeout
        while True:
            recs = self.participant_records(step)
            missing = [p for p in range(n_participants) if p not in recs]
            if not missing:
                return recs
            if time.time() >= deadline:
                raise ShardBarrierError(
                    f"step {step}: participants {missing} never published "
                    f"(have {sorted(recs)})")
            time.sleep(poll)

    def _check_cover(self, unit: str, kind: str, refs: Sequence[ChunkRef],
                     model_specs: PyTree) -> None:
        per_leaf: Dict[str, list] = {}
        shapes: Dict[str, Tuple[int, ...]] = {}
        for ref in refs:
            for leaf in spec_leaves(ref.spec or {}):
                shape = tuple(int(d) for d in leaf["shape"])
                prev = shapes.setdefault(leaf["path"], shape)
                if prev != shape:
                    raise ShardBarrierError(
                        f"{unit}/{kind}: conflicting global shapes for "
                        f"leaf {leaf['path']}: {prev} vs {shape}")
                per_leaf.setdefault(leaf["path"], []).extend(
                    leaf_blocks(leaf))
        expect = unit_leaf_shapes(self.mgr.registry, unit, kind,
                                  specs=model_specs)
        for path, shape in expect.items():
            blocks = per_leaf.get(path)
            if not blocks:
                raise ShardBarrierError(
                    f"{unit}/{kind}: no participant covered leaf {path}")
            if shapes[path] != shape:
                raise ShardBarrierError(
                    f"{unit}/{kind}: leaf {path} global shape "
                    f"{shapes[path]} != model shape {shape}")
            if not shd.blocks_cover_exactly(shape, blocks):
                raise ShardBarrierError(
                    f"{unit}/{kind}: shard blocks for leaf {path} do not "
                    f"exactly tile {shape}: {blocks}")
        unknown = set(per_leaf) - set(expect)
        if unknown:
            raise ShardBarrierError(
                f"{unit}/{kind}: shard records cover unknown leaves "
                f"{sorted(unknown)}")

    def commit(self, step: int, n_participants: int, *,
               meta: Optional[Dict] = None,
               check_cover: bool = True) -> Manifest:
        mgr = self.mgr
        # Only this cohort's records count: a crashed wider attempt at the
        # same step leaves records that must not block a narrower retry.
        records = {pid: rec
                   for pid, rec in self.participant_records(step).items()
                   if (pid < n_participants
                       and int(rec["n_participants"]) == n_participants)}
        missing = [p for p in range(n_participants) if p not in records]
        if missing:
            raise ShardBarrierError(
                f"step {step}: missing participant records {missing} "
                f"(have {sorted(records)}) — previous manifest stays "
                "authoritative")
        first = records[min(records)]
        saved_units = list(first["saved_units"])
        for pid, rec in records.items():
            if list(rec["saved_units"]) != saved_units:
                raise ShardBarrierError(
                    f"step {step}: participant {pid} selected "
                    f"{rec['saved_units']} but participant {min(records)} "
                    f"selected {saved_units} — policies disagree")
            if int(rec["event_index"]) != int(first["event_index"]):
                raise ShardBarrierError(
                    f"step {step}: participant {pid} derived event_index "
                    f"{rec['event_index']} but participant {min(records)} "
                    f"derived {first['event_index']} — records straddle "
                    "another commit; re-run the participants")

        prev = _usable_prev(mgr.manifests.load())
        entries: Dict[str, Dict[str, Any]] = (
            {u: dict(k) for u, k in prev.entries.items()} if prev else {})
        model_specs = (mgr.registry.model.param_specs()
                       if check_cover else None)
        for unit in saved_units:
            for kind in ("weights", "opt"):
                refs: List[ChunkRef] = []
                for pid in sorted(records):
                    for rj in (records[pid]["units"].get(unit, {})
                               .get(kind, [])):
                        refs.append(ChunkRef.from_json(rj))
                if not refs:
                    raise ShardBarrierError(
                        f"step {step}: no participant published shards "
                        f"for selected unit {unit}/{kind}")
                for ref in refs:
                    for d in filter(None, (ref.digest, ref.delta_base)):
                        if not mgr.store.has(d):
                            raise ShardBarrierError(
                                f"step {step}: shard object {d} for "
                                f"{unit}/{kind} is not durable in the "
                                "store — refusing to commit")
                if check_cover:
                    self._check_cover(unit, kind, refs, model_specs)
                entries[unit] = dict(entries.get(unit, {}))
                entries[unit][kind] = tuple(refs)

        # Every record valid, every object present: the manifest write
        # (with its own manifest_commit/manifest_latest points) is next.
        faults.crash_point("barrier")
        event_index = int(first["event_index"])
        storage = mgr.store.durability()
        manifest = Manifest(
            step=step, entries=entries,
            meta=dict(first.get("meta", {}), **(meta or {}),
                      event_index=event_index, policy=first["policy"],
                      storage=storage,
                      sharded={"n_participants": n_participants}),
            saved_units=saved_units)
        replaced = mgr.manifests.load(step)
        mgr.manifests.commit(manifest)
        mgr.store.incref(manifest.referenced_digests().elements())
        if replaced is not None:
            mgr.store.decref(replaced.referenced_digests().elements())
        mgr._event_index = event_index + 1
        mgr.gc()
        log.info("sharded commit: step %s, %d participants, %d units, "
                 "durable_on=%s", step, n_participants, len(saved_units),
                 storage["durable_on"])
        # This step's records served their purpose, and an older crashed
        # event's are stale (its orphaned objects went with the GC).
        for d in (Path(mgr.root) / "shards").glob("step-*"):
            try:
                if int(d.name.split("-")[1]) <= step:
                    shutil.rmtree(d, ignore_errors=True)
            except (ValueError, IndexError):
                continue
        return manifest


# ---------------------------------------------------------------------------
# Virtual participants (one process)
# ---------------------------------------------------------------------------

class ShardedCheckpointer:
    """N virtual participants on threads over one manager, then the
    commit: the trainer's ``--shard-participants N``.  Each thread runs
    the real participant path (its own blocks, shard dedup and deltas, its
    record); only the store, its writer and the card are shared.  ``save``
    returns the manifest and leaves the event's stats, the JAX
    checkpointer's keys plus the port's time split, in the manager's
    ``last_save_stats``; everything else delegates to the manager."""

    def __init__(self, manager, n_participants: int, *,
                 shardings: Optional[Dict[str, PyTree]] = None,
                 parallel: bool = True):
        self.mgr = manager
        self.n_participants = int(n_participants)
        self.savers = [ShardedSaver(manager, pid, self.n_participants,
                                    shardings=shardings)
                       for pid in range(self.n_participants)]
        self.coordinator = ShardCoordinator(manager)
        self.parallel = parallel

    def save(self, state: Dict[str, PyTree], *, step: Optional[int] = None,
             meta: Optional[Dict] = None,
             drift_scores: Optional[Dict[str, float]] = None,
             units: Optional[Sequence[str]] = None,
             durability_barrier: Optional[bool] = None) -> Manifest:
        t0 = time.time()
        step = int(state["step"]) if step is None else int(step)
        self.mgr.store.reset_stats()
        # One manifest parse for the event, shared by every participant
        # (the barrier checks that they agree on it).
        prev = self.mgr.manifests.load()
        barrier = (True if durability_barrier is None
                   else durability_barrier)

        def run(saver: ShardedSaver) -> ParticipantResult:
            return saver.save_shards(state, step=step, meta=meta,
                                     drift_scores=drift_scores, prev=prev,
                                     units=units,
                                     durability_barrier=barrier)

        if self.parallel and self.n_participants > 1:
            with ThreadPoolExecutor(
                    max_workers=self.n_participants,
                    thread_name_prefix="ckpt-shard") as pool:
                results = list(pool.map(run, self.savers))
        else:
            results = [run(s) for s in self.savers]
        t_records = time.time()
        manifest = self.coordinator.commit(step, self.n_participants)
        # The commit is durable: only now may the references advance.
        for r in results:
            self.mgr._fp_refs.update(r.new_fps)
        total = time.time() - t0
        io = self.mgr.store.stats_snapshot()
        d2h = sum(r.stats["d2h_bytes"] for r in results)
        moved = sum(r.stats["blocks_moved"] for r in results)
        blocks = sum(r.stats["blocks_total"] for r in results)
        self.mgr.last_save_stats = {
            "step": step,
            "selected_units": len(manifest.saved_units),
            "total_units": len(self.mgr.registry.units),
            "participants": self.n_participants,
            "shard_objects": sum(r.stats["shard_objects"] for r in results),
            "snapshot_bytes": d2h,
            "total_seconds": total,
            "d2h_bytes": d2h,
            "hashed_bytes": io["hashed_bytes"],
            "dirty_block_frac": (moved / blocks if blocks
                                 else (0.0 if self.mgr.fingerprint else 1.0)),
            "logical_bytes": io["logical_bytes"],
            "written_bytes": io["written_bytes"],
            "dedup_hits": io["dedup_hits"],
            "delta_chunks": io["delta_chunks"],
            "full_chunks": io["full_chunks"],
            "backend": manifest.meta["storage"]["backend"],
            "durable_on": manifest.meta["storage"]["durable_on"],
            "spill_pending": manifest.meta["storage"]["pending_spill"],
            # the port's split: the participants' phase (their threads
            # from the start to the last record), the barrier and commit;
            # the whole event blocks the caller
            "snapshot_seconds": t_records - t0,
            "stage_seconds": 0.0,
            "writeback_seconds": 0.0,
            "commit_seconds": time.time() - t_records,
            "stall_seconds": total,
            "seconds": total,
            "participant_seconds": [r.stats["seconds"] for r in results],
            # each participant's fingerprint, device->host staging (its
            # stream sync waits for every participant's queued copies) and
            # inline write seconds
            **{f"participant_{k}": [r.stats[k] for r in results]
               for k in ("fingerprint_seconds", "d2h_seconds",
                         "write_seconds")},
            "save_mode": "sharded",
            "io_backend": self.mgr.store.dispatch.backend,
        }
        return manifest

    def __getattr__(self, name: str):
        # restore / restore_meta / drain_spill / close / store /
        # last_save_stats / disk_usage ... delegate to the manager.
        return getattr(self.mgr, name)


# ---------------------------------------------------------------------------
# Tests and the card check
# ---------------------------------------------------------------------------

def combine_states(state_like: Dict[str, PyTree], registry,
                   results: Sequence[Dict[str, PyTree]],
                   wanteds: Sequence[WantedFn],
                   parts: Sequence[str] = ("params", "opt")
                   ) -> Dict[str, PyTree]:
    """Stitch per-participant restores into one state: each participant
    contributes exactly its owned blocks (its restore is only guaranteed
    there).  ``state_like`` gives shapes and dtypes (``TensorSpec`` trees);
    the result lies on the results' device."""
    dev = (flatten_with_paths(results[0][parts[0]])[0][1].device
           if results else torch.device("cpu"))
    out: Dict[str, PyTree] = {
        p: tree_map(lambda s: torch.zeros(tuple(s.shape), dtype=s.dtype,
                                          device=dev), state_like[p])
        for p in parts}
    for res, wanted in zip(results, wanteds):
        for name in registry.unit_names():
            for part in parts:
                kind = "weights" if part == "params" else "opt"
                if part == "params":
                    src = registry.extract_unit(res["params"], name)
                    dst = registry.extract_unit(out["params"], name)
                else:
                    src = registry.extract_opt_unit(res["opt"], name)
                    dst = registry.extract_opt_unit(out["opt"], name)
                flat_dst = dict(flatten_with_paths(dst))
                with torch.no_grad():
                    for path, arr in flatten_with_paths(src):
                        shape = tuple(int(d) for d in arr.shape)
                        blocks = wanted(name, kind, path, shape)
                        if blocks is None:
                            blocks = (tuple((0, d) for d in shape),)
                        for blk in blocks:
                            _block_view(flat_dst[path], blk).copy_(
                                _block_view(arr, blk))
    if results and "step" in results[0]:
        out["step"] = results[0]["step"].clone()
    return out
