"""Restore of the port: a plan over the manifest chain, streamed host->
device.  The full train state, or only the parts asked for:
``parts=("params",)`` is the weights-only load of a server, which plans,
and so opens, no optimizer object; ``units=`` keeps the units whose names
start with one of its prefixes.

The plan (``plan_restore``) holds, for every (unit, kind), the manifest's
entry first and then every different object an older manifest holds for
that unit, newest first (the fallback chain), with candidates whose object
or delta base no tier holds dropped up front; and it counts the dependents
of every digest the primaries touch, each digest once however many targets
share it.  The engine (:class:`RestoreEngine`) reads every object once
through one ``ReadSession``: ``io_threads`` pool threads read a candidate
into host memory (pinned when the target is a CUDA device), decode it and
check each tensor record's crc32 (on the process backend, the decode and
host checks run in the store's subprocess workers), and the calling thread
copies each finished unit into its slice of the state and verifies it by
fingerprinting the placed tensors on the device (the ``block_fp`` kernel)
against the table stored in the object, whose blake2 is the object's
address.  A digest is released once its last dependent is placed.  An
int8 record crosses to the device as it is stored (q and scales) and the
``dequantize`` kernel writes the destination leaf; a lossy object is
checked by its crc32s alone (its table describes the tensors before
quantization), as in the JAX package.  A canonically addressed object (the
``fingerprint=False`` path: a full object, or an XOR delta rebuilt against
its base's canonical payload) is checked by the blake2 of its canonical
payload; where that base is an fp object, its tensors are placed on the
target device and its table checked there first
(:func:`device_materializer`, run by the thread that reads the delta: the
one device work off the calling thread).  A candidate that fails, on the
host or on the device, falls through to the next one (an object absent
from every tier, or still unreadable after the store's transient-IO
retries, included); a unit with no good candidate raises ``RestoreError``.
A shard set (``checkpoint/sharded.py``) is one target per shard object,
its blocks copied straight into their places in the unit's leaves and its
table checked on those views; ``owned=`` plans only the shard objects a
participant's blocks meet, the rest of those units restoring as zeros.
``verify=False`` skips every check.  ``last_stats`` records the JAX
engine's keys (``pipelined``, ``io_threads``, ``verify``,
``objects_read``, ``unique_digests``, ``planned_object_reads``,
``io_backend`` and, on the process backend, the restore lane's
``workers`` counts), the tier each unit was served from (``unit_tiers``),
the object reads per tier (``tier_reads``), the retried transient errors
(``io_retries``), the candidates dropped because a scrub quarantined
their object or its base (``quarantined_skipped``: the planner never reads
a digest in ``QUARANTINE.json``) and the time split.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import fingerprint as fputil
from repro_torch.checkpoint.async_io import lane_delta
from repro_torch.checkpoint.chunk_store import (ChunkRef, ChunkStore,
                                                ReadSession)
from repro_torch.checkpoint.serial import (ChunkCorruption,
                                           flatten_with_paths,
                                           unflatten_from_paths)
from repro_torch.checkpoint.sharded import (WantedFn, check_spec,
                                            shard_views, spec_key,
                                            spec_overlaps)
from repro_torch.checkpoint.workers import Int8Record, Items
from repro_torch.core.layer_registry import OPT_KINDS, LayerRegistry
from repro_torch.core.manifest import (Manifest, ManifestStore, entry_refs,
                                       is_sharded)
from repro_torch.dtypes import byte_view, dtype_name, from_bytes, torch_dtype
from repro_torch.kernels import block_fp as bfp
from repro_torch.kernels import quantize as qz
from repro_torch.optim.groups import tree_map

log = logging.getLogger("repro_torch.checkpoint.restore")

PyTree = Any

PARTS = ("params", "opt")
_PART_KIND = {"params": "weights", "opt": "opt"}
DEFAULT_IO_THREADS = 4


class RestoreError(RuntimeError):
    pass


def host_buffer_alloc(device: torch.device):
    """Allocator for object reads: pinned host memory for a CUDA target (so
    the host->device copy is a DMA), plain memory for the CPU."""
    if device.type == "cuda":
        return lambda n: torch.empty(n, dtype=torch.uint8,
                                     pin_memory=True).numpy()
    return bytearray


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One readable object for a (unit, kind) target."""
    manifest_step: int      # the manifest this ref was resolved from
    ref: ChunkRef

    def digests(self) -> Tuple[str, ...]:
        """The digests a read of this candidate touches (object, base)."""
        if self.ref.delta_base:
            return (self.ref.digest, self.ref.delta_base)
        return (self.ref.digest,)


@dataclasses.dataclass(frozen=True)
class UnitRead:
    """A target's read plan: the manifest's object first, then the
    older manifests' different objects for the unit, newest first.  A
    shard set plans one target per scheduled shard object (``spec`` its
    shard spec); a global entry one target with ``spec=None``."""
    unit: str
    kind: str               # "weights" | "opt"
    chain: Tuple[Candidate, ...]
    spec: Optional[Dict[str, Any]] = None

    @property
    def primary(self) -> Candidate:
        return self.chain[0]


@dataclasses.dataclass
class RestorePlan:
    step: int                       # the manifest step restored
    parts: Tuple[str, ...]
    targets: List[UnitRead]
    # digest -> the targets (and their delta bases) that need it, over the
    # primary candidates: when a digest's count reaches 0 it is released
    dependents: Dict[str, int]
    # candidates dropped because a scrub quarantined their object or base
    quarantined_skipped: int = 0
    # shard sets: (unit, kind) -> (scheduled, total) shard objects; fewer
    # scheduled than total where ``owned`` ruled some out (those blocks
    # restore as zeros)
    shard_groups: Dict[Tuple[str, str], Tuple[int, int]] = \
        dataclasses.field(default_factory=dict)
    shards_skipped: int = 0

    @property
    def unique_digests(self) -> int:
        return len(self.dependents)

    @property
    def planned_object_reads(self) -> int:
        """Reads a restore without the read-once memo would issue: one per
        target object and one per delta base it replays."""
        return sum(len(t.primary.digests()) for t in self.targets)


def _select_units(unit_names: Sequence[str],
                 units: Optional[Sequence[str]]) -> List[str]:
    """The unit names equal to or starting with one of ``units`` (all of
    them for None; a bare string is one pattern)."""
    if units is None:
        return list(unit_names)
    pats = (units,) if isinstance(units, str) else tuple(units)
    out = [n for n in unit_names
           if any(n == p or n.startswith(p) for p in pats)]
    if not out:
        raise RestoreError(f"unit filter {units!r} matches no units")
    return out


def plan_restore(manifests: ManifestStore, store: ChunkStore,
                 unit_names: Sequence[str], *, step: Optional[int] = None,
                 parts: Sequence[str] = PARTS,
                 units: Optional[Sequence[str]] = None,
                 owned: Optional[WantedFn] = None,
                 manifest: Optional[Manifest] = None) -> RestorePlan:
    """The read plan of the ``parts`` of the units ``units`` selects
    (``_select_units``): per (unit, kind) a chain of candidates whose
    objects (and delta bases) some tier holds, best first, so an object
    already missing costs a lookup here and no failed read later; and the
    dependents count of every digest the primaries touch, each digest once
    however many targets share it.  A candidate whose object or delta base
    a scrub quarantined is left out and counted in
    ``quarantined_skipped``.  A caller-supplied ``manifest``
    replaces the ``step`` lookup; the older manifests of the store still
    give the fallbacks.

    A shard set plans one target per shard object; ``owned`` (a
    participant's resolver, ``sharded.participant_wanted``) keeps only the
    shard objects whose blocks meet its own (``shards_skipped`` counts the
    rest).  A shard's fallbacks are older shards of the same layout (equal
    ``spec_key``), never a global object.  Where any scheduled shard of a
    unit falls back, every shard of it is anchored on the newest step all
    of them can serve: a tensor is never assembled from two steps, and no
    such step at all raises ``RestoreError``."""
    parts = tuple(parts)
    if not parts or any(p not in PARTS for p in parts):
        raise RestoreError(f"restore parts {parts!r} must be a "
                           f"non-empty subset of {PARTS}")
    if manifest is None:
        manifest = manifests.load(step)
    if manifest is None:
        raise RestoreError(f"no manifest found in {manifests.root}")
    older: Dict[Tuple[str, str], List[Tuple[int, Any]]] = {}
    for s in manifests.all_steps():
        if s >= manifest.step:
            continue
        m = manifests.load(s)
        for unit, entries in (m.entries.items() if m else ()):
            for kind, entry in entries.items():
                older.setdefault((unit, kind), []).append((s, entry))
    targets: List[UnitRead] = []
    dependents: Dict[str, int] = {}
    shard_groups: Dict[Tuple[str, str], Tuple[int, int]] = {}
    quarantined = shards_skipped = 0

    def readable(ref: ChunkRef) -> bool:
        nonlocal quarantined
        if not store.has(ref.digest):
            return False
        if (store.quarantined(ref.digest)
                or (ref.delta_base and store.quarantined(ref.delta_base))):
            quarantined += 1
            return False
        return not ref.delta_base or store.has(ref.delta_base)

    def add(target: UnitRead) -> None:
        targets.append(target)
        for d in target.primary.digests():
            dependents[d] = dependents.get(d, 0) + 1

    for name in _select_units(unit_names, units):
        if name not in manifest.entries:
            raise RestoreError(f"manifest missing unit {name}")
        for kind in (_PART_KIND[p] for p in parts):
            if kind not in manifest.entries[name]:
                raise RestoreError(f"manifest missing {name}/{kind}")
            entry = manifest.entries[name][kind]
            past = list(reversed(older.get((name, kind), [])))
            if not is_sharded(entry):
                cands = [(manifest.step, entry)] + [
                    (s, e) for s, e in past if not is_sharded(e)]
                chain, seen = [], set()
                for s, ref in cands:
                    if not ref.digest or ref.digest in seen:
                        continue
                    seen.add(ref.digest)
                    if readable(ref):
                        chain.append(Candidate(s, ref))
                    elif s == manifest.step:
                        log.warning("object for %s/%s at step %s is "
                                    "missing or quarantined; fallback "
                                    "resolved at plan time", name, kind, s)
                if not chain:
                    raise RestoreError(
                        f"no readable chunk for unit {name}/{kind}")
                add(UnitRead(name, kind, tuple(chain)))
                continue

            refs = entry_refs(entry)
            # the older shards by layout, newest first, in one pass
            by_layout: Dict[Tuple, List[Candidate]] = {}
            for s, e in past:
                if is_sharded(e):
                    for r in entry_refs(e):
                        if r.spec is not None:
                            by_layout.setdefault(spec_key(r.spec),
                                                 []).append(Candidate(s, r))
            group: List[UnitRead] = []
            # per target: manifest step -> the readable candidate serving
            # it (an unchanged shard dedups to one digest across steps,
            # so one object can serve several steps)
            step_maps: List[Dict[int, Candidate]] = []
            for ref in refs:
                if ref.spec is None:
                    raise RestoreError(
                        f"sharded entry for {name}/{kind} has a ref "
                        "without a shard spec — manifest is corrupt")
                if owned is not None and not spec_overlaps(ref.spec, owned,
                                                           name, kind):
                    shards_skipped += 1
                    continue
                cands = ([Candidate(manifest.step, ref)]
                         + by_layout.get(spec_key(ref.spec), []))
                chain, steps, seen = [], {}, set()
                for c in cands:
                    if not c.ref.digest or not readable(c.ref):
                        if c is cands[0]:
                            log.warning(
                                "shard object for %s/%s at step %s missing "
                                "on disk; fallback resolved at plan time",
                                name, kind, c.manifest_step)
                        continue
                    steps[c.manifest_step] = c
                    if c.ref.digest not in seen:
                        seen.add(c.ref.digest)
                        chain.append(c)
                if not chain:
                    raise RestoreError(
                        f"no readable shard object for unit {name}/{kind} "
                        f"(participant {ref.spec.get('participant')})")
                group.append(UnitRead(name, kind, tuple(chain),
                                      spec=ref.spec))
                step_maps.append(steps)
            if (len(group) > 1
                    and any(t.primary.manifest_step != manifest.step
                            for t in group)):
                common = set.intersection(*(set(m) for m in step_maps))
                if not common:
                    raise RestoreError(
                        f"unit {name}/{kind}: no single manifest step is "
                        "readable by every shard — refusing to assemble "
                        "a mixed-step tensor")
                best = max(common)
                group = [dataclasses.replace(
                    t, chain=(m[best],) + tuple(
                        c for c in t.chain
                        if c.ref.digest != m[best].ref.digest))
                    for t, m in zip(group, step_maps)]
                log.warning("unit %s/%s: aligning all %d shards on "
                            "manifest step %s (newest step readable by "
                            "every shard)", name, kind, len(group), best)
            for t in group:
                add(t)
            shard_groups[(name, kind)] = (len(group), len(refs))
    return RestorePlan(step=manifest.step, parts=parts, targets=targets,
                       dependents=dependents,
                       quarantined_skipped=quarantined,
                       shard_groups=shard_groups,
                       shards_skipped=shards_skipped)


def place_leaves(dsts: Sequence[Tuple[torch.Tensor, Any]]) -> int:
    """Write each ``(leaf, value)``'s value into the leaf in place: a host
    tensor by one copy; an ``Int8Record`` by copying its q and scales to
    the leaf's device (into one buffer, each record on 16 bytes) and one
    ``dequantize`` launch for all of them.  Returns the bytes moved to the
    leaves' device."""
    moved = 0
    quant = []
    with torch.no_grad():
        for dst, value in dsts:
            if isinstance(value, Int8Record):
                quant.append((dst, value))
                continue
            dst.copy_(value)
            moved += value.numel() * value.element_size()
        if not quant:
            return moved
        offs, total = [], 0
        for _, rec in quant:
            offs.append(total)
            total += -(-rec.nbytes // 16) * 16
        dev = quant[0][0].device
        buf = torch.empty(total, dtype=torch.uint8, device=dev)
        for off, (_, rec) in zip(offs, quant):
            src = np.frombuffer(rec.data, np.uint8)
            buf[off:off + rec.nbytes].copy_(torch.from_numpy(
                src if src.flags.writeable else src.copy()))
            moved += rec.nbytes
        records = []
        for off, (_, rec) in zip(offs, quant):
            q = buf[off:off + rec.n_q].view(torch.int8)
            s = buf[off + rec.n_q:off + rec.nbytes].view(torch.float32)
            records.append((q, s))
        qz.dequantize_unit(records, [dst for dst, _ in quant])
    return moved


def verify_placed(tree: PyTree, fp_blob: bytes, digest: str) -> None:
    """Fingerprint the tensors of a placed unit where they lie (the
    ``block_fp`` kernel on the card) and compare the packed table with the
    object's, whose blake2 is its address; raise ``ChunkCorruption`` on a
    mismatch."""
    tbl = fputil.unpack_table(fp_blob)
    bb = tbl[0].block_bytes if tbl else fputil.DEFAULT_BLOCK_BYTES
    cur = bfp.tree_to_host(bfp.fingerprint_tree(tree, block_bytes=bb))
    if fputil.pack_table(cur) != bytes(fp_blob):
        raise ChunkCorruption(f"fingerprint mismatch for reconstructed "
                              f"{digest}")


def place_items(items: Items, device: torch.device) -> Dict[str, torch.Tensor]:
    """New tensors on ``device`` holding decoded items (an ``Int8Record``
    dequantized there), by path."""
    leaves, pairs = {}, []
    for name, shape, dtype, raw in items:
        leaves[name] = torch.empty(tuple(shape), dtype=torch_dtype(dtype),
                                   device=device)
        pairs.append((leaves[name], raw if isinstance(raw, Int8Record)
                      else from_bytes(raw, shape, dtype)))
    place_leaves(pairs)
    return leaves


def device_materializer(device: torch.device):
    """The store's ``materialize`` hook on ``device``: place an object's
    items there (int8 records dequantized by the ``dequantize`` kernel on
    the card), check an fp object's table there (``verify_placed``, the
    ``block_fp`` kernel on the card) and return the items with every
    record as raw host bytes (the dequantized leaves copied back).  The
    store calls it where it needs the canonical payload of an fp or lossy
    object: an XOR delta's base."""
    def materialize(items: Items, fp_blob: Optional[bytes],
                    digest: str) -> Items:
        leaves = place_items(items, device)
        if fp_blob is not None:
            verify_placed(unflatten_from_paths(leaves), fp_blob, digest)
        out = []
        for name, shape, dtype, raw in items:
            if isinstance(raw, Int8Record):
                raw = memoryview(byte_view(leaves[name]).cpu().numpy())
            out.append((name, shape, dtype, raw))
        return out

    return materialize


class RestoreEngine:
    """Runs a :class:`RestorePlan` as a stream: ``io_threads`` pool threads
    read, decode and check the objects (into pinned host buffers for a
    CUDA target; on the process backend the decode and host checks run in
    the store's subprocess workers), while the calling thread copies each
    finished unit host->device and verifies it there (``verify_placed``,
    the ``block_fp`` kernel on the card), in the order the reads complete:
    all device work stays on the calling thread.  ``pipelined=False`` (or
    ``io_threads <= 1``) runs the same plan in target order on the calling
    thread.  One :class:`ReadSession` serves the whole restore, so a digest
    several targets share is read once, and is released when its last
    dependent is placed.  ``verify=False`` checks no crc32, no address and
    no table on the device (no ``block_fp`` launch): the JAX engine's
    trusted-storage switch."""

    def __init__(self, store: ChunkStore, manifests: ManifestStore,
                 registry: LayerRegistry, *,
                 io_threads: int = DEFAULT_IO_THREADS, verify: bool = True):
        self.store = store
        self.manifests = manifests
        self.registry = registry
        self.io_threads = max(1, int(io_threads))
        self.verify = bool(verify)
        self.last_stats: Dict[str, Any] = {}

    def _read_target(self, target: UnitRead, session: ReadSession,
                     start: int = 0) -> Tuple[int, Any, Optional[bytes],
                                              float]:
        """(chain index, tree, table blob, seconds) of the first candidate
        from ``start`` on that reads and decodes."""
        offload = self.store.dispatch.is_process
        last_exc: Optional[Exception] = None
        t0 = time.perf_counter()
        for i in range(start, len(target.chain)):
            cand = target.chain[i]
            try:
                if offload:
                    tree, fp_blob = session.read_offload(cand.ref.digest)
                else:
                    tree, fp_blob = session.read(cand.ref.digest)
            except (FileNotFoundError, ChunkCorruption) as e:
                log.warning("chunk %s/%s from manifest %s unreadable (%s); "
                            "falling back", target.unit, target.kind,
                            cand.manifest_step, e)
                last_exc = e
                continue
            return i, tree, fp_blob, time.perf_counter() - t0
        raise RestoreError(f"no readable chunk for unit "
                           f"{target.unit}/{target.kind}") from last_exc

    def _place(self, target: UnitRead, digest: str, tree: Any,
               fp_blob: Optional[bytes], state: Dict[str, PyTree],
               timings: Dict[str, float]) -> int:
        """Copy a decoded unit into its slice of the state and verify it
        there; returns the bytes copied to the device."""
        t1 = time.perf_counter()
        name, kind = target.unit, target.kind
        if kind == "weights":
            dst = self.registry.extract_unit(state["params"], name)
        else:
            dst = self.registry.extract_opt_unit(state["opt"], name)
        want = dict(flatten_with_paths(dst))
        if target.spec is not None:
            # A shard object: each block straight into its place in the
            # unit's leaves (an axis-0 block of a leaf is contiguous), and
            # the object's table checked on those views.
            try:
                pairs = check_spec(target.spec, want, tree)
            except ValueError as e:
                raise ChunkCorruption(f"shard object {digest}: {e}") from e
            moved = place_leaves(pairs)
            t2 = time.perf_counter()
            if fp_blob is not None:
                verify_placed(shard_views(target.spec, want), fp_blob,
                              digest)
            timings["h2d_seconds"] += t2 - t1
            timings["verify_seconds"] += time.perf_counter() - t2
            return moved
        got = flatten_with_paths(tree)
        if {p for p, _ in got} != set(want):
            raise ChunkCorruption(f"object {digest} holds leaves "
                                  f"{sorted(p for p, _ in got)}, the unit "
                                  f"wants {sorted(want)}")
        pairs = []
        for path, value in got:
            t = want[path]
            if isinstance(value, Int8Record):
                shape, dtype = tuple(value.shape), value.dtype
            else:
                shape, dtype = tuple(value.shape), dtype_name(value.dtype)
            if shape != tuple(t.shape) or dtype != dtype_name(t.dtype):
                raise RestoreError(
                    f"{name}/{path}: object holds {dtype}{list(shape)}, the "
                    f"state wants {dtype_name(t.dtype)}{list(t.shape)}")
            pairs.append((t, value))
        # ``want`` holds the unit's own tensors (views into the state)
        moved = place_leaves(pairs)
        t2 = time.perf_counter()
        if fp_blob is not None:
            verify_placed(dst, fp_blob, digest)
        timings["h2d_seconds"] += t2 - t1
        timings["verify_seconds"] += time.perf_counter() - t2
        return moved

    def restore(self, state_like: Dict[str, PyTree], *,
                device: torch.device, step: Optional[int] = None,
                parts: Sequence[str] = PARTS,
                units: Optional[Sequence[str]] = None,
                pipelined: bool = True,
                owned: Optional[WantedFn] = None,
                manifest: Optional[Manifest] = None) -> Dict[str, PyTree]:
        """Rebuild a train state from the manifest chain (the implicit
        Frankenstein merge).  ``state_like`` gives the structure as
        ``TensorSpec`` trees under each of ``parts`` ("params", "opt"); the
        result holds them on ``device`` plus ``step`` (a host int32
        tensor).  ``parts=("params",)`` plans and reads only the weights
        objects; ``units`` keeps the units whose names start with one of
        its prefixes (the others restore as zeros); ``owned`` reads only
        the shard objects meeting a participant's blocks (the rest of
        those units restore as zeros); ``manifest`` replaces the ``step``
        lookup."""
        t0 = time.perf_counter()
        plan = plan_restore(self.manifests, self.store,
                            self.registry.unit_names(), step=step,
                            parts=parts, units=units, owned=owned,
                            manifest=manifest)
        state: Dict[str, PyTree] = {
            p: tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                              device=device), state_like[p])
            for p in plan.parts}
        if "opt" in state and set(state["opt"]) != set(OPT_KINDS):
            raise RestoreError("opt state must hold master, m and v")
        session = ReadSession(self.store, alloc=host_buffer_alloc(device),
                              materialize=device_materializer(device),
                              verify=self.verify)
        dispatch = self.store.dispatch
        workers0 = dispatch.stats()
        timings = {"read_seconds": 0.0, "wait_seconds": 0.0,
                   "h2d_seconds": 0.0, "verify_seconds": 0.0}
        fallbacks: Dict[str, int] = {}
        # unit/kind -> the tier its object was served from
        unit_tiers: Dict[str, str] = {}
        remaining = dict(plan.dependents)
        io_retries0 = self.store.io_retries
        sec0 = self.store.seconds_snapshot()
        h2d = 0

        def consume(target: UnitRead, read) -> None:
            nonlocal h2d
            i, tree, fp_blob, secs = read
            timings["read_seconds"] += secs
            while True:
                cand = target.chain[i]
                try:
                    h2d += self._place(target, cand.ref.digest, tree,
                                       fp_blob, state, timings)
                    break
                except ChunkCorruption as e:
                    log.warning("chunk %s/%s from manifest %s failed its "
                                "check on %s (%s); falling back",
                                target.unit, target.kind,
                                cand.manifest_step, device, e)
                    i, tree, fp_blob, secs = self._read_target(
                        target, session, i + 1)
                    timings["read_seconds"] += secs
            key = f"{target.unit}/{target.kind}"
            tier = session.tiers.get(cand.ref.digest)
            if tier is not None:
                unit_tiers[key] = tier
            if cand.manifest_step != plan.step:
                fallbacks[key] = cand.manifest_step
            for d in target.primary.digests():
                n = remaining.get(d)
                if n is not None:
                    if n <= 1:
                        remaining.pop(d)
                        session.release(d)
                    else:
                        remaining[d] = n - 1

        run_parallel = (pipelined and self.io_threads > 1
                        and len(plan.targets) > 1)
        if run_parallel:
            with ThreadPoolExecutor(max_workers=self.io_threads,
                                    thread_name_prefix="ckpt-restore") as ex:
                futs = {ex.submit(self._read_target, t, session): t
                        for t in plan.targets}
                try:
                    while futs:
                        tw = time.perf_counter()
                        done, _ = wait(futs, return_when=FIRST_COMPLETED)
                        timings["wait_seconds"] += time.perf_counter() - tw
                        for f in done:
                            consume(futs.pop(f), f.result())
                except BaseException:
                    for f in futs:
                        f.cancel()
                    raise
        else:
            for t in plan.targets:
                consume(t, self._read_target(t, session))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        state["step"] = torch.tensor(plan.step, dtype=torch.int32)
        sec1 = self.store.seconds_snapshot()
        self.last_stats = {
            "step": plan.step,
            "seconds": time.perf_counter() - t0,
            "parts": list(plan.parts),
            "units": len({t.unit for t in plan.targets}),
            "targets": len(plan.targets),
            "pipelined": run_parallel,
            "io_threads": self.io_threads if run_parallel else 1,
            "verify": self.verify,
            # read accounting: each distinct object once
            "bytes_read": session.stats["bytes_read"],
            "objects_read": session.stats["object_reads"],
            "unique_digests": plan.unique_digests,
            "planned_object_reads": plan.planned_object_reads,
            "h2d_bytes": h2d,
            # shard objects among the targets, and those ``owned`` ruled
            # out
            "sharded_targets": sum(1 for t in plan.targets
                                   if t.spec is not None),
            "shards_skipped": plan.shards_skipped,
            "fallback_units": fallbacks,
            # read_seconds: the reads, decodes and host checks summed over
            # the threads that ran them; wait_seconds: the calling thread
            # waiting for them; h2d and verify: the calling thread's
            # device work
            **timings,
            "tier_reads": dict(session.tier_reads),
            "unit_tiers": unit_tiers,
            "io_retries": self.store.io_retries - io_retries0,
            # candidates the planner dropped: a scrub quarantined them
            "quarantined_skipped": plan.quarantined_skipped,
            # host split of read_seconds, summed over the threads: file
            # reads, decoding + crc32 checks (in the workers' calls on
            # the process backend), and the block cache's copies
            "read_io_seconds": sec1["read_io"] - sec0["read_io"],
            "decode_seconds": sec1["decode"] - sec0["decode"],
            "cache_copy_seconds": sec1["cache_copy"] - sec0["cache_copy"],
            "io_backend": dispatch.backend,
        }
        if workers0 is not None:
            self.last_stats["workers"] = lane_delta(
                workers0, dispatch.stats(), "restore")
        return state
