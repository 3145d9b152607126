"""LLMTailor explicit merge engine of the port, and its CLI.

    python -m repro_torch.core.tailor RECIPE [--workers N] [--no-verify] \\
        [--device cpu]

Assembles a resumable "Frankenstein" checkpoint from layer units of
several source checkpoints per a YAML/JSON recipe (``core/recipe.py``):
the weights objects, the per-layer optimizer groups (master/m/v) unless
the recipe says ``optimizer: false``, and the step-level metadata, taken
from the base (newest) source.  The output is a normal checkpoint root
(one manifest and content-addressed objects) that a restore, a resumed
run or a server of either package consumes directly.  It is the JAX
package's ``repro/core/tailor.py``, and writes the same manifest and object
bytes.  ``stores=`` maps a source (``str(CheckpointRef)``) to a live,
already open ``ChunkStore`` (how a RAM-tier source is merged: its objects
exist only in that store), and ``out_store=`` replaces the default local
output store (a tiered one, say); the manifest commits after the output's
spill barrier and records its durability.

Digest-level copy: an object moves as its opaque envelope blob
(``ChunkStore.read_object_bytes``/``write_object_bytes``) under the same
content digest, read once from its source.  Units that share content land
as one object (the first claimant copies, later ones wait for it), and a
delta object brings its full base along, once.  A thread pool of
``workers`` overlaps the reads and writes.

Verification (``verify=True``, the default) reads every copied object back
from the output store and checks it with the store's
``verify_object_blob``, the check the scrub runs: the table->digest or
payload->digest checks (an XOR ``delta`` is rebuilt on its base and a zstd
object of the JAX package decoded, and the canonical payload hashed; a
lossy canonical object is checked by crc32 alone) and the crc32 of each
record, and then, where the JAX package recomputes an object's fingerprint
table (every fp-addressed object but a lossy full one, and an fp object
that anchors an XOR delta), the tensors are placed on ``device`` and
fingerprinted there (``restore.verify_placed``: the ``block_fp`` kernel on
the card, its plain version on the CPU).  A mismatch raises
``ChunkCorruption`` and no manifest is committed; ``verify=False``
(``--no-verify``) copies objects blob for blob unchecked, as the JAX merge
does.  Device memory of the verification is one object's tensors
per worker, freed after its check.

``device`` is resolved by ``devices.resolve_device``: the card by default,
the CPU only when asked for.
"""
from __future__ import annotations

import argparse
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint.chunk_store import (  # noqa: F401 (re-export)
    ChunkRef, ChunkStore, table_checked)
from repro_torch.checkpoint.restore import host_buffer_alloc
from repro_torch.core.manifest import (Manifest, ManifestStore, entry_refs,
                                       is_sharded)
from repro_torch.core.recipe import CheckpointRef, Recipe, expand_patterns
from repro_torch.devices import resolve_device


class MergeError(RuntimeError):
    pass


def variant_manifest(manifests: ManifestStore, *,
                     base_step: Optional[int] = None,
                     select: Any = (),
                     name: str = "variant") -> Manifest:
    """The zero-copy sibling of :func:`merge` for serving variants.

    A synthetic in-memory :class:`Manifest` whose entries are picked from
    several committed manifests of one store: no object is copied, no
    manifest is committed, and every entry keeps its digest.  Hand it to
    ``WeightService(manifest=...)`` (or a restore's ``manifest=``).

    ``select`` is a sequence of ``(patterns, step)`` pairs (or dicts with
    ``units``/``step`` keys, the recipe-YAML shape); patterns use the
    recipe syntax and later rules win.  Unselected units come from
    ``base_step`` (LATEST when None).
    """
    base = manifests.load(base_step)
    if base is None:
        raise MergeError(f"no manifest at step {base_step!r} "
                         f"under {manifests.root}")
    all_units = sorted(base.entries)
    assignment: Dict[str, int] = {u: base.step for u in all_units}
    for item in select:
        if isinstance(item, dict):
            pats, step = item["units"], int(item["step"])
        else:
            pats, step = item[0], int(item[1])
        if isinstance(pats, str):
            pats = [pats]
        for u in expand_patterns(list(pats), all_units):
            assignment[u] = step
    sources: Dict[int, Manifest] = {base.step: base}
    entries: Dict[str, Dict[str, Any]] = {}
    for unit in all_units:
        step = assignment[unit]
        m = sources.get(step)
        if m is None:
            m = manifests.load(step)
            if m is None:
                raise MergeError(f"variant {name!r}: no manifest at step "
                                 f"{step} under {manifests.root}")
            sources[step] = m
        if unit not in m.entries:
            raise MergeError(f"variant {name!r}: unit {unit!r} missing "
                             f"from manifest {step}")
        entries[unit] = dict(m.entries[unit])
    return Manifest(
        step=base.step,
        entries=entries,
        meta=dict(base.meta,
                  variant={"name": name, "assignment": assignment}),
        saved_units=[],
    )


def _load_manifest(ref: CheckpointRef,
                   stores: Optional[Dict[str, ChunkStore]] = None
                   ) -> Tuple[Manifest, ChunkStore]:
    m = ManifestStore(ref.root).load(ref.step)
    if m is None:
        raise MergeError(f"no manifest at {ref}")
    store = (stores or {}).get(str(ref))
    return m, (store if store is not None else ChunkStore(ref.root))


def verify_object(store: ChunkStore, digest: str,
                  device: torch.device) -> None:
    """Read ``digest`` back from ``store`` and check it as the JAX
    package's ``read_digest(verify=True)`` does, through the store's
    :meth:`~ChunkStore.verify_object_blob` (the scrub's check): the
    address checks, the crc32 of each record, and, where
    :func:`table_checked`, its tensors placed on ``device`` against the
    stored table.  Raises ``ChunkCorruption``."""
    blob = store.read_object_bytes(digest, host_buffer_alloc(device))
    store.verify_object_blob(digest, blob, device)


def merge(recipe: Recipe, *, workers: int = 4, verify: bool = True,
          device=None, stores: Optional[Dict[str, ChunkStore]] = None,
          out_store: Optional[ChunkStore] = None) -> Dict[str, Any]:
    """Execute a recipe; returns the JAX merge's stats (``units``,
    ``bytes`` written, ``chunks``, ``shared_chunks``, ``sources``,
    ``seconds``) and ``verify_seconds`` (summed over the workers).
    ``stores`` and ``out_store``: see the module doc."""
    dev = resolve_device(device)
    t0 = time.time()
    base_manifest, _ = _load_manifest(recipe.base, stores)
    all_units = sorted(base_manifest.entries)
    assignment = recipe.assignment(all_units)

    # Open every distinct source once.
    sources: Dict[str, Tuple[Manifest, ChunkStore]] = {}
    for ref in {str(r): r for r in assignment.values()}.values():
        sources[str(ref)] = _load_manifest(ref, stores)

    out_root = Path(recipe.output)
    if out_store is None:
        out_store = ChunkStore(out_root)
    out_step = base_manifest.step
    kinds = ("weights", "opt") if recipe.optimizer else ("weights",)

    stats: Dict[str, Any] = {"units": len(all_units), "bytes": 0,
                             "chunks": 0, "shared_chunks": 0,
                             "sources": len(sources), "verify_seconds": 0.0}
    # Two units (or a delta and its base) may resolve to the same digest;
    # the first claimant copies, later ones block until the object landed.
    claims: Dict[str, threading.Event] = {}
    lock = threading.Lock()

    def copy_object(src_store: ChunkStore, digest: str) -> int:
        """Copy one object (and, for a delta, its full base) by digest.
        Returns the bytes newly written into the output store."""
        with lock:
            done = claims.get(digest)
            owner = done is None
            if owner:
                done = claims[digest] = threading.Event()
        if not owner:
            done.wait()
            return 0
        try:
            if out_store.has(digest):
                return 0
            if not src_store.has(digest):
                raise MergeError(f"source object {digest} missing "
                                 f"under {src_store.root} "
                                 f"(backend={src_store.backend.name})")
            blob = src_store.read_object_bytes(digest)
            info = src_store.object_info(digest, blob)
            written = 0
            if info["stored"] != "full" and info["base"]:
                # XOR or block-sparse delta: the base is always a full
                # object, so this is one level of recursion
                written += copy_object(src_store, info["base"])
            out_store.write_object_bytes(digest, blob)
            return written + info["nbytes"]
        finally:
            done.set()

    def copy_unit(unit: str) -> List[Tuple]:
        """Copy (and verify) every object behind one unit before its
        entries are emitted: a shard set whole, each ref keeping its spec,
        so no output manifest names a partly copied shard set."""
        src_manifest, src_store = sources[str(assignment[unit])]
        if unit not in src_manifest.entries:
            raise MergeError(f"unit {unit!r} missing from "
                             f"{assignment[unit]}")
        out_entries = []
        for kind in kinds:
            entry = src_manifest.entries[unit][kind]
            written = shared = 0
            out_refs = []
            for ref in entry_refs(entry):
                if not ref.digest:
                    raise MergeError(
                        f"unit {unit!r} in {assignment[unit]} is a legacy "
                        "(pre-content-addressing) chunk; re-save it first")
                w = copy_object(src_store, ref.digest)
                written += w
                shared += 0 if w else 1
                if verify:
                    tv = time.perf_counter()
                    verify_object(out_store, ref.digest, dev)
                    with lock:
                        stats["verify_seconds"] += time.perf_counter() - tv
                out_refs.append(ChunkRef(
                    out_step, unit, kind,
                    out_store.object_relpath(ref.digest),
                    ref.nbytes, digest=ref.digest, stored=ref.stored,
                    delta_base=ref.delta_base, spec=ref.spec))
            out_entry = (tuple(out_refs) if is_sharded(entry)
                         else out_refs[0])
            out_entries.append((unit, kind, out_entry, written, shared,
                                len(out_refs)))
        return out_entries

    entries: Dict[str, Dict[str, Any]] = {}
    with ThreadPoolExecutor(max_workers=workers) as pool:
        for refs in pool.map(copy_unit, all_units):
            for unit, kind, entry, written, shared, n_objects in refs:
                entries.setdefault(unit, {})[kind] = entry
                stats["bytes"] += written
                stats["chunks"] += n_objects
                stats["shared_chunks"] += shared

    # Every copied object is durable before the manifest naming it exists.
    out_store.drain_spill()
    # The configuration and metadata come from the base (newest) source.
    manifest = Manifest(
        step=out_step,
        entries=entries,
        meta=dict(base_manifest.meta,
                  merged_from={u: str(r) for u, r in assignment.items()},
                  recipe_optimizer=recipe.optimizer,
                  storage=out_store.durability()),
        saved_units=all_units,
    )
    ManifestStore(out_root).commit(manifest)
    stats["seconds"] = time.time() - t0
    return stats


def main() -> None:
    ap = argparse.ArgumentParser(
        description="LLMTailor: assemble a resumable Frankenstein checkpoint")
    ap.add_argument("recipe", help="YAML or JSON recipe path")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--no-verify", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where copied objects are verified: 'cuda' "
                         "(default) or 'cpu'")
    args = ap.parse_args()
    recipe = Recipe.load(args.recipe)
    stats = merge(recipe, workers=args.workers, verify=not args.no_verify,
                  device=args.device)
    print(f"[llmtailor] merged {stats['units']} units "
          f"({stats['chunks']} chunks, {stats['shared_chunks']} shared, "
          f"{stats['bytes']/2**20:.1f} MiB written) "
          f"from {stats['sources']} checkpoints "
          f"in {stats['seconds']:.2f}s -> {recipe.output}")
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
