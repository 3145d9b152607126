"""Checkpoint manifest — the layer -> (step, chunk) map behind LLMTailor's
implicit merge.

Every save event commits a manifest that, for every layer unit, references
the newest chunk holding it (possibly from an older step when the
selective policy skipped the unit).  Restoring from a manifest therefore
is the paper's Frankenstein assembly, performed lazily.

Commit protocol (crash safety):
  1. all chunk files of the event are fully written (atomic renames),
  2. manifest-<step>.json is written atomically,
  3. the LATEST pointer is updated atomically.
A crash between any two steps leaves the previous manifest usable.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.checkpoint.backends.localfs import atomic_write
from repro_torch.checkpoint.chunk_store import ChunkRef
from repro_torch.checkpoint.faults import crash_point
from repro_torch.core import jsonutil


def is_sharded(entry) -> bool:
    """Whether a manifest entry is a shard set: a tuple of refs, one per
    shard object, each carrying the spec of the blocks it holds
    (``checkpoint/sharded.py``); a single ref is a global object."""
    return isinstance(entry, (tuple, list))


def entry_refs(entry) -> Tuple[ChunkRef, ...]:
    """The refs behind an entry (a 1-tuple for a global object)."""
    return tuple(entry) if is_sharded(entry) else (entry,)


@dataclasses.dataclass
class Manifest:
    step: int
    # unit -> kind -> a ref, or a tuple of shard refs (a shard set)
    entries: Dict[str, Dict[str, Any]]
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # Units saved at exactly this step (the policy's selection).
    saved_units: List[str] = dataclasses.field(default_factory=list)

    def to_json(self) -> bytes:
        def enc(entry):
            if is_sharded(entry):
                return [r.to_json() for r in entry]
            return entry.to_json()

        d = {
            "step": self.step,
            "meta": self.meta,
            "saved_units": self.saved_units,
            "entries": {u: {k: enc(e) for k, e in kinds.items()}
                        for u, kinds in self.entries.items()},
        }
        return jsonutil.dumps(d, indent=True)

    @staticmethod
    def from_json(blob: bytes) -> "Manifest":
        d = jsonutil.loads(blob)

        def dec(e):
            if isinstance(e, list):
                return tuple(ChunkRef.from_json(r) for r in e)
            return ChunkRef.from_json(e)

        return Manifest(
            step=d["step"],
            meta=d.get("meta", {}),
            saved_units=d.get("saved_units", []),
            entries={u: {k: dec(e) for k, e in kinds.items()}
                     for u, kinds in d["entries"].items()},
        )

    def referenced_digests(self) -> Counter:
        """Digest -> references held by this manifest; a delta object pins
        its full base, so the base digest is counted too, and every ref of
        a shard set counts."""
        counts: Counter = Counter()
        for kinds in self.entries.values():
            for entry in kinds.values():
                for ref in entry_refs(entry):
                    if ref.digest:
                        counts[ref.digest] += 1
                    if ref.delta_base:
                        counts[ref.delta_base] += 1
        return counts

    def digest_provenance(self) -> Dict[str, List[Tuple[str, str, str]]]:
        """Digest -> [(unit, kind, role)] for every object this manifest
        depends on; role is "entry" (referenced) or "base" (a delta base
        the entry replays through).  The scrub's report says with it
        whose bytes an unrecoverable object held, and which manifests a
        quarantined digest demotes."""
        prov: Dict[str, List[Tuple[str, str, str]]] = {}
        for unit, kinds in self.entries.items():
            for kind, entry in kinds.items():
                for ref in entry_refs(entry):
                    if ref.digest:
                        prov.setdefault(ref.digest, []).append(
                            (unit, kind, "entry"))
                    if ref.delta_base:
                        prov.setdefault(ref.delta_base, []).append(
                            (unit, kind, "base"))
        return prov


class ManifestStore:
    def __init__(self, root: Path | str):
        self.root = Path(root)
        (self.root / "manifests").mkdir(parents=True, exist_ok=True)

    def path(self, step: int) -> Path:
        return self.root / "manifests" / f"manifest-{step:08d}.json"

    def commit(self, manifest: Manifest) -> None:
        # Crash drills: before the manifest file is written, and between
        # it and the LATEST pointer (the previous step stays authoritative).
        crash_point("manifest_commit")
        atomic_write(self.path(manifest.step), manifest.to_json())
        crash_point("manifest_latest")
        atomic_write(self.root / "LATEST", str(manifest.step).encode())

    def latest_step(self) -> Optional[int]:
        p = self.root / "LATEST"
        if not p.is_file():
            return None
        return int(p.read_text().strip())

    def load(self, step: Optional[int] = None) -> Optional[Manifest]:
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        p = self.path(step)
        if not p.is_file():
            return None
        return Manifest.from_json(p.read_bytes())

    def all_steps(self) -> List[int]:
        return sorted(int(p.stem.split("-")[1])
                      for p in (self.root / "manifests").glob(
                          "manifest-*.json"))

    def delete(self, step: int) -> None:
        p = self.path(step)
        if p.is_file():
            p.unlink()
