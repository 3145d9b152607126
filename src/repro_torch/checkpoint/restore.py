"""Full-state restore of the port: plan over the manifest, read, verify,
copy host->device per unit, insert.

For every (unit, kind) the plan holds the manifest's entry first and then
every different object an older manifest holds for that unit, newest first
(the fallback chain).  A candidate is read into host memory (pinned when
the target is a CUDA device), decoded, crc32-checked per tensor record,
copied into the unit's slice of the state, and then verified by
fingerprinting the placed tensors on the device (the ``block_fp`` kernel)
and comparing the packed table with the one stored in the object, whose
blake2 is the object's address.  A candidate that fails falls through to
the next one; a unit with no good candidate raises ``RestoreError``.
"""
from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.checkpoint import fingerprint as fputil
from repro_torch.checkpoint.chunk_store import ChunkRef, ChunkStore
from repro_torch.checkpoint.serial import (ChunkCorruption,
                                           flatten_with_paths,
                                           unflatten_from_paths)
from repro_torch.core.layer_registry import OPT_KINDS, LayerRegistry
from repro_torch.core.manifest import ManifestStore
from repro_torch.dtypes import dtype_name, from_bytes
from repro_torch.kernels import block_fp as bfp
from repro_torch.optim.groups import tree_map

log = logging.getLogger("repro_torch.checkpoint.restore")

PyTree = Any

KINDS = ("weights", "opt")

class RestoreError(RuntimeError):
    pass


def host_buffer_alloc(device: torch.device):
    """Allocator for object reads: pinned host memory for a CUDA target (so
    the host->device copy is a DMA), plain memory for the CPU."""
    if device.type == "cuda":
        return lambda n: torch.empty(n, dtype=torch.uint8,
                                     pin_memory=True).numpy()
    return bytearray


def plan_restore(manifests: ManifestStore, store: ChunkStore,
                 unit_names: Sequence[str], *, step: Optional[int] = None
                 ) -> Tuple[int, List[Tuple[str, str, List]]]:
    """(manifest step, [(unit, kind, [(manifest step, ref), ...])]) with
    each chain's objects present on disk, best first."""
    manifest = manifests.load(step)
    if manifest is None:
        raise RestoreError(f"no manifest found in {manifests.root}")
    older: Dict[Tuple[str, str], List[Tuple[int, ChunkRef]]] = {}
    for s in manifests.all_steps():
        if s >= manifest.step:
            continue
        m = manifests.load(s)
        for unit, kinds in (m.entries.items() if m else ()):
            for kind, ref in kinds.items():
                older.setdefault((unit, kind), []).append((s, ref))
    targets = []
    for name in unit_names:
        if name not in manifest.entries:
            raise RestoreError(f"manifest missing unit {name}")
        for kind in KINDS:
            cands = [(manifest.step, manifest.entries[name][kind])]
            cands += list(reversed(older.get((name, kind), [])))
            chain, seen = [], set()
            for s, ref in cands:
                if not ref.digest or ref.digest in seen:
                    continue
                seen.add(ref.digest)
                if store.has(ref.digest) and (not ref.delta_base
                                              or store.has(ref.delta_base)):
                    chain.append((s, ref))
            if not chain:
                raise RestoreError(f"no readable chunk for unit {name}/{kind}")
            targets.append((name, kind, chain))
    return manifest.step, targets


class RestoreEngine:
    def __init__(self, store: ChunkStore, manifests: ManifestStore,
                 registry: LayerRegistry):
        self.store = store
        self.manifests = manifests
        self.registry = registry
        self.last_stats: Dict[str, Any] = {}

    def _place(self, digest: str, state: Dict[str, PyTree], name: str,
               kind: str, alloc, timings: Dict[str, float]) -> int:
        """Read, decode, insert into the state and verify one object;
        returns the bytes copied to the device."""
        t0 = time.perf_counter()
        items, fp_blob = self.store.read_items(digest, alloc)
        t1 = time.perf_counter()
        if kind == "weights":
            dst = self.registry.extract_unit(state["params"], name)
        else:
            dst = self.registry.extract_opt_unit(state["opt"], name)
        want = {p: t for p, t in flatten_with_paths(dst)}
        if {n for n, *_ in items} != set(want):
            raise ChunkCorruption(f"object {digest} holds leaves "
                                  f"{sorted(n for n, *_ in items)}, the unit "
                                  f"wants {sorted(want)}")
        host = {}
        for path, shape, dtype, raw in items:
            t = want[path]
            if tuple(shape) != tuple(t.shape) or dtype != dtype_name(t.dtype):
                raise RestoreError(
                    f"{name}/{path}: object holds {dtype}{list(shape)}, the "
                    f"state wants {dtype_name(t.dtype)}{list(t.shape)}")
            host[path] = from_bytes(raw, shape, dtype)
        host = unflatten_from_paths(host)
        if kind == "weights":
            self.registry.insert_unit(state["params"], name, host)
        else:
            self.registry.insert_opt_unit(state["opt"], name, host)
        t2 = time.perf_counter()
        if fp_blob is not None:
            tbl = fputil.unpack_table(fp_blob)
            bb = tbl[0].block_bytes if tbl else fputil.DEFAULT_BLOCK_BYTES
            cur = bfp.tree_to_host(bfp.fingerprint_tree(dst, block_bytes=bb))
            if fputil.pack_table(cur) != fp_blob:
                raise ChunkCorruption(
                    f"fingerprint mismatch for reconstructed {digest}")
        t3 = time.perf_counter()
        timings["read_seconds"] += t1 - t0
        timings["h2d_seconds"] += t2 - t1
        timings["verify_seconds"] += t3 - t2
        return sum(t.numel() * t.element_size() for t in want.values())

    def restore(self, state_like: Dict[str, PyTree], *,
                device: torch.device,
                step: Optional[int] = None) -> Dict[str, PyTree]:
        """Rebuild a train state from the manifest chain (the implicit
        Frankenstein merge).  ``state_like`` gives the structure as
        ``TensorSpec`` trees under "params" and "opt"; the result holds
        them on ``device`` plus ``step`` (a host int32 tensor)."""
        t0 = time.perf_counter()
        m_step, targets = plan_restore(self.manifests, self.store,
                                       self.registry.unit_names(), step=step)
        state: Dict[str, PyTree] = {
            p: tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                              device=device), state_like[p])
            for p in ("params", "opt")}
        if set(state["opt"]) != set(OPT_KINDS):
            raise RestoreError("opt state must hold master, m and v")
        alloc = host_buffer_alloc(device)
        timings = {"read_seconds": 0.0, "h2d_seconds": 0.0,
                   "verify_seconds": 0.0}
        fallbacks: Dict[str, int] = {}
        sec0 = dict(self.store.seconds)
        bytes_read = 0
        h2d = 0
        for name, kind, chain in targets:
            last_exc: Optional[Exception] = None
            for cand_step, ref in chain:
                try:
                    h2d += self._place(ref.digest, state, name, kind, alloc,
                                       timings)
                except (FileNotFoundError, ChunkCorruption) as e:
                    log.warning("chunk %s/%s from manifest %s unreadable "
                                "(%s); falling back", name, kind, cand_step, e)
                    last_exc = e
                    continue
                bytes_read += self.store.object_size(ref.digest)
                if cand_step != m_step:
                    fallbacks[f"{name}/{kind}"] = cand_step
                break
            else:
                raise RestoreError(f"no readable chunk for unit "
                                   f"{name}/{kind}") from last_exc
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        state["step"] = torch.tensor(m_step, dtype=torch.int32)
        self.last_stats = {"step": m_step,
                           "seconds": time.perf_counter() - t0,
                           "targets": len(targets),
                           "bytes_read": bytes_read, "h2d_bytes": h2d,
                           "fallback_units": fallbacks, **timings,
                           # host split of read_seconds: file reads, and
                           # decoding + crc32 checks
                           "read_io_seconds": (self.store.seconds["read_io"]
                                               - sec0["read_io"]),
                           "decode_seconds": (self.store.seconds["decode"]
                                              - sec0["decode"])}
        return state
