"""Restore of the port: plan over the manifest, read, verify, copy
host->device per unit, insert.  The full train state, or only the parts
asked for: ``parts=("params",)`` is the weights-only load of a server,
which plans, and so opens, no optimizer object.

For every (unit, kind) the plan holds the manifest's entry first and then
every different object an older manifest holds for that unit, newest first
(the fallback chain).  A candidate is read into host memory (pinned when
the target is a CUDA device), decoded, crc32-checked per tensor record,
copied into the unit's slice of the state, and then verified by
fingerprinting the placed tensors on the device (the ``block_fp`` kernel)
and comparing the packed table with the one stored in the object, whose
blake2 is the object's address.  An int8 record crosses to the device as
it is stored (q and scales) and the ``dequantize`` kernel writes the
destination leaf; a lossy object is checked by its crc32s alone (its table
describes the tensors before quantization), as in the JAX package.  A
candidate that fails falls through to the next one; a unit with no good
candidate raises ``RestoreError``.
"""
from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import fingerprint as fputil
from repro_torch.checkpoint.chunk_store import ChunkRef, ChunkStore
from repro_torch.checkpoint.serial import (ChunkCorruption,
                                           flatten_with_paths)
from repro_torch.checkpoint.workers import Int8Record
from repro_torch.core.layer_registry import OPT_KINDS, LayerRegistry
from repro_torch.core.manifest import Manifest, ManifestStore
from repro_torch.dtypes import dtype_name, from_bytes
from repro_torch.kernels import block_fp as bfp
from repro_torch.kernels import quantize as qz
from repro_torch.optim.groups import tree_map

log = logging.getLogger("repro_torch.checkpoint.restore")

PyTree = Any

KINDS = ("weights", "opt")
PARTS = ("params", "opt")
_PART_KIND = {"params": "weights", "opt": "opt"}


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
                 unit_names: Sequence[str], *, step: Optional[int] = None,
                 kinds: Sequence[str] = KINDS,
                 manifest: Optional[Manifest] = None
                 ) -> Tuple[int, List[Tuple[str, str, List]]]:
    """(manifest step, [(unit, kind, [(manifest step, ref), ...])]) with
    each chain's objects present on disk, best first, for the ``kinds``
    asked for.  A caller-supplied ``manifest`` replaces the ``step``
    lookup; the older manifests of the store still give the fallbacks."""
    if manifest is None:
        manifest = manifests.load(step)
    if manifest is None:
        raise RestoreError(f"no manifest found in {manifests.root}")
    older: Dict[Tuple[str, str], List[Tuple[int, ChunkRef]]] = {}
    for s in manifests.all_steps():
        if s >= manifest.step:
            continue
        m = manifests.load(s)
        for unit, refs in (m.entries.items() if m else ()):
            for kind, ref in refs.items():
                older.setdefault((unit, kind), []).append((s, ref))
    targets = []
    for name in unit_names:
        if name not in manifest.entries:
            raise RestoreError(f"manifest missing unit {name}")
        for kind in kinds:
            if kind not in manifest.entries[name]:
                raise RestoreError(f"manifest missing {name}/{kind}")
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
        pairs = []
        for path, shape, dtype, raw in items:
            t = want[path]
            if tuple(shape) != tuple(t.shape) or dtype != dtype_name(t.dtype):
                raise RestoreError(
                    f"{name}/{path}: object holds {dtype}{list(shape)}, the "
                    f"state wants {dtype_name(t.dtype)}{list(t.shape)}")
            pairs.append((t, raw if isinstance(raw, Int8Record)
                          else from_bytes(raw, shape, dtype)))
        # ``want`` holds the unit's own tensors (views into the state)
        moved = place_leaves(pairs)
        t2 = time.perf_counter()
        if fp_blob is not None:
            verify_placed(dst, fp_blob, digest)
        t3 = time.perf_counter()
        timings["read_seconds"] += t1 - t0
        timings["h2d_seconds"] += t2 - t1
        timings["verify_seconds"] += t3 - t2
        return moved

    def restore(self, state_like: Dict[str, PyTree], *,
                device: torch.device, step: Optional[int] = None,
                parts: Sequence[str] = PARTS,
                manifest: Optional[Manifest] = None) -> Dict[str, PyTree]:
        """Rebuild a train state from the manifest chain (the implicit
        Frankenstein merge).  ``state_like`` gives the structure as
        ``TensorSpec`` trees under each of ``parts`` ("params", "opt"); the
        result holds them on ``device`` plus ``step`` (a host int32
        tensor).  ``parts=("params",)`` plans and reads only the weights
        objects; ``manifest`` replaces the ``step`` lookup."""
        t0 = time.perf_counter()
        parts = tuple(parts)
        if not parts or any(p not in PARTS for p in parts):
            raise RestoreError(f"restore parts {parts!r} must be a "
                               f"non-empty subset of {PARTS}")
        m_step, targets = plan_restore(
            self.manifests, self.store, self.registry.unit_names(),
            step=step, kinds=[_PART_KIND[p] for p in parts],
            manifest=manifest)
        state: Dict[str, PyTree] = {
            p: tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                              device=device), state_like[p])
            for p in parts}
        if "opt" in state and set(state["opt"]) != set(OPT_KINDS):
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
