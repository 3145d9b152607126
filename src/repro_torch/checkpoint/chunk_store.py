"""Content-addressed chunk store with cross-step dedup and block-sparse
deltas — the fingerprint-pipeline half of the JAX package's store.

On-disk layout (identical to the JAX package's ``local`` backend):

    root/
      objects/ab/abcdef...123.chunk   # one file per distinct content digest
      manifests/manifest-00000100.json
      LATEST

An object is a msgpack envelope.  Objects written by ``write_fp`` are
addressed by the blake2b of their fingerprint table (carried in the
envelope under ``"fp"``) and hold either a ``full`` chunk payload or a
``block_delta`` (BD02) of the dirty blocks against a full base object.
The store's codec (``none`` or ``int8``) is the envelope's ``codec``; an
int8 store's full objects hold int8 records for the leaves the saver
quantized.  Such objects are lossy: they never anchor a delta, and since
they decode to other tensors than their table describes (the table is of
the content before quantization, which is what dedup compares), a read
returns no table for them and the reader checks them by crc32 alone.
Canonically addressed objects (no table) are read with codec none only.
Lifetimes are refcounted from the committed manifests; ``gc_objects``
deletes objects no manifest references.

Writes run on the async writer's threads while the training thread makes
the next event's decisions, so ``write_fp``, ``note_dedup`` and ``has``
may be called concurrently: every shared table (stats, stage seconds,
object info, delta runs, fingerprint tables, refcounts) is updated under
one lock, and object files are published by atomic rename.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Tuple

from repro_torch.checkpoint import _msgpack, faults, workers
from repro_torch.checkpoint import fingerprint as fputil
from repro_torch.checkpoint.backends import LocalFSBackend
from repro_torch.checkpoint.serial import (ChunkCorruption,
                                           unflatten_from_paths)
from repro_torch.dtypes import from_bytes

OBJECT_VERSION = workers.OBJECT_VERSION
# Force a full rebase after this many consecutive deltas of one unit, so
# one full base never underpins a unit's whole retention window.
REBASE_EVERY = 4


def _ref_stored(fmt: str) -> str:
    return "full" if fmt == "full" else "delta"


@dataclasses.dataclass(frozen=True)
class ChunkRef:
    step: int
    unit: str
    kind: str           # "weights" | "opt"
    relpath: str
    nbytes: int         # size of the object file on disk
    digest: str = ""
    stored: str = "full"            # "full" | "delta"
    delta_base: Optional[str] = None  # digest of the full base, if delta

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "ChunkRef":
        if d.get("spec") is not None:
            raise ValueError("shard objects are not ported to repro_torch "
                             "yet")
        d = {k: v for k, v in d.items() if k != "spec"}
        return ChunkRef(**d)


class ReadSession:
    """Read-once memo over one logical read pass (a hot-swap).

    Envelopes and decoded trees are memoized per digest, so a digest two
    units share, or a full base that several block deltas patch, is read
    off the disk once.  A tree's leaves are host tensors, or the
    ``Int8Record`` of an int8-coded leaf (dequantized only where it is
    placed).  ``stats`` counts the real object I/O:
    ``object_reads`` envelope reads and ``bytes_read`` object-file bytes.
    The crc32 of every record and the table's hash to the address are
    checked on read; the fingerprint table itself is returned with the tree
    and held against the placed tensors on the device by the caller
    (``restore.verify_placed``).  A session is used by one thread.
    """

    def __init__(self, store: "ChunkStore"):
        self.store = store
        self._envelopes: Dict[str, Dict[str, Any]] = {}
        self._trees: Dict[str, Tuple[Any, Optional[bytes]]] = {}
        self.stats = {"object_reads": 0, "bytes_read": 0}

    def envelope(self, digest: str) -> Dict[str, Any]:
        env = self._envelopes.get(digest)
        if env is None:
            env = self.store.read_envelope(digest)
            self.stats["object_reads"] += 1
            self.stats["bytes_read"] += self.store.object_info(
                digest)["nbytes"]
            self._envelopes[digest] = env
        return env

    def read(self, digest: str) -> Tuple[Any, Optional[bytes]]:
        """(tree of host tensors, fingerprint table blob) of an object."""
        hit = self._trees.get(digest)
        if hit is not None:
            return hit
        items, fp_blob = self.store.read_items(digest,
                                               envelope=self.envelope)
        tree = unflatten_from_paths({
            name: (raw if isinstance(raw, workers.Int8Record)
                   else from_bytes(raw, shape, dtype))
            for name, shape, dtype, raw in items})
        self._trees[digest] = (tree, fp_blob)
        return tree, fp_blob


class ChunkStore:
    """The store under ``root`` (the ``local`` backend); ``codec`` is
    ``none``/``auto`` or ``int8`` (see ``workers.resolve_codec``)."""

    def __init__(self, root: Path | str, *, codec: str = "none"):
        self.root = Path(root)
        self.codec = workers.resolve_codec(codec)
        self.backend = LocalFSBackend(self.root / "objects")
        self._lock = threading.RLock()
        self._refcounts: Counter = Counter()
        # digest -> {"stored", "base", "codec", "nbytes"}
        self._info: Dict[str, Dict[str, Any]] = {}
        # (unit, kind) -> consecutive deltas written since the last full
        self._delta_runs: Dict[Tuple[str, str], int] = {}
        # digest -> unpacked fingerprint table
        self._fp_tables: Dict[str, list] = {}
        # Monotonic host seconds by stage (callers take differences):
        # framing + crc32 of writes, file writes, file reads, and decoding
        # + crc32 checks of reads.
        self.seconds = {"encode": 0.0, "write_io": 0.0, "read_io": 0.0,
                        "decode": 0.0}
        self.stats: Dict[str, int] = {}
        self.reset_stats()
        # Object reads that reached the backend (the JAX store's counter of
        # the same name), for the whole life of the store.
        self.backend_reads = 0

    # ---- addressing ----
    def object_relpath(self, digest: str) -> str:
        return f"objects/{digest[:2]}/{digest}.chunk"

    def object_path(self, digest: str) -> Path:
        return self.backend.path_of(digest)

    def has(self, digest: str) -> bool:
        """Store-wide probe: is an object with this digest on disk?  A
        stat of its file, safe from any thread."""
        return self.backend.has(digest)

    def iter_digests(self) -> Iterator[str]:
        return self.backend.keys()

    def object_size(self, digest: str) -> int:
        return self.backend.size(digest)

    # ---- stats ----
    def reset_stats(self) -> None:
        with self._lock:
            self.stats = {"written_bytes": 0, "logical_bytes": 0,
                          "dedup_hits": 0, "delta_chunks": 0,
                          "full_chunks": 0, "hashed_bytes": 0}

    def _bump(self, **kw: int) -> None:
        with self._lock:
            for k, v in kw.items():
                self.stats[k] += v

    def _add_seconds(self, stage: str, dt: float) -> None:
        with self._lock:
            self.seconds[stage] += dt

    def seconds_snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.seconds)

    def stats_snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.stats)

    # ---- object io ----
    def _remember(self, digest: str, env: Dict[str, Any],
                  nbytes: int) -> None:
        with self._lock:
            self._info[digest] = {"stored": env.get("format"),
                                  "base": env.get("base"),
                                  "codec": env.get("codec"),
                                  "nbytes": nbytes}

    def _read_blob(self, digest: str,
                   alloc: Optional[Callable[[int], Any]] = None
                   ) -> memoryview:
        t0 = time.perf_counter()
        blob = self.backend.read_into(digest, alloc or bytearray)
        self._add_seconds("read_io", time.perf_counter() - t0)
        with self._lock:
            self.backend_reads += 1
        return blob

    def read_envelope(self, digest: str,
                      alloc: Optional[Callable[[int], Any]] = None
                      ) -> Dict[str, Any]:
        """Parsed envelope of ``digest``; its bins are views into a buffer
        from ``alloc(nbytes)`` (a bytearray by default)."""
        blob = self._read_blob(digest, alloc)
        env = workers.parse_envelope(blob, digest)
        self._remember(digest, env, blob.nbytes)
        return env

    def object_info(self, digest: str, blob=None) -> Dict[str, Any]:
        """``{"stored", "base", "codec", "nbytes"}`` of an object: cached,
        else parsed from ``blob`` (the object's bytes, already read) or
        from a read of the object."""
        with self._lock:
            info = self._info.get(digest)
        if info is None:
            if blob is None:
                self.read_envelope(digest)
            else:
                blob = memoryview(blob).cast("B")
                self._remember(digest, workers.parse_envelope(blob, digest),
                               blob.nbytes)
            with self._lock:
                info = self._info[digest]
        return dict(info)

    # ---- blob-level copy (the merge engine) ----
    def read_object_bytes(self, digest: str) -> memoryview:
        """The raw envelope blob of ``digest``: no decode, no verify.  The
        merge moves objects between stores with this and
        ``write_object_bytes`` without materializing tensors."""
        return self._read_blob(digest)

    def write_object_bytes(self, digest: str, blob) -> int:
        """Store a pre-encoded envelope blob under its digest (atomic and
        idempotent: content addressing makes equal digests equal bytes)."""
        return self.backend.write(digest, blob)

    def _write_object(self, digest: str, env: Dict[str, Any]) -> int:
        parts = _msgpack.pack_parts(env)
        faults.crash_point("object_write")
        t0 = time.perf_counter()
        nbytes = self.backend.write(digest, parts)
        self._add_seconds("write_io", time.perf_counter() - t0)
        self._remember(digest, env, nbytes)
        return nbytes

    def _dedup_ref(self, step: int, unit: str, kind: str, digest: str, *,
                   prev_ref: Optional[ChunkRef] = None) -> ChunkRef:
        """ChunkRef for a dedup hit.  ``prev_ref`` (the unit's previous
        manifest entry) supplies stored/base/nbytes without reading the
        object's envelope."""
        if prev_ref is not None and prev_ref.digest == digest:
            info = {"stored": prev_ref.stored, "base": prev_ref.delta_base,
                    "nbytes": prev_ref.nbytes}
            with self._lock:
                self._info.setdefault(digest, dict(info))
        else:
            info = self.object_info(digest)
        self._bump(dedup_hits=1)
        return ChunkRef(step=step, unit=unit, kind=kind,
                        relpath=self.object_relpath(digest),
                        nbytes=info["nbytes"], digest=digest,
                        stored=_ref_stored(info["stored"]),
                        delta_base=info["base"])

    def note_dedup(self, step: int, unit: str, kind: str, digest: str, *,
                   prev_ref: Optional[ChunkRef] = None,
                   logical_bytes: int = 0) -> ChunkRef:
        """Account a saver-detected dedup hit (fingerprints matched on the
        device, so no payload moved or was hashed)."""
        self._bump(logical_bytes=logical_bytes)
        return self._dedup_ref(step, unit, kind, digest, prev_ref=prev_ref)

    def write_fp(self, step: int, unit: str, kind: str,
                 packet: fputil.FingerprintPacket, *,
                 prev_ref: Optional[ChunkRef] = None) -> ChunkRef:
        """Persist a unit from a fingerprint packet: a full object framed
        straight from the leaves' raw bytes, or a block-sparse delta of the
        dirty blocks.  The saver made the full-vs-delta decision."""
        digest = packet.digest
        self._bump(logical_bytes=packet.logical_bytes,
                   hashed_bytes=len(packet.table))
        if self.backend.has(digest):
            return self._dedup_ref(step, unit, kind, digest,
                                   prev_ref=prev_ref)
        t0 = time.perf_counter()
        table = fputil.unpack_table(packet.table)
        if packet.full:
            items = [(l.path, tuple(l.shape), l.dtype, self._record(l))
                     for l in packet.leaves]
            env = {"v": OBJECT_VERSION, "format": "full",
                   "codec": self.codec, "base": None,
                   "payload": workers.encode_chunk_blob(items, {}),
                   "fp": packet.table}
            self._add_seconds("encode", time.perf_counter() - t0)
            nbytes = self._write_object(digest, env)
            with self._lock:
                self._delta_runs[(unit, kind)] = 0
                self._fp_tables[digest] = table
            self._bump(written_bytes=nbytes, full_chunks=1)
            return ChunkRef(step=step, unit=unit, kind=kind,
                            relpath=self.object_relpath(digest),
                            nbytes=nbytes, digest=digest, stored="full",
                            delta_base=None)
        if not packet.base_digest:
            raise ValueError("a block delta needs a base digest")
        records = [{"name": l.path, "shape": list(l.shape), "dtype": l.dtype,
                    "nbytes": l.nbytes, "block": l.block_bytes,
                    "idx": [] if l.idx is None else list(map(int, l.idx)),
                    "data": l.data}
                   for l in packet.leaves if l.idx is None or len(l.idx)]
        env = {"v": OBJECT_VERSION, "format": "block_delta",
               "base": packet.base_digest,
               "payload": workers.block_delta_encode(records),
               "fp": packet.table}
        self._add_seconds("encode", time.perf_counter() - t0)
        nbytes = self._write_object(digest, env)
        with self._lock:
            self._delta_runs[(unit, kind)] = \
                self._delta_runs.get((unit, kind), 0) + 1
            self._fp_tables[digest] = table
        self._bump(written_bytes=nbytes, delta_chunks=1)
        return ChunkRef(step=step, unit=unit, kind=kind,
                        relpath=self.object_relpath(digest), nbytes=nbytes,
                        digest=digest, stored="delta",
                        delta_base=packet.base_digest)

    def _record(self, leaf: fputil.LeafPayload):
        """A full write's record data: the raw bytes, or an int8 record
        when the saver quantized the leaf (int8 stores only)."""
        mv = memoryview(leaf.data).cast("B")
        if leaf.quant is None:
            return mv[:leaf.nbytes]
        if self.codec != "int8":
            raise ValueError(f"leaf {leaf.path!r} arrived quantized for a "
                             f"store with codec {self.codec!r}")
        n_q, n_scale = leaf.quant
        return workers.Int8Record(mv[:n_q + 4 * n_scale], n_q, n_scale,
                                  tuple(leaf.shape), leaf.dtype)

    def load_fp_table(self, digest: str) -> Optional[list]:
        """The fingerprint table of an fp-addressed object (None for a
        missing, unreadable or canonical-digest object); cached."""
        with self._lock:
            tbl = self._fp_tables.get(digest)
        if tbl is not None:
            return tbl
        if not self.has(digest):
            return None
        try:
            env = self.read_envelope(digest)
        except ChunkCorruption:
            return None
        blob = env.get("fp")
        if blob is None:
            return None
        try:
            tbl = fputil.unpack_table(blob)
        except ValueError:
            return None
        with self._lock:
            self._fp_tables[digest] = tbl
        return tbl

    def read_items(self, digest: str,
                   alloc: Optional[Callable[[int], Any]] = None, *,
                   envelope: Optional[Callable[[str], Dict[str, Any]]] = None
                   ) -> Tuple[workers.Items, Optional[bytes]]:
        """Decoded ``(items, fp_table_blob)`` of an object, delta bases
        resolved and verified: per-record crc32, and the table must hash to
        the digest (fp objects) or the payload must (canonical objects).
        Recomputing the table from the tensors is the caller's half of the
        check: the restore does it on the device after placement.  The
        blob is None where there is no such half: canonical objects, and
        lossy (int8) full objects, whose table describes the tensors before
        quantization; their int8 records come as ``Int8Record`` items.
        ``envelope(digest)`` replaces the envelope reads (a ``ReadSession``
        routes them through its memo)."""
        if envelope is None:
            envelope = lambda d: self.read_envelope(d, alloc)  # noqa: E731
        try:
            env = envelope(digest)
            fmt = env.get("format")
            fp_blob = env.get("fp")
            if fp_blob is not None:
                fp_blob = bytes(fp_blob)
                if fputil.fp_digest(fp_blob) != digest:
                    raise ChunkCorruption(
                        f"fingerprint digest mismatch for {digest}")
                # The table hashes to the address: the next save's compare
                # needs no second read of this object.
                tbl = fputil.unpack_table(fp_blob)
                with self._lock:
                    self._fp_tables[digest] = tbl
                if fmt == "block_delta":
                    base_items, _ = self.read_items(env["base"], alloc,
                                                    envelope=envelope)
                t0 = time.perf_counter()
                if fmt == "full":
                    _, items = workers.decode_chunk_items(env["payload"])
                elif fmt == "block_delta":
                    records = workers.block_delta_decode(env["payload"])
                    items = workers.patch_items(base_items, records)
                else:
                    raise ChunkCorruption(f"unknown object format {fmt!r}")
                self._add_seconds("decode", time.perf_counter() - t0)
                if env.get("codec") in workers.LOSSY_CODECS:
                    return items, None
                return items, fp_blob
            if fmt == "full" and env.get("codec") == "none":
                payload = env["payload"]
                if workers.blake2_hex(payload) != digest:
                    raise ChunkCorruption(f"digest mismatch for {digest}")
                _, items = workers.decode_chunk_items(payload)
                return items, None
        except (ChunkCorruption, workers.CodecUnavailable):
            raise
        except (ValueError, KeyError, TypeError) as e:
            raise ChunkCorruption(f"unreadable object {digest}: {e!r}") \
                from e
        raise workers.CodecUnavailable(
            f"object {digest} ({fmt}, codec {env.get('codec')!r}) uses an "
            "encoding not ported to repro_torch yet")

    # ---- delta runs ----
    def delta_run(self, unit: str, kind: str) -> int:
        with self._lock:
            return self._delta_runs.get((unit, kind), 0)

    def seed_delta_runs(self, runs: Dict[Tuple[str, str], int]) -> None:
        with self._lock:
            self._delta_runs = dict(runs)

    # ---- refcounts / gc ----
    def set_refcounts(self, counts: Counter) -> None:
        with self._lock:
            self._refcounts = Counter(counts)

    def incref(self, digests: Iterable[str]) -> None:
        with self._lock:
            for d in digests:
                self._refcounts[d] += 1

    def decref(self, digests: Iterable[str]) -> None:
        with self._lock:
            for d in digests:
                self._refcounts[d] -= 1

    def refcount(self, digest: str) -> int:
        with self._lock:
            return self._refcounts.get(digest, 0)

    def gc_objects(self) -> int:
        """Delete objects with no remaining references (orphans included)
        and crash-leftover tmp files; returns bytes freed.  Call only after
        the current manifest is committed and increffed."""
        freed = self.backend.sweep_tmp()
        for digest in list(self.iter_digests()):
            if self.refcount(digest) > 0:
                continue
            reclaimed = self.backend.delete(digest)
            if reclaimed:
                freed += reclaimed
                with self._lock:
                    self._info.pop(digest, None)
                    self._refcounts.pop(digest, None)
                    self._fp_tables.pop(digest, None)
        return freed

    # ---- durability (one tier) ----
    def drain_spill(self) -> None:
        """Durability barrier before a manifest commit: the ``local``
        backend is the durable tier, so nothing is ever owed."""

    def durability(self) -> Dict[str, Any]:
        """What a manifest commit records under ``meta["storage"]``: the
        JAX store's answer for its ``local`` backend."""
        return {"durable_tier": "local", "pending_spill": 0,
                "durable_on": "durable", "backend": self.backend.name}

    def close(self) -> None:
        self.backend.close()
