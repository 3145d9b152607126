"""Content-addressed chunk store with cross-step dedup and delta encoding:
the JAX package's store, an addressing and codec core over a swappable
:class:`~repro_torch.checkpoint.backends.base.StorageBackend` that owns
where object bytes live (``backend=``: "local", "memory", "tiered",
"remote", "remote3", or an instance; see ``checkpoint/backends``).

On-disk layout of the ``local`` backend, and of the durable tree of the
tiered ones (identical to the JAX package's):

    root/
      objects/ab/abcdef...123.chunk   # one file per distinct content digest
      remote/ab/abcdef...123.blob     # the simulated bucket (remote tiers)
      manifests/manifest-00000100.json
      LATEST

Object reads retry transient IO errors (``READ_RETRY``, counted in
``io_retries``); a transient that outlives its retries is corruption, so
the restore takes its fallback.  ``locate`` names the tier holding an
object, and a ``ReadSession`` records the tier every read came from.  With
a ``block_cache`` every object read goes through it: ``backend_reads``
counts only the reads that reach the backend, while a session counts its
reads, bytes and tiers alike on a hit.

An object is a msgpack envelope, addressed in one of two ways that share
one digest namespace and never dedup against each other:

- ``write_fp`` (the fingerprint path): the blake2b of the unit's
  fingerprint table, carried in the envelope under ``"fp"``.  The object
  holds a ``full`` chunk payload or a ``block_delta`` (BD02) of the dirty
  blocks against a full base object.
- ``write`` (the canonical path, ``CheckpointManager(fingerprint=False)``):
  the blake2b of the unit's *canonical* payload, the codec-none chunk of
  its tensors with empty metadata.  The object holds a ``full`` payload in
  the store codec, or a ``delta``: a sparse XOR diff (XD01,
  ``workers.delta_encode``) of the canonical payload against the canonical
  payload of the unit's previous full object, written when it is smaller
  than ``DELTA_RATIO`` of a full write and fewer than ``REBASE_EVERY``
  deltas of the unit precede it.

The store's codec (``none`` or ``int8``) is the envelope's ``codec``; an
int8 store's full objects hold int8 records for the leaves the saver
quantized.  Such objects are lossy: they never anchor a delta, a read
returns their int8 records as ``Int8Record`` items, and they are checked
by crc32 alone (an fp object's table describes the tensors before
quantization; a canonical object's digest hashes them), as in the JAX
package.  Canonical bytes of an fp object (an XOR delta's base, when a
store switched paths across a restart) or of a lossy object are rebuilt
through the reader's ``materialize`` hook, which places the tensors on the
caller's device, dequantizing there, and checks an fp object's table
there (``restore.device_materializer``).  Objects the JAX package
compressed with zstd are read through the port's decoder (``_zstd``); a
zstd full object is lossless, and its canonical bytes are rebuilt on the
host.  Lifetimes are refcounted from the committed manifests;
``gc_objects`` deletes objects no manifest references.

``verify_object_blob`` checks one copy of an object (one tier's bytes)
against its digest, its table on a device; the scrub
(``checkpoint/scrub.py``) runs it over every tier and records the digests
it finds corrupt everywhere in ``QUARANTINE.json`` at the root, which the
store loads at init and the restore's planner honours (the JAX package's
file, byte for byte).

Writes run on the async writer's threads while the training thread makes
the next event's decisions, so ``write``, ``write_fp``, ``note_dedup`` and
``has`` may be called concurrently: every shared table (stats, stage
seconds, object info, delta runs, fingerprint tables, the canonical cache,
refcounts) is updated under one lock, writers of one digest dedup through
an in-flight claim instead of racing, and object files are published by
atomic rename.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Tuple

from repro_torch.checkpoint import _msgpack, faults, workers
from repro_torch.checkpoint import fingerprint as fputil
from repro_torch.checkpoint.async_io import INLINE_DISPATCH, IoDispatch
from repro_torch.checkpoint.backends import StorageBackend, make_backend
from repro_torch.checkpoint.backends.localfs import atomic_write
from repro_torch.checkpoint.backends.retry import RetryPolicy
from repro_torch.checkpoint.block_cache import BlockCache
from repro_torch.checkpoint.serial import (ChunkCorruption,
                                           unflatten_from_paths)
from repro_torch.dtypes import from_bytes

log = logging.getLogger(__name__)

OBJECT_VERSION = workers.OBJECT_VERSION
# An XOR delta must beat a full write by this factor to be stored; the
# margin rebases drifted units (their diffs grow until a full wins).
DELTA_RATIO = 0.9
# Force a full rebase after this many consecutive deltas of one unit, so
# one full base never underpins a unit's whole retention window.
REBASE_EVERY = 4
# Canonical payloads kept for the next event's XOR delta (least recently
# used first out); a larger payload is re-read when it anchors a delta.
CANON_CACHE_BYTES = 64 << 20
# Transient-IO retries of an object read, before the store declares the
# object corrupt and a restore spends a fallback.
READ_RETRY = RetryPolicy(attempts=3, base_delay=0.002, max_delay=0.05)

Materialize = Callable[[workers.Items, Optional[bytes], str], workers.Items]


def _nbytes(buf) -> int:
    """Length of a buffer or a ``Blob`` (a worker's small results come
    back as ``bytes``)."""
    return buf.nbytes if isinstance(buf, _msgpack.Blob) \
        else memoryview(buf).nbytes


def content_digest(blob) -> str:
    """blake2b-160 of a buffer or of a ``Blob``'s parts back to back."""
    return workers.blake2_hex(blob)


@contextlib.contextmanager
def _decoding(digest: str):
    """Raise an error of parsing or decoding ``digest``'s bytes as
    ``ChunkCorruption``, which the restore's fallback catches.  Only decode
    steps run under it: never a session's hook, nor the read of a base."""
    try:
        yield
    except (ValueError, KeyError, TypeError, IndexError, OverflowError) as e:
        raise ChunkCorruption(f"unreadable object {digest}: {e!r}") from e


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
    # Shard objects only: the shard spec (participant, and per leaf its
    # path, global shape, dtype and blocks; ``checkpoint/sharded.py``).
    # It lives in the manifest, not the envelope: one digest may be named
    # with different specs by different save layouts.
    spec: Optional[Dict[str, Any]] = None

    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        if d["spec"] is None:
            del d["spec"]  # global-object manifests keep their bytes
        return d

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "ChunkRef":
        return ChunkRef(**d)


class ReadSession:
    """Read-once memo over one logical read pass (a restore, a hot-swap,
    a merge's read of one object), safe for several threads.

    Envelopes, raw object blobs, canonical payloads and decoded trees are
    memoized per digest, so a digest two units share, or a full base that
    several deltas patch, is read off the disk once; threads asking for a
    digest being read wait for that one read (its failure is memoized
    too, so a corrupt object shared by several units fails them all from
    one read).  ``release(digest)`` drops every representation once no
    reader needs it.  A tree's leaves are host tensors, or the
    ``Int8Record`` of an int8-coded leaf (dequantized only where it is
    placed).  ``stats`` counts the real object I/O: ``object_reads``
    envelope or blob reads and ``bytes_read`` object-file bytes; ``tiers``
    maps each digest read to the tier it was served from and
    ``tier_reads`` counts the reads per tier.  Envelopes are read into
    buffers from ``alloc(nbytes)`` (a bytearray by default), and so are a
    worker's decoded records on the process backend.

    With ``verify`` (the default) the crc32 of every record and the
    table's or payload's hash to the address are checked on read; an fp
    object's table itself is returned with the tree and held against the
    placed tensors on the device by the caller (``restore.verify_placed``),
    except where its canonical bytes are needed, which ``materialize``
    checks (see the module doc).  ``verify=False`` checks none of them and
    returns no table.  An object whose chain of bases leads back to itself
    raises ``ChunkCorruption``: a thread's own nesting is caught by
    ``guard`` (per thread), a wait that would close a loop of threads
    waiting on each other's reads by the memo.

    The offload reads (``object_blob``, ``read_offload``,
    ``canonical_offload``) are the process backend's: the raw blob is read
    here (tier provenance, retries and faults stay in this process) and
    its decode and host checks run in a worker (``workers.decode_object``,
    ``canonical_object``) on lane ``"restore"``; a delta's base goes with
    it (a block delta's base envelope, an XOR delta's base canonical
    payload).  They share the ``canon`` and ``tree`` memos with the inline
    reads."""

    def __init__(self, store: "ChunkStore", *,
                 alloc: Optional[Callable[[int], Any]] = None,
                 materialize: Optional[Materialize] = None,
                 verify: bool = True):
        self.store = store
        self.alloc = alloc
        self.materialize = materialize
        self.verify = verify
        self._lock = threading.Lock()
        # (memo, digest) -> {"event", "value", "error", "owner"}
        self._cells: Dict[Tuple[str, str], Dict[str, Any]] = {}
        # thread -> the cell it waits on (the cycle check's edges)
        self._waiting: Dict[int, Dict[str, Any]] = {}
        self._local = threading.local()
        self.stats = {"object_reads": 0, "bytes_read": 0}
        self.tiers: Dict[str, str] = {}
        self.tier_reads: Dict[str, int] = {}

    @contextlib.contextmanager
    def guard(self, what: str, digest: str):
        """Raise ``ChunkCorruption`` if ``(what, digest)`` is already being
        resolved further up this thread's stack (a base cycle)."""
        busy = getattr(self._local, "busy", None)
        if busy is None:
            busy = self._local.busy = set()
        key = (what, digest)
        if key in busy:
            raise ChunkCorruption(f"object dependency cycle at {digest}")
        busy.add(key)
        try:
            yield
        finally:
            busy.discard(key)

    def _memoized(self, memo: str, digest: str, fn: Callable[[], Any]):
        key = (memo, digest)
        me = threading.get_ident()
        while True:
            with self._lock:
                cell = self._cells.get(key)
                owner = cell is None
                if owner:
                    cell = self._cells[key] = {
                        "event": threading.Event(), "value": None,
                        "error": None, "owner": me}
                elif not cell["event"].is_set():
                    # waiting would close a loop of threads each waiting
                    # on a read another one runs: a base cycle
                    t, seen = cell["owner"], set()
                    while t not in seen:
                        if t == me:
                            raise ChunkCorruption(
                                f"object dependency cycle at {digest}")
                        seen.add(t)
                        nxt = self._waiting.get(t)
                        if nxt is None or nxt["event"].is_set():
                            break
                        t = nxt["owner"]
                    self._waiting[me] = cell
            if not owner:
                cell["event"].wait()
                with self._lock:
                    self._waiting.pop(me, None)
                    if self._cells.get(key) is not cell:
                        continue        # released meanwhile: read again
                if cell["error"] is not None:
                    raise cell["error"]
                return cell["value"]
            try:
                cell["value"] = fn()
            except BaseException as e:  # noqa: BLE001 - memoize failures too
                cell["error"] = e
                raise
            finally:
                cell["event"].set()
            return cell["value"]

    def seed_envelope(self, digest: str, env: Dict[str, Any]) -> None:
        """Serve ``env`` as ``digest``'s envelope in this session: a copy
        the caller read itself stands in for the store's."""
        cell = {"event": threading.Event(), "value": env, "error": None,
                "owner": threading.get_ident()}
        cell["event"].set()
        with self._lock:
            self._cells[("env", digest)] = cell

    def _count_read(self, digest: str, tier: Optional[str],
                    nbytes: int) -> None:
        with self._lock:
            self.stats["object_reads"] += 1
            self.stats["bytes_read"] += int(nbytes)
            if tier is not None:
                self.tiers[digest] = tier
                self.tier_reads[tier] = self.tier_reads.get(tier, 0) + 1

    def envelope(self, digest: str) -> Dict[str, Any]:
        def read():
            # before the read: a tiered backend promotes what it reads
            tier = self.store.locate(digest)
            env = self.store.read_envelope(digest, self.alloc)
            self._count_read(digest, tier,
                             self.store.object_info(digest)["nbytes"])
            return env

        return self._memoized("env", digest, read)

    def canonical(self, digest: str):
        """The canonical payload of ``digest`` (``read_canonical``)."""
        return self._memoized(
            "canon", digest,
            lambda: self.store.read_canonical(digest, session=self))

    def read(self, digest: str) -> Tuple[Any, Optional[bytes]]:
        """(tree of host tensors, fingerprint table blob) of an object."""
        def build():
            items, fp_blob = self.store.read_items(digest, session=self)
            return _tree_of(items), fp_blob

        return self._memoized("tree", digest, build)

    # ---- the process backend's reads ----
    def object_blob(self, digest: str) -> memoryview:
        """The raw envelope bytes of ``digest``, read once, with the read
        accounting of ``envelope``."""
        def read():
            tier = self.store.locate(digest)
            # into shared memory on the process backend: the worker that
            # decodes it maps the bytes, and its decoded records come back
            # as views of them
            blob = self.store._read_blob(digest,
                                         self.store.dispatch.buffer_alloc())
            self._count_read(digest, tier, blob.nbytes)
            return blob

        return self._memoized("blob", digest, read)

    def _offload_base(self, digest: str, env: Dict[str, Any]):
        """What a worker needs of a delta's base: a block delta's base
        envelope, an XOR delta's base canonical payload (None for a full
        object)."""
        with _decoding(digest):
            fmt = env.get("format")
            base = env.get("base")
        if fmt == "block_delta":
            return self.object_blob(base)
        if fmt == "delta":
            return self.canonical_offload(base)
        return None

    def _decode_offload(self, digest: str
                        ) -> Tuple[workers.Items, Optional[bytes]]:
        blob = self.object_blob(digest)
        with _decoding(digest):
            env = workers.parse_envelope(blob, digest)
        base = self._offload_base(digest, env)
        t0 = time.perf_counter()
        items, fp_blob = self.store.dispatch.call(
            "decode_object", blob, digest, base, self.verify,
            lane="restore", alloc=self.alloc)
        self.store._add_seconds("decode", time.perf_counter() - t0)
        if fp_blob is not None:
            with _decoding(digest):
                tbl = fputil.unpack_table(fp_blob)
            with self.store._lock:
                self.store._fp_tables[digest] = tbl
        return items, fp_blob

    def read_offload(self, digest: str) -> Tuple[Any, Optional[bytes]]:
        """``read`` with the decode and host checks in a worker."""
        def build():
            items, fp_blob = self._decode_offload(digest)
            return _tree_of(items), fp_blob

        return self._memoized("tree", digest, build)

    def canonical_offload(self, digest: str):
        """``canonical`` with the rebuild and digest check in a worker; an
        fp or lossy object is decoded there, placed and checked through
        ``materialize`` here, and framed in a worker."""
        def build():
            cached = self.store._canon_cached(digest)
            if cached is not None:
                return cached
            blob = self.object_blob(digest)
            with _decoding(digest):
                env = workers.parse_envelope(blob, digest)
                fp = env.get("fp") is not None
                lossy = (env.get("format") == "full"
                         and env.get("codec") in workers.LOSSY_CODECS)
            dispatch = self.store.dispatch
            if fp or lossy:
                items, fp_blob = self._decode_offload(digest)
                if self.materialize is None:
                    raise RuntimeError(f"the canonical bytes of {digest} "
                                       "are rebuilt on a device: pass "
                                       "materialize")
                items = self.materialize(items, fp_blob, digest)
                canon = dispatch.call("encode_chunk", items, {},
                                      lane="restore")
                if (not fp and self.verify
                        and content_digest(canon) != digest):
                    raise ChunkCorruption(f"digest mismatch for {digest}")
            else:
                base = self._offload_base(digest, env)
                t0 = time.perf_counter()
                canon = dispatch.call("canonical_object", blob, digest, base,
                                      self.verify, lane="restore")
                self.store._add_seconds("decode", time.perf_counter() - t0)
            self.store._canon_remember(digest, canon)
            return canon

        return self._memoized("canon", digest, build)

    def release(self, digest: str) -> None:
        """Drop every memoized representation of ``digest`` (no reader
        needs it any more)."""
        with self._lock:
            for memo in ("env", "blob", "canon", "tree"):
                self._cells.pop((memo, digest), None)


# Codecs of full fp-addressed objects whose tensors are what their table
# describes: a lossy full object decodes to other tensors, and its record
# crc32s are its check.
_TABLE_CHECKED_FULL_CODECS = ("none", "zstd")


def table_checked(env: Dict[str, Any]) -> bool:
    """Whether verifying an object recomputes its fingerprint table (the
    JAX package's rule, ``repro/checkpoint/chunk_store.py:676-680``): every
    fp-addressed object but a full one of a lossy codec."""
    return env.get("fp") is not None and (
        env.get("format") != "full"
        or env.get("codec") in _TABLE_CHECKED_FULL_CODECS)


def _tree_of(items: workers.Items) -> Any:
    return unflatten_from_paths({
        name: (raw if isinstance(raw, workers.Int8Record)
               else from_bytes(raw, shape, dtype))
        for name, shape, dtype, raw in items})


class ChunkStore:
    """The store under ``root``; ``codec`` is ``none``/``auto`` or ``int8``
    (see ``workers.resolve_codec``).  ``backend``, ``spill_threads``,
    ``hot_budget_bytes`` and ``remote_opts`` go to
    ``backends.make_backend`` (with ``dispatch``); ``read_retry`` replaces
    ``READ_RETRY``; ``dispatch`` is an ``async_io.IoDispatch`` (inline by
    default); ``block_cache`` is a ``BlockCache`` every object read goes
    through (the store never closes it: it may be shared across stores)."""

    def __init__(self, root: Path | str, *, codec: str = "none",
                 backend: "str | StorageBackend" = "local",
                 spill_threads: int = 2,
                 hot_budget_bytes: Optional[int] = None,
                 read_retry: Optional[RetryPolicy] = None,
                 remote_opts: Optional[Dict[str, Any]] = None,
                 dispatch: Optional[IoDispatch] = None,
                 block_cache: Optional[BlockCache] = None):
        self.root = Path(root)
        self.codec = workers.resolve_codec(codec)
        # Where the hot byte work of writes (framing with its crc32s, the
        # XD01 and BD02 encodes) and of offloaded reads runs: inline, or in
        # a process-backed pool's workers (the same ``workers`` code, the
        # same bytes).
        self.dispatch = dispatch if dispatch is not None else INLINE_DISPATCH
        self.backend = make_backend(backend, self.root,
                                    spill_threads=spill_threads,
                                    hot_budget_bytes=hot_budget_bytes,
                                    remote_opts=remote_opts,
                                    dispatch=self.dispatch)
        self.read_retry = read_retry if read_retry is not None \
            else READ_RETRY
        # Process-lifetime digest -> bytes cache under every object read:
        # K variants or hot-swaps read each shared object off the backend
        # once (see checkpoint/block_cache.py).
        self.block_cache = block_cache
        self._lock = threading.RLock()
        # digest -> Event of a write in flight: writer threads persisting
        # one digest dedup instead of racing
        self._inflight: Dict[str, threading.Event] = {}
        # digest -> canonical payload (LRU, at most CANON_CACHE_BYTES)
        self._canon_cache: Dict[str, bytes] = {}
        self._canon_cache_bytes = 0
        self._refcounts: Counter = Counter()
        # digest -> {"stored", "base", "codec", "nbytes"}
        self._info: Dict[str, Dict[str, Any]] = {}
        # (unit, kind) -> consecutive deltas written since the last full
        self._delta_runs: Dict[Tuple[str, str], int] = {}
        # digest -> unpacked fingerprint table
        self._fp_tables: Dict[str, list] = {}
        # Monotonic host seconds by stage (callers take differences):
        # framing + crc32 of writes, file writes, file reads, decoding +
        # crc32 checks of reads, and the block cache's copies (into the
        # cache on a miss, out of it on a hit) and coalesced waits.
        self.seconds = {"encode": 0.0, "write_io": 0.0, "read_io": 0.0,
                        "decode": 0.0, "cache_copy": 0.0}
        self.stats: Dict[str, int] = {}
        self.reset_stats()
        # Object reads that reached the backend (the JAX store's counter of
        # the same name; block cache hits excluded), for the whole life of
        # the store.
        self.backend_reads = 0
        # Transient read errors a retry absorbed, for the life of the store
        # (a restore reports its own share as ``io_retries``).
        self.io_retries = 0
        # Digests a scrub found corrupt in every tier (``QUARANTINE.json``):
        # the restore's planner skips them; a later scrub that finds a good
        # copy releases them.
        self._quarantine: Dict[str, Dict[str, Any]] = \
            self._load_quarantine()

    # ---- addressing ----
    def object_relpath(self, digest: str) -> str:
        return f"objects/{digest[:2]}/{digest}.chunk"

    def object_path(self, digest: str) -> Path:
        """File of ``digest`` where a tier keeps paths (tests and offline
        tools poke objects there)."""
        p = self.backend.path_of(digest)
        if p is None:
            raise NotImplementedError(
                f"backend {self.backend.name!r} has no filesystem paths")
        return p

    def has(self, digest: str) -> bool:
        """Store-wide probe: does any tier hold this digest?  Safe from any
        thread."""
        return self.backend.has(digest)

    def locate(self, digest: str) -> Optional[str]:
        """The fastest tier holding ``digest`` ("hot", "durable", "remote",
        "local", "memory"; None if absent)."""
        return self.backend.locate(digest)

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

    # ---- canonical-payload LRU cache (the XOR delta's bases) ----
    def _canon_cached(self, digest: str):
        with self._lock:
            canon = self._canon_cache.pop(digest, None)
            if canon is not None:
                self._canon_cache[digest] = canon  # most recently used
            return canon

    def _canon_remember(self, digest: str, canon) -> None:
        nbytes = (canon.nbytes if isinstance(canon, _msgpack.Blob)
                  else memoryview(canon).nbytes)
        if nbytes > CANON_CACHE_BYTES:
            return
        with self._lock:
            if digest in self._canon_cache:
                return
        # a copy: ``canon`` may view a staging or read buffer
        canon = (b"".join(canon.parts) if isinstance(canon, _msgpack.Blob)
                 else bytes(canon))
        with self._lock:
            if digest in self._canon_cache:
                return
            while (self._canon_cache_bytes + nbytes > CANON_CACHE_BYTES
                   and self._canon_cache):
                lru = next(iter(self._canon_cache))
                self._canon_cache_bytes -= len(self._canon_cache.pop(lru))
            self._canon_cache[digest] = canon
            self._canon_cache_bytes += nbytes

    # ---- quarantine (see checkpoint/scrub.py) ----
    @property
    def quarantine_path(self) -> Path:
        return self.root / "QUARANTINE.json"

    def _load_quarantine(self) -> Dict[str, Dict[str, Any]]:
        try:
            return dict(json.loads(self.quarantine_path.read_bytes()))
        except FileNotFoundError:
            return {}
        except Exception:  # noqa: BLE001 - a mangled file reads as empty;
            return {}      # the next scrub rewrites it

    def quarantined(self, digest: str) -> bool:
        with self._lock:
            return digest in self._quarantine

    def quarantine(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {d: dict(v) for d, v in self._quarantine.items()}

    def set_quarantine(self, entries: Dict[str, Dict[str, Any]]) -> None:
        """Replace the quarantine (the scrub's call): written atomically
        with the JAX package's bytes, removed when empty."""
        with self._lock:
            self._quarantine = {d: dict(v) for d, v in entries.items()}
        if entries:
            atomic_write(self.quarantine_path,
                         json.dumps(entries, indent=2).encode())
        else:
            try:
                self.quarantine_path.unlink()
            except FileNotFoundError:
                pass

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
        """The object's bytes in a buffer from ``alloc(nbytes)`` (a
        bytearray by default): through the block cache when one is
        attached (a hit copies the cached bytes into the caller's buffer),
        else off the backend (``_backend_read``)."""
        cache = self.block_cache
        if cache is None:
            return self._backend_read(digest, alloc)
        t0 = time.perf_counter()
        loading = []

        def load():
            t = time.perf_counter()
            try:
                return self._backend_read(digest, alloc)
            finally:
                loading.append(time.perf_counter() - t)

        try:
            return cache.get(digest, load, alloc)
        finally:
            self._add_seconds("cache_copy",
                              time.perf_counter() - t0 - sum(loading))

    def _backend_read(self, digest: str,
                      alloc: Optional[Callable[[int], Any]] = None
                      ) -> memoryview:
        """A read off the backend, transient IO errors retried: an absent
        object raises ``FileNotFoundError``, one still failing after
        ``read_retry`` raises ``ChunkCorruption``."""
        def on_retry(attempt: int, exc: BaseException) -> None:
            with self._lock:
                self.io_retries += 1

        t0 = time.perf_counter()
        with self._lock:
            self.backend_reads += 1
        try:
            blob = self.read_retry.run(
                lambda: self.backend.read_into(digest, alloc or bytearray),
                key=digest, on_retry=on_retry)
        except FileNotFoundError:
            raise
        except OSError as e:
            raise ChunkCorruption(
                f"object {digest} unreadable after "
                f"{self.read_retry.attempts} attempts: {e!r}") from e
        finally:
            self._add_seconds("read_io", time.perf_counter() - t0)
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
    def read_object_bytes(self, digest: str,
                          alloc: Optional[Callable[[int], Any]] = None
                          ) -> memoryview:
        """The raw envelope blob of ``digest`` (in a buffer from
        ``alloc(nbytes)``): no decode, no verify.  The merge moves objects
        between stores with this and ``write_object_bytes`` without
        materializing tensors."""
        return self._read_blob(digest, alloc)

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

    def _claim(self, digest: str) -> Optional[threading.Event]:
        """Claim the right to write ``digest``, or None when the object
        exists (a dedup hit).  A writer of a digest already in flight waits
        for it and then sees it on disk; the existence check and the claim
        are made under one lock."""
        while True:
            with self._lock:
                other = self._inflight.get(digest)
                if other is None:
                    if self.backend.has(digest):
                        return None
                    claim = self._inflight[digest] = threading.Event()
                    return claim
            other.wait()

    def _release(self, digest: str, claim: threading.Event) -> None:
        with self._lock:
            self._inflight.pop(digest, None)
        claim.set()

    def write(self, step: int, unit: str, kind: str, items: workers.Items,
              *, full_items: Optional[workers.Items] = None,
              prev_ref: Optional[ChunkRef] = None,
              materialize: Optional[Materialize] = None) -> ChunkRef:
        """Persist a unit on the canonical path: dedup by content, XOR delta
        when smaller (the JAX store's ``write``).

        ``items`` are the unit's leaves as raw little-endian bytes in
        flatten order: their codec-none chunk is the canonical payload,
        hashed from its framing parts (never joined) and, with codec
        ``none``, written as the full payload.  ``full_items`` are the
        records of an ``int8`` store's full object (``Int8Record`` for the
        quantized leaves), required there.  ``prev_ref`` is the unit's
        previous manifest entry: its object (or, for a delta, its full
        base) is the delta base, and an unchanged unit's dedup hit reads no
        envelope.  ``materialize`` rebuilds an fp or lossy base's canonical
        bytes (see the module doc)."""
        if self.codec != "none" and full_items is None:
            raise ValueError(f"a {self.codec} store writes the unit's "
                             "records: pass full_items")
        t0 = time.perf_counter()
        canon = workers.encode_chunk_blob(items, {})
        digest = content_digest(canon)
        self._add_seconds("encode", time.perf_counter() - t0)
        self._bump(logical_bytes=canon.nbytes, hashed_bytes=canon.nbytes)
        claim = self._claim(digest)
        if claim is None:
            # the content is stored (this event or an earlier one)
            self._canon_remember(digest, canon)
            return self._dedup_ref(step, unit, kind, digest,
                                   prev_ref=prev_ref)
        try:
            return self._write_new(
                step, unit, kind, canon, digest,
                full_items if self.codec != "none" else None,
                prev_ref.digest if prev_ref is not None else None,
                materialize)
        finally:
            self._release(digest, claim)

    def _write_new(self, step: int, unit: str, kind: str, canon, digest: str,
                   full_items: Optional[workers.Items],
                   delta_base: Optional[str],
                   materialize: Optional[Materialize]) -> ChunkRef:
        t0 = time.perf_counter()
        full_payload = (canon if full_items is None
                        else self.dispatch.call("encode_chunk", full_items,
                                                {}))
        self._add_seconds("encode", time.perf_counter() - t0)
        # An XOR delta against the previous entry's full base.  Never for a
        # lossy codec (a delta restores exact canonical bytes), and never
        # past the rebase bound.
        with self._lock:
            run = self._delta_runs.get((unit, kind), 0)
        if (delta_base and run < REBASE_EVERY
                and self.codec not in workers.LOSSY_CODECS):
            try:
                base_digest = delta_base
                info = self.object_info(base_digest)
                if info["stored"] != "full" and info["base"]:
                    base_digest = info["base"]  # delta or block_delta
                base_canon = self.read_canonical(
                    base_digest,
                    session=ReadSession(self, materialize=materialize))
            except (FileNotFoundError, ChunkCorruption,
                    workers.CodecUnavailable) as e:
                # an unreadable base (missing, corrupt, or in a codec the
                # port lacks): write full
                log.warning("%s/%s: delta base %s unreadable (%s); writing "
                            "a full object", unit, kind, delta_base, e)
                base_canon = None
            if base_canon is not None:
                t1 = time.perf_counter()
                limit = DELTA_RATIO * _nbytes(full_payload)
                dblob = self.dispatch.call("delta_encode", canon,
                                           base_canon, limit)
                self._add_seconds("encode", time.perf_counter() - t1)
                if dblob is not None and _nbytes(dblob) < limit:
                    nbytes = self._write_object(digest, {
                        "v": OBJECT_VERSION, "format": "delta",
                        "base": base_digest, "payload": dblob})
                    self._canon_remember(digest, canon)
                    with self._lock:
                        self._delta_runs[(unit, kind)] = run + 1
                    self._bump(written_bytes=nbytes, delta_chunks=1)
                    return ChunkRef(step=step, unit=unit, kind=kind,
                                    relpath=self.object_relpath(digest),
                                    nbytes=nbytes, digest=digest,
                                    stored="delta", delta_base=base_digest)
        nbytes = self._write_object(digest, {
            "v": OBJECT_VERSION, "format": "full", "codec": self.codec,
            "base": None, "payload": full_payload})
        self._canon_remember(digest, canon)
        with self._lock:
            self._delta_runs[(unit, kind)] = 0
        self._bump(written_bytes=nbytes, full_chunks=1)
        return ChunkRef(step=step, unit=unit, kind=kind,
                        relpath=self.object_relpath(digest), nbytes=nbytes,
                        digest=digest, stored="full", delta_base=None)

    def write_fp(self, step: int, unit: str, kind: str,
                 packet: fputil.FingerprintPacket, *,
                 prev_ref: Optional[ChunkRef] = None) -> ChunkRef:
        """Persist a unit from a fingerprint packet: a full object framed
        straight from the leaves' raw bytes, or a block-sparse delta of the
        dirty blocks.  The saver made the full-vs-delta decision."""
        digest = packet.digest
        self._bump(logical_bytes=packet.logical_bytes,
                   hashed_bytes=len(packet.table))
        claim = self._claim(digest)
        if claim is None:
            return self._dedup_ref(step, unit, kind, digest,
                                   prev_ref=prev_ref)
        try:
            return self._write_fp_new(step, unit, kind, packet)
        finally:
            self._release(digest, claim)

    def _write_fp_new(self, step: int, unit: str, kind: str,
                      packet: fputil.FingerprintPacket) -> ChunkRef:
        digest = packet.digest
        t0 = time.perf_counter()
        table = fputil.unpack_table(packet.table)
        if packet.full:
            items = [(l.path, tuple(l.shape), l.dtype, self._record(l))
                     for l in packet.leaves]
            env = {"v": OBJECT_VERSION, "format": "full",
                   "codec": self.codec, "base": None,
                   "payload": self.dispatch.call("encode_chunk", items, {}),
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
               "payload": self.dispatch.call("block_delta_encode",
                                             records),
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

    def read_items(self, digest: str, *,
                   session: Optional[ReadSession] = None
                   ) -> Tuple[workers.Items, Optional[bytes]]:
        """Decoded ``(items, fp_table_blob)`` of an object, delta bases
        resolved and verified: per-record crc32, and the table must hash to
        the digest (fp objects) or the canonical payload must (canonical
        objects: a full one of codec none, and an XOR delta's
        reconstruction).  Recomputing the table from the tensors is the
        caller's half of the check: the restore does it on the device after
        placement.  The blob is None where there is no such half: canonical
        objects, and lossy (int8) full objects, whose table describes the
        tensors before quantization; int8 records come as ``Int8Record``
        items, and a lossy canonical object is checked by crc32 alone, as
        the JAX package's ``read_digest`` checks it.  ``session`` (by
        default a new one, with no ``materialize``) memoizes the envelopes
        and canonical bases read; a session with ``verify=False`` checks
        none of this and returns no blob.  Bytes that do not decode raise
        ``ChunkCorruption``; an error of the session's hooks passes as it
        is."""
        s = session if session is not None else ReadSession(self)
        with s.guard("items", digest):
            return self._read_items(digest, s)

    def _read_items(self, digest: str, s: ReadSession
                    ) -> Tuple[workers.Items, Optional[bytes]]:
        with _decoding(digest):
            env = s.envelope(digest)
            fmt = env.get("format")
            fp_blob = env.get("fp")
        if fp_blob is not None:
            with _decoding(digest):
                fp_blob = bytes(fp_blob)
                if s.verify and fputil.fp_digest(fp_blob) != digest:
                    raise ChunkCorruption(
                        f"fingerprint digest mismatch for {digest}")
                tbl = fputil.unpack_table(fp_blob) if s.verify else None
                base = env["base"] if fmt == "block_delta" else None
            if tbl is not None:
                # The table hashes to the address: the next save's compare
                # needs no second read of this object.
                with self._lock:
                    self._fp_tables[digest] = tbl
            if base is not None:
                base_items, _ = self.read_items(base, session=s)
            t0 = time.perf_counter()
            with _decoding(digest):
                if fmt == "full":
                    _, items = workers.decode_chunk_items(env["payload"],
                                                          s.verify)
                elif fmt == "block_delta":
                    records = workers.block_delta_decode(env["payload"])
                    items = workers.patch_items(base_items, records)
                else:
                    raise ChunkCorruption(f"unknown object format {fmt!r}")
            self._add_seconds("decode", time.perf_counter() - t0)
            if env.get("codec") in workers.LOSSY_CODECS or not s.verify:
                return items, None
            return items, fp_blob
        if fmt == "full":
            with _decoding(digest):
                payload = env["payload"]
                if (s.verify and env.get("codec") == "none"
                        and content_digest(payload) != digest):
                    raise ChunkCorruption(f"digest mismatch for {digest}")
        elif fmt == "delta":
            payload = s.canonical(digest)
        else:
            raise ChunkCorruption(f"unknown object format {fmt!r}")
        t0 = time.perf_counter()
        with _decoding(digest):
            _, items = workers.decode_chunk_items(payload, s.verify)
        self._add_seconds("decode", time.perf_counter() - t0)
        return items, None

    def read_canonical(self, digest: str, *,
                       session: Optional[ReadSession] = None):
        """The canonical payload of ``digest`` (the codec-none chunk of its
        tensors, a buffer or a ``Blob``), deltas resolved, checked against
        the digest (a canonical object) or by its table on the device (an
        fp object, through the session's ``materialize``).  A lossy
        canonical object decodes to other tensors than it was addressed
        by, so it raises "digest mismatch", as in the JAX package (a lossy
        object never anchors a delta).  Errors as in ``read_items``."""
        cached = self._canon_cached(digest)
        if cached is not None:
            return cached
        s = session if session is not None else ReadSession(self)
        with s.guard("canon", digest):
            canon = self._canonical(digest, s)
        self._canon_remember(digest, canon)
        return canon

    def _canonical(self, digest: str, s: ReadSession):
        with _decoding(digest):
            env = s.envelope(digest)
            fmt = env.get("format")
            fp = env.get("fp") is not None
        if fp or (fmt == "full"
                   and env.get("codec") in workers.LOSSY_CODECS):
            # decode (and, for an fp object, resolve its block delta),
            # place on the device, check the table there, re-frame
            items, fp_blob = self.read_items(digest, session=s)
            if s.materialize is None:
                raise RuntimeError(f"the canonical bytes of {digest} ({fmt}, "
                                   f"codec {env.get('codec')!r}) are rebuilt "
                                   "on a device: pass materialize")
            items = s.materialize(items, fp_blob, digest)
            canon = workers.encode_chunk_blob(items, {})
        elif fmt == "full":
            with _decoding(digest):
                canon = workers.canonical_payload(env, s.verify)
        elif fmt == "delta":
            with _decoding(digest):
                base_digest = env["base"]
            base = s.canonical(base_digest)
            t0 = time.perf_counter()
            with _decoding(digest):
                canon = workers.delta_decode(env["payload"], base)
            self._add_seconds("decode", time.perf_counter() - t0)
        else:
            raise ChunkCorruption(f"unknown object format {fmt!r}")
        if not fp and s.verify and content_digest(canon) != digest:
            raise ChunkCorruption(f"digest mismatch for {digest}")
        return canon

    def verify_object_blob(self, digest: str, blob,
                           device=None) -> Dict[str, Any]:
        """Check one copy of an object, ``blob`` (one tier's bytes, not
        the store's), against ``digest`` and return its envelope: the JAX
        store's ``verify_object_blob``.  A canonical object's payload is
        rebuilt (an XOR delta on its base, a zstd object decoded) and
        hashed to the address, a lossy one's records checked by crc32; an
        fp object's records are checked by crc32 and its table hashed to
        the address, then, where :func:`table_checked`, its tensors placed
        on ``device`` and fingerprinted there (``restore.verify_placed``:
        the ``block_fp`` kernel on the card, its plain version on the CPU;
        ``devices.resolve_device``).  Delta bases are read through the
        store.  Nothing is remembered of this copy but a table that hashed
        to its address, so probing a corrupt tier poisons no cache.
        Raises ``ChunkCorruption`` (a base no tier holds included), or
        ``CodecUnavailable`` for a zstd frame that needs a dictionary."""
        # restore imports this module; the device half lives there
        from repro_torch.checkpoint import restore
        from repro_torch.devices import resolve_device
        dev = resolve_device(device)
        with _decoding(digest):
            env = workers.parse_envelope(memoryview(blob).cast("B"), digest)
            lossy = (env.get("format") == "full"
                     and env.get("codec") in workers.LOSSY_CODECS)
        s = ReadSession(self, alloc=restore.host_buffer_alloc(dev),
                        materialize=restore.device_materializer(dev))
        s.seed_envelope(digest, env)
        try:
            if env.get("fp") is None and not lossy:
                with s.guard("canon", digest):
                    self._canonical(digest, s)
                return env
            items, _ = self.read_items(digest, session=s)
        except FileNotFoundError as e:
            raise ChunkCorruption(f"object {digest} replays a base no tier "
                                  f"holds: {e}") from e
        if table_checked(env):
            leaves = restore.place_items(items, dev)
            with _decoding(digest):
                fp_blob = bytes(env["fp"])
            restore.verify_placed(unflatten_from_paths(leaves), fp_blob,
                                  digest)
        return env

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
        and crash-leftover tmp files, dropping each deleted digest from the
        block cache; returns bytes freed.  Call only after the current
        manifest is committed and increffed."""
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
                    old = self._canon_cache.pop(digest, None)
                    if old is not None:
                        self._canon_cache_bytes -= len(old)
                if self.block_cache is not None:
                    self.block_cache.discard(digest)
        return freed

    # ---- tiers ----
    def drain_spill(self) -> None:
        """Durability barrier: returns once every object written so far is
        on the backend's durable tier (nothing to wait for on one tier)."""
        self.backend.drain()

    def pending_spill(self) -> int:
        return self.backend.pending_spill()

    def tier_stats(self) -> Dict[str, Any]:
        return self.backend.tier_stats()

    def durability(self) -> Dict[str, Any]:
        """What a manifest commit records under ``meta["storage"]``: the
        backend's name, the deepest level every object has reached
        (``durable_on``) and, for a composition with a best-effort tier,
        whether the commit is degraded."""
        d = dict(self.backend.durability())
        d["backend"] = self.backend.name
        return d

    def close(self) -> None:
        self.backend.close()
