"""Digest-keyed host-RAM object cache for multi-variant serving: the JAX
package's ``BlockCache`` under the port's store.

The cache sits underneath ``ChunkStore._read_blob`` for as long as the
process serves, so K tailored variants (or K successive hot-swaps)
materialized from one store read each shared digest off the backend once.
Content addressing makes this safe: the bytes behind a digest never
change, so nothing is invalidated; the one lifecycle event is GC deleting
an unreferenced object, for which the store calls :meth:`discard`.

Semantics (the JAX cache's):

- **LRU under a byte budget**, refreshed on hit; an entry larger than the
  whole budget bypasses the cache (``stats["bypassed"]``) instead of
  wiping everything else out.
- **In-flight coalescing**: concurrent ``get``\\ s of one digest run the
  loader once and the others wait for it (``stats["coalesced"]``).  A
  loader *failure* is not memoized: every later ``get`` retries.
- **Optional /dev/shm backing** (``shm=True``): entries live in tmpfs
  segments under the repo-wide owner prefix ``repro-io-<pid:x>-cache-``,
  so the shared-memory leak guards and ``async_io.sweep_dead_owner_shm``
  cover them like the worker arena's; ``close()`` unlinks them.

What differs from the JAX cache is the buffer a caller gets.  The port
reads an object into the caller's own buffer (``alloc(n)``: pinned host
memory for a restore onto the card, a shared-memory lease on the process
backend, a bytearray otherwise), and a decode may later write into it.  So
an entry never aliases a caller's buffer: a miss returns the loader's
buffer and keeps a private, read-only copy of it; a hit, or a coalesced
wait, copies the entry into a fresh ``alloc(n)`` buffer.
"""
from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np

from repro_torch.checkpoint.backends.memory import copy_into, private_copy

SHM_DIR = Path("/dev/shm")


def _shm_prefix() -> str:
    """Owner-pid segment prefix shared with the IO-worker arena: one glob
    covers every segment the repo creates."""
    return f"repro-io-{os.getpid():x}-cache-"


def _bytes_of(blob) -> memoryview:
    return memoryview(blob).cast("B")


class BlockCache:
    """Process-lifetime digest -> object-bytes cache (LRU, coalescing)."""

    def __init__(self, budget_bytes: int, *, shm: bool = False):
        if budget_bytes <= 0:
            raise ValueError("BlockCache needs a positive byte budget")
        self.budget_bytes = int(budget_bytes)
        self.shm = bool(shm)
        self._lock = threading.Lock()
        # digest -> read-only memoryview (RAM) or Path (shm); dict order is
        # the LRU order (reinserted on hit, head = least recent)
        self._entries: Dict[str, Any] = {}
        self._sizes: Dict[str, int] = {}
        self._bytes = 0
        self._seq = 0
        self._closed = False
        # digest -> in-flight load {"event", "value", "error", "waiters"}
        self._inflight: Dict[str, Dict[str, Any]] = {}
        self.stats: Dict[str, int] = {
            "hits": 0, "misses": 0, "evictions": 0,
            "coalesced": 0, "bypassed": 0}

    # ------------------------------------------------------------ internals
    def _open_locked(self, digest: str):
        """Hit path under the lock: the entry's source (a memoryview, or an
        open file of its segment, readable after an unlink) and its size;
        refreshes the LRU order.  None where the digest is not held."""
        slot = self._entries.pop(digest, None)
        if slot is None:
            return None
        self._entries[digest] = slot  # most recently used
        if isinstance(slot, Path):
            try:
                return open(slot, "rb"), self._sizes[digest]
            except OSError:
                # the segment went underneath us: a miss, not a failure
                self._drop_locked(digest)
                return None
        return slot, self._sizes[digest]

    def _drop_locked(self, digest: str) -> None:
        slot = self._entries.pop(digest, None)
        self._bytes -= self._sizes.pop(digest, 0)
        if isinstance(slot, Path):
            try:
                slot.unlink()
            except OSError:
                pass

    def _segment(self, blob) -> Optional[Path]:
        """A new shm segment holding ``blob`` (None where tmpfs refuses)."""
        with self._lock:
            self._seq += 1
            path = SHM_DIR / f"{_shm_prefix()}{self._seq:06d}"
        tmp = path.with_name(path.name + ".tmp")
        try:
            tmp.write_bytes(blob)
            tmp.rename(path)
        except OSError:
            # tmpfs unavailable or full: serve uncached rather than fail
            try:
                tmp.unlink()
            except OSError:
                pass
            return None
        return path

    def _admit_locked(self, digest: str, slot, n: int) -> bool:
        """Keep ``slot`` (``n`` bytes) as ``digest``'s entry, evicting the
        least recent entries to fit; False where it is not kept."""
        if self._closed or digest in self._entries:
            return False
        while self._bytes + n > self.budget_bytes and self._entries:
            self._drop_locked(next(iter(self._entries)))
            self.stats["evictions"] += 1
        self._entries[digest] = slot
        self._sizes[digest] = n
        self._bytes += n
        return True

    @staticmethod
    def _fill(src, n: int, alloc: Optional[Callable[[int], Any]]):
        """A fresh ``alloc(n)`` buffer holding ``src``'s bytes (``src`` a
        buffer, or an open segment file, which is closed here)."""
        alloc = alloc or bytearray
        if hasattr(src, "readinto"):
            with src:
                out = memoryview(alloc(n)).cast("B")
                got = 0
                while got < n:
                    k = src.readinto(out[got:])
                    if not k:
                        raise OSError("short read of a block cache segment")
                    got += k
                return out
        out = memoryview(alloc(n)).cast("B")
        copy_into(np.frombuffer(out, np.uint8), _bytes_of(src))
        return out

    # ------------------------------------------------------------------ api
    def get(self, digest: str, loader: Callable[[], Any],
            alloc: Optional[Callable[[int], Any]] = None):
        """The bytes of ``digest``.  On a miss, ``loader()``'s own buffer
        (its bytes are copied into the cache); on a hit or after waiting
        for another thread's load of the same digest, a new buffer from
        ``alloc(n)`` (a bytearray by default) holding a copy."""
        with self._lock:
            src = self._open_locked(digest)
            if src is not None:
                self.stats["hits"] += 1
            else:
                cell = self._inflight.get(digest)
                owner = cell is None
                if owner:
                    cell = self._inflight[digest] = {
                        "event": threading.Event(), "value": None,
                        "error": None, "waiters": 0}
                else:
                    cell["waiters"] += 1
        if src is not None:
            return self._fill(*src, alloc)
        if not owner:
            cell["event"].wait()
            if cell["error"] is not None:
                raise cell["error"]
            with self._lock:
                self.stats["coalesced"] += 1
            return self._fill(cell["value"], cell["value"].nbytes, alloc)
        try:
            blob = loader()
            self._keep(digest, blob, cell)
        except BaseException as e:  # noqa: BLE001 - raised, not memoized
            cell["error"] = e
            with self._lock:
                self._inflight.pop(digest, None)
            raise
        finally:
            cell["event"].set()
        return blob

    def _keep(self, digest: str, blob, cell: Dict[str, Any]) -> None:
        """Admit a loaded blob and hand the threads waiting on ``cell`` a
        private copy of it.  The copy and the segment write run outside
        the lock; the cell leaves the in-flight table, and its waiter count
        is read, in one locked section, so no later thread joins it."""
        data = _bytes_of(blob)
        n = data.nbytes
        slot = None
        if n <= self.budget_bytes and not self._closed:
            slot = self._segment(data) if self.shm else private_copy(data)
        with self._lock:
            self.stats["misses"] += 1
            if n > self.budget_bytes and not self._closed:
                self.stats["bypassed"] += 1
            kept = slot is not None and self._admit_locked(digest, slot, n)
            self._inflight.pop(digest, None)
            waiters = cell["waiters"]
        if isinstance(slot, Path) and not kept:
            slot.unlink(missing_ok=True)
        if waiters:
            cell["value"] = (slot if isinstance(slot, memoryview)
                             else private_copy(data))

    def peek(self, digest: str) -> bool:
        with self._lock:
            return digest in self._entries

    def discard(self, digest: str) -> None:
        """Drop a digest (GC deleted its object)."""
        with self._lock:
            self._drop_locked(digest)

    def clear(self) -> None:
        with self._lock:
            for d in list(self._entries):
                self._drop_locked(d)

    def snapshot(self) -> Dict[str, int]:
        """Point-in-time copy of the counters plus occupancy."""
        with self._lock:
            out = dict(self.stats)
            out["entries"] = len(self._entries)
            out["bytes"] = self._bytes
            out["budget_bytes"] = self.budget_bytes
            return out

    def close(self) -> None:
        """Unlink every shm segment; the cache then passes reads through
        (loads run, nothing is kept)."""
        with self._lock:
            for d in list(self._entries):
                self._drop_locked(d)
            self._closed = True
