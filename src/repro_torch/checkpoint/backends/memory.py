"""MemoryBackend — the RAM tier.

A thread-safe ordered dict of key -> bytes.  Reads move a key to the
most recently used position, so a composing
:class:`~repro_torch.checkpoint.backends.tiered.TieredBackend` can evict in
LRU order; the dict itself never evicts (dropping bytes that are durable
nowhere else is the composition's decision).

``write`` keeps a private copy of the parts it is given: the saver hands
it views of pinned staging slots and of host tensors, which it reuses for
the next event, and a view kept here would let that event rewrite a
committed object.  The copies in and out of a large object run in
``COPY_CHUNK`` pieces on ``COPY_THREADS`` threads (numpy releases the GIL
while it copies): one thread's first touch of fresh memory would make the
RAM tier as slow as a write to the page cache.

Standalone (``store_backend="memory"``) it gives volatile checkpoints:
durability is ``none``, which the manifest records.
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.checkpoint.backends.base import (Data, StorageBackend,
                                                  data_parts)

COPY_CHUNK = 64 << 20
COPY_THREADS = 4


def copy_into(out: np.ndarray, data: Data) -> None:
    """Copy ``data``'s buffers back to back into the uint8 array ``out``."""
    srcs = [np.frombuffer(memoryview(p).cast("B"), np.uint8)
            for p in data_parts(data)]
    jobs, off = [], 0
    for s in srcs:
        for a in range(0, s.size, COPY_CHUNK):
            jobs.append((off + a, s[a:a + COPY_CHUNK]))
        off += s.size

    def copy(job) -> None:
        at, piece = job
        out[at:at + piece.size] = piece

    if len(jobs) > 1:
        with ThreadPoolExecutor(min(COPY_THREADS, len(jobs))) as ex:
            list(ex.map(copy, jobs))
    else:
        for job in jobs:
            copy(job)


def private_copy(data: Data) -> memoryview:
    """A read-only copy of ``data``'s bytes, back to back."""
    out = np.empty(sum(memoryview(p).nbytes for p in data_parts(data)),
                   np.uint8)
    copy_into(out, data)
    return memoryview(out).toreadonly()


class MemoryBackend(StorageBackend):
    name = "memory"

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._objects: Dict[str, memoryview] = {}
        self._bytes = 0
        self._stats = {"reads": 0, "writes": 0, "read_bytes": 0,
                       "written_bytes": 0}

    def read(self, key: str) -> memoryview:
        with self._lock:
            blob = self._objects.pop(key, None)
            if blob is None:
                raise FileNotFoundError(f"memory tier has no object {key}")
            self._objects[key] = blob  # most recently used
            self._stats["reads"] += 1
            self._stats["read_bytes"] += len(blob)
            return blob

    def read_into(self, key: str, alloc) -> memoryview:
        blob = self.read(key)
        buf = memoryview(alloc(len(blob))).cast("B")
        copy_into(np.frombuffer(buf, np.uint8), blob)
        return buf

    def write(self, key: str, data: Data) -> int:
        data = private_copy(data)
        with self._lock:
            old = self._objects.pop(key, None)
            if old is not None:
                self._bytes -= len(old)
            self._objects[key] = data
            self._bytes += len(data)
            self._stats["writes"] += 1
            self._stats["written_bytes"] += len(data)
        return len(data)

    def has(self, key: str) -> bool:
        with self._lock:
            return key in self._objects

    def size(self, key: str) -> int:
        with self._lock:
            blob = self._objects.get(key)
        if blob is None:
            raise FileNotFoundError(f"memory tier has no object {key}")
        return len(blob)

    def delete(self, key: str) -> int:
        with self._lock:
            blob = self._objects.pop(key, None)
            if blob is None:
                return 0
            self._bytes -= len(blob)
            return len(blob)

    def keys(self) -> Iterator[str]:
        with self._lock:
            snapshot = list(self._objects)
        return iter(sorted(snapshot))

    def lru_keys(self) -> Iterator[str]:
        """Keys least recently used first (a tiered eviction scan)."""
        with self._lock:
            snapshot = list(self._objects)
        return iter(snapshot)

    def total_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def durable_tier(self) -> str:
        return "none"

    def tier_stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._stats, resident_bytes=self._bytes,
                        resident_objects=len(self._objects))

    def path_of(self, key: str) -> Optional[str]:
        return None
