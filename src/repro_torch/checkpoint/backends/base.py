"""StorageBackend — the IO tier contract under the content-addressed store.

A backend owns nothing but where object bytes live: an object is an opaque
blob keyed by its digest string.  Semantics every implementation honors:

- ``write`` is atomic and idempotent: a torn write is never visible to
  ``read``/``has``, and rewriting an existing key is harmless (content
  addressing makes the payload identical by construction).
- ``read`` of an absent key raises ``FileNotFoundError``.
- ``delete`` is the only way bytes leave permanently; the store calls it
  from refcounted GC only.
- ``sweep_tmp`` reclaims crash leftovers of the tier's own atomic-write
  protocol and never touches committed objects.
"""
from __future__ import annotations

from pathlib import Path
from typing import Iterator, Optional, Sequence, Union

# An object's bytes: one buffer, or several written back to back.
Data = Union[bytes, bytearray, memoryview, Sequence]


def data_parts(data: Data) -> list:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return [data]
    return list(data)


def data_len(data: Data) -> int:
    return sum(memoryview(p).nbytes for p in data_parts(data))


class StorageBackend:
    """Abstract object-byte tier.  Keys are content digests (hex)."""

    name: str = "abstract"

    def read_into(self, key: str, alloc) -> memoryview:
        """Read ``key`` into a buffer from ``alloc(nbytes)`` (e.g. pinned
        host memory) and return a memoryview of it."""
        raise NotImplementedError

    def write(self, key: str, data: Data) -> int:
        """Persist ``data`` under ``key`` atomically; returns its length."""
        raise NotImplementedError

    def has(self, key: str) -> bool:
        raise NotImplementedError

    def size(self, key: str) -> int:
        raise NotImplementedError

    def delete(self, key: str) -> int:
        raise NotImplementedError

    def keys(self) -> Iterator[str]:
        raise NotImplementedError

    def sweep_tmp(self) -> int:
        return 0

    def close(self) -> None:
        pass

    def path_of(self, key: str) -> Optional[Path]:
        return None
