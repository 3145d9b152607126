"""StorageBackend — the IO tier contract under the content-addressed store.

A backend owns nothing but where object bytes live: an object is an opaque
blob keyed by its digest string.  Semantics every implementation honors:

- ``write`` is atomic and idempotent: a torn write is never visible to
  ``read``/``has``, and rewriting an existing key is harmless (content
  addressing makes the payload identical by construction).  ``data`` is
  one buffer or several written back to back; a tier that keeps the bytes
  past the call (a RAM tier) copies them, because the caller reuses its
  buffers (pinned staging slots, host views of tensors).
- ``read_into`` of an absent key raises ``FileNotFoundError``.
- ``delete`` is the only way bytes leave permanently; the store calls it
  from refcounted GC only.  A tiered composition may drop a key from its
  fast tier, but only once the durable tier holds it.
- ``sweep_tmp`` reclaims crash leftovers of the tier's own atomic-write
  protocol and never touches committed objects.

The tier surface (``locate`` ... ``tier_backends``) is trivial for a
single tier and answered recursively by a tiered composition.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterator, Optional, Sequence, Union

# An object's bytes: one buffer, or several written back to back.
Data = Union[bytes, bytearray, memoryview, Sequence]


def data_parts(data: Data) -> list:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return [data]
    return list(data)


def data_len(data: Data) -> int:
    return sum(memoryview(p).nbytes for p in data_parts(data))


def data_bytes(data: Data) -> bytes:
    """A private copy of ``data``'s bytes, back to back."""
    parts = data_parts(data)
    if len(parts) == 1 and isinstance(parts[0], bytes):
        return parts[0]
    return b"".join(memoryview(p).cast("B") for p in parts)


class StorageBackend:
    """Abstract object-byte tier.  Keys are content digests (hex)."""

    name: str = "abstract"

    # ---- byte IO ----
    def read_into(self, key: str, alloc) -> memoryview:
        """Read ``key`` into a buffer from ``alloc(nbytes)`` (e.g. pinned
        host memory) and return a memoryview of it."""
        raise NotImplementedError

    def read(self, key: str):
        """The bytes of ``key`` (a buffer the caller may keep)."""
        return self.read_into(key, bytearray)

    def write(self, key: str, data: Data) -> int:
        """Persist ``data`` under ``key`` atomically; returns its length."""
        raise NotImplementedError

    def has(self, key: str) -> bool:
        raise NotImplementedError

    def size(self, key: str) -> int:
        raise NotImplementedError

    def delete(self, key: str) -> int:
        """Remove ``key`` from every tier; returns the bytes freed."""
        raise NotImplementedError

    def keys(self) -> Iterator[str]:
        raise NotImplementedError

    # ---- maintenance ----
    def sweep_tmp(self) -> int:
        return 0

    def close(self) -> None:
        """Release resources; a tiered backend finishes its spills first."""

    # ---- tier introspection ----
    def locate(self, key: str) -> Optional[str]:
        """Name of the fastest tier holding ``key`` (None if absent)."""
        return self.name if self.has(key) else None

    def durable_tier(self) -> str:
        """Name of the tier that survives process exit ("none" for RAM)."""
        return self.name

    def drain(self) -> None:
        """Barrier: block until every pending spill has landed."""

    def pending_spill(self) -> int:
        """Objects written but not yet durable."""
        return 0

    def durability(self) -> Dict[str, object]:
        """What a manifest commit records under ``meta["storage"]`` (the
        store adds ``backend``): ``durable_on`` is the deepest level every
        object written so far has reached, "none" (volatile), "hot" (spill
        owed) or "durable"."""
        durable = self.durable_tier()
        pending = self.pending_spill()
        return {"durable_tier": durable,
                "pending_spill": pending,
                "durable_on": ("none" if durable == "none"
                               else "hot" if pending else "durable")}

    def tier_stats(self) -> Dict[str, int]:
        """Monotonic per-tier counters (reads, writes, spills, ...)."""
        return {}

    def tier_backends(self) -> Dict[str, "StorageBackend"]:
        """Label -> concrete backend of every tier, fastest first."""
        return {self.name: self}

    def path_of(self, key: str) -> Optional[Path]:
        return None
