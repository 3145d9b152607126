"""TieredBackend — a fast hot tier over a durable tier with asynchronous
spill (the JAX package's composition, on the port's thread pool).

Every write lands in the *hot* tier (RAM by default), so a save event's
stall is framing and a memcpy, and a spill task on a
:class:`~repro_torch.checkpoint.async_io.TransferPool` lane copies the
object to the *durable* tier while training goes on (one pool carries the
saver's write lane and the spill lanes).

Reads prefer the fastest holder: a hot hit is served from RAM; a hot miss
reads the durable tier and, with ``promote_on_read``, writes the object
back to the hot tier, so a restore warms it for the next one.

Rules that keep the composition safe:

- only *spilled* objects (the durable tier holds a full copy) are evicted,
  least recently used first, while the hot tier exceeds
  ``hot_budget_bytes``; an unspilled object is never dropped, so a slow
  durable tier grows the hot tier past its budget instead of losing data;
- ``delete`` (refcounted GC) removes a key from both tiers;
- ``drain()`` is the durability barrier: after it returns every object
  written so far is on the durable tier, or ``AsyncWriteError`` raises.
  Objects whose spill failed stay dirty (counted by ``pending_spill``) and
  are retried at each drain; the drain cascades into the durable side;
- ``close()`` drains first, then closes the durable side before the pool
  (a nested durable tier drains its own lane on close).

Three tiers (``store_backend="remote3"``): the durable side is itself a
TieredBackend (disk over remote) built with ``required=False``: when the
remote is down a drain records a degraded barrier (the objects stay dirty,
retried at the next barrier) instead of failing the save, and
``durability()`` reports ``durable_on="durable"`` with ``degraded=True``.
``hot_label``/``durable_label`` name each tier for ``locate`` and the
restore's reads per tier ("hot", "durable", "remote").
"""
from __future__ import annotations

import logging
import threading
from pathlib import Path
from typing import Dict, Iterator, Optional

from repro_torch.checkpoint.async_io import AsyncWriteError, TransferPool
from repro_torch.checkpoint.backends.base import (Data, StorageBackend,
                                                  data_len)
from repro_torch.checkpoint.faults import crash_point

log = logging.getLogger("repro_torch.checkpoint.backends")

SPILL_LANE = "spill"


class TieredBackend(StorageBackend):
    name = "tiered"

    def __init__(self, hot: StorageBackend, durable: StorageBackend, *,
                 pool: Optional[TransferPool] = None, spill_threads: int = 2,
                 hot_budget_bytes: Optional[int] = None,
                 promote_on_read: bool = True,
                 lane: str = SPILL_LANE,
                 hot_label: str = "hot",
                 durable_label: Optional[str] = "durable",
                 required: bool = True):
        self.hot = hot
        self.durable = durable
        self._owns_pool = pool is None
        self.pool = pool if pool is not None \
            else TransferPool(max(1, spill_threads))
        self.hot_budget_bytes = hot_budget_bytes
        # Distinct lanes let a nested composition share one pool while each
        # tier drains only its own spills.
        self.lane = lane
        # durable_label=None: the durable side names its own tiers.
        self.hot_label = hot_label
        self.durable_label = durable_label
        # required=False: durability is best effort (only where the hot
        # side itself survives process exit: disk over remote).
        self.required = required
        self.promote_on_read = promote_on_read
        self._lock = threading.Lock()
        # key -> "dirty" (hot only, never evictable) or "spilled" (hot and
        # durable, evictable); absent keys are durable only, or gone.  The
        # dirty count is the durability debt.
        self._resident: Dict[str, str] = {}
        # keys with a spill task queued or running
        self._inflight: set = set()
        self._closed = False
        self._stats = {"hot_writes": 0, "hot_reads": 0, "durable_reads": 0,
                       "spilled_objects": 0, "spilled_bytes": 0,
                       "promotions": 0, "evictions": 0, "evicted_bytes": 0,
                       "degraded_drains": 0}

    # ------------------------------------------------------------- spill
    def _enqueue_spill(self, key: str) -> None:
        with self._lock:
            if key in self._inflight:
                return  # a queued task will pick up the current bytes
            self._inflight.add(key)
        try:
            self.pool.submit(self.lane, self._spill_one, key)
        except BaseException:
            with self._lock:
                self._inflight.discard(key)
            raise

    def _durable_holds(self, key: str, nbytes: int) -> bool:
        """Whether the durable tier holds a full copy of ``key``: ``has``
        alone could trust a torn copy, and equal keys carry equal bytes, so
        the length rejects a truncated one."""
        if not self.durable.has(key):
            return False
        try:
            return self.durable.size(key) == nbytes
        except FileNotFoundError:
            return False

    def _spill_one(self, key: str) -> None:
        try:
            try:
                blob = self.hot.read(key)
            except FileNotFoundError:
                # GC (or an eviction after an earlier spill) removed it.
                return
            crash_point("spill")
            n = memoryview(blob).nbytes
            if not self._durable_holds(key, n):
                self.durable.write(key, blob)
            with self._lock:
                if self._resident.get(key) == "dirty":
                    self._resident[key] = "spilled"
                self._stats["spilled_objects"] += 1
                self._stats["spilled_bytes"] += n
        finally:
            # On failure the key stays dirty: counted, retried, never
            # evicted.
            with self._lock:
                self._inflight.discard(key)
            self._maybe_evict()

    def _maybe_evict(self) -> None:
        """Drop least recently used *spilled* objects while the hot tier
        exceeds its budget (needs an LRU-ordered hot tier)."""
        if self.hot_budget_bytes is None:
            return
        lru_keys = getattr(self.hot, "lru_keys", None)
        total_bytes = getattr(self.hot, "total_bytes", None)
        if lru_keys is None or total_bytes is None:
            return
        while total_bytes() > self.hot_budget_bytes:
            victim = None
            with self._lock:
                for k in lru_keys():
                    if self._resident.get(k) == "spilled":
                        victim = k
                        break
                if victim is not None:
                    self._resident.pop(victim, None)
            if victim is None:
                return  # everything hot is still owed to the durable tier
            freed = self.hot.delete(victim)
            with self._lock:
                self._stats["evictions"] += 1
                self._stats["evicted_bytes"] += freed

    # ------------------------------------------------------------ byte IO
    def read_into(self, key: str, alloc) -> memoryview:
        try:
            buf = self.hot.read_into(key, alloc)
            with self._lock:
                self._stats["hot_reads"] += 1
            return buf
        except FileNotFoundError:
            pass
        buf = self.durable.read_into(key, alloc)
        with self._lock:
            self._stats["durable_reads"] += 1
        if self.promote_on_read:
            # Already durable: the promoted copy is evictable at once.
            self.hot.write(key, buf)
            with self._lock:
                self._resident[key] = "spilled"
                self._stats["promotions"] += 1
            self._maybe_evict()
        return buf

    def write(self, key: str, data: Data) -> int:
        n = self.hot.write(key, data)
        nbytes = data_len(data)
        with self._lock:
            self._stats["hot_writes"] += 1
            already = self._resident.get(key)
            self._resident[key] = ("spilled" if already == "spilled"
                                   or self._durable_holds(key, nbytes)
                                   else "dirty")
            dirty = self._resident[key] == "dirty"
        if dirty:
            self._enqueue_spill(key)
        else:
            self._maybe_evict()
        return n

    def has(self, key: str) -> bool:
        return self.hot.has(key) or self.durable.has(key)

    def size(self, key: str) -> int:
        try:
            return self.hot.size(key)
        except FileNotFoundError:
            return self.durable.size(key)

    def delete(self, key: str) -> int:
        # The tiers hold the same bytes: count them once.
        freed_hot = self.hot.delete(key)
        freed_durable = self.durable.delete(key)
        with self._lock:
            self._resident.pop(key, None)
        return max(freed_hot, freed_durable)

    def keys(self) -> Iterator[str]:
        seen = set(self.hot.keys())
        seen.update(self.durable.keys())
        return iter(sorted(seen))

    # -------------------------------------------------------- maintenance
    def sweep_tmp(self) -> int:
        """Each tier sweeps its own atomic-write leftovers."""
        return self.hot.sweep_tmp() + self.durable.sweep_tmp()

    def drain(self) -> None:
        """Durability barrier (see the module doc).  Failed spills are
        retried once per drain; with ``required=False`` failure degrades
        instead of raising.  Cascades into the durable side."""
        with self._lock:
            retry = [k for k, v in self._resident.items()
                     if v == "dirty" and k not in self._inflight]
        for k in retry:
            self._enqueue_spill(k)
        try:
            self.pool.drain(self.lane)
        except AsyncWriteError:
            if self.required:
                raise
        # A dirty object left means the barrier does not hold, even when
        # this drain's errors were consumed elsewhere.
        with self._lock:
            stuck = [k for k, v in self._resident.items() if v == "dirty"]
        if stuck:
            if self.required:
                raise AsyncWriteError(
                    f"{len(stuck)} object(s) failed to spill to the "
                    f"durable tier (e.g. {stuck[0]})")
            with self._lock:
                self._stats["degraded_drains"] += 1
            log.warning(
                "degraded durability barrier: %d object(s) still owed to "
                "the %s tier (e.g. %s); will retry at the next barrier",
                len(stuck), self.durable.name, stuck[0])
        self.durable.drain()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        try:
            self.drain()
        finally:
            try:
                self.durable.close()
            finally:
                self.hot.close()
                if self._owns_pool:
                    self.pool.close()

    # ------------------------------------------------------ introspection
    def locate(self, key: str) -> Optional[str]:
        if self.hot.has(key):
            return self.hot_label
        if self.durable_label is not None:
            return self.durable_label if self.durable.has(key) else None
        return self.durable.locate(key)

    def durable_tier(self) -> str:
        return self.durable.durable_tier()

    def _own_pending(self) -> int:
        with self._lock:
            return sum(1 for v in self._resident.values() if v == "dirty")

    def pending_spill(self) -> int:
        """This tier's dirty objects plus what the durable side owes."""
        return self._own_pending() + self.durable.pending_spill()

    def durability(self) -> Dict[str, object]:
        """Recursive: the durable side answers for the stack below; a dirty
        object here caps ``durable_on`` at this tier's hot label.
        ``tiers`` maps each boundary's label to the objects owed across it;
        ``degraded`` is true while a best-effort boundary is behind."""
        sub = self.durable.durability()
        own = self._own_pending()
        out = dict(sub)
        out["pending_spill"] = own + int(sub.get("pending_spill", 0))
        tiers = dict(sub.get("tiers", {}))
        tiers[self.hot_label] = own
        out["tiers"] = tiers
        if own and sub.get("durable_on") != "none":
            out["durable_on"] = self.hot_label
        out["degraded"] = bool(sub.get("degraded")) \
            or (not self.required and own > 0)
        return out

    def tier_stats(self) -> Dict[str, int]:
        pending = self.pending_spill()
        with self._lock:
            out = dict(self._stats, pending_spill=pending)
        hot_bytes = getattr(self.hot, "total_bytes", None)
        if hot_bytes is not None:
            out["hot_resident_bytes"] = hot_bytes()
        # the durable side's counters; a name both use is prefixed
        for k, v in self.durable.tier_stats().items():
            out[k if k not in out else f"{self.durable.name}_{k}"] = v
        return out

    def tier_backends(self) -> Dict[str, StorageBackend]:
        out: Dict[str, StorageBackend] = {self.hot_label: self.hot}
        sub = self.durable.tier_backends()
        if len(sub) == 1 and self.durable_label is not None:
            out[self.durable_label] = next(iter(sub.values()))
        else:
            out.update(sub)
        return out

    def path_of(self, key: str) -> Optional[Path]:
        # the durable copy is the one offline tools poke
        return self.durable.path_of(key) or self.hot.path_of(key)
