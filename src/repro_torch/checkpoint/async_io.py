"""Background transfer executor and staging slots of the port's save path
(the thread half of the JAX package's ``checkpoint/async_io.py``).

:class:`TransferPool` is one bounded thread pool whose work is tagged with
a *lane* name, so a producer drains its own lane without waiting on
anyone else's.  :class:`AsyncWriter` is the saver-facing facade over the
``"write"`` lane; a tiered backend's spills run on the same pool, on lanes
``"spill"`` and ``"remote_spill"``.  A pool that carries spills has an
unbounded queue (``max_queue=0``): a task submits follow-on tasks (a write
its spill, a spill the next tier's), and a bounded queue could block every
thread on a full put.  ``AsyncWriter.close`` drains its own lane only and
leaves a shared pool running.  zlib's crc32 and file writes release the
GIL, so the writer threads overlap the training thread's next step.

Errors surface on ``drain()`` of the lane that produced them: a failed
write is never silently dropped, and the manifest of an event commits only
after every object of the event has landed.

:class:`StagingArena` hands out :class:`StagingSlot` s, the landing zones
of the overlapped saver's device->host copies.  A slot is one host
``uint8`` tensor, pinned when the copies come from a CUDA device (so they
run as DMA on a side stream).  Slots are made once, reused across events,
and grow to the largest unit they have held: pinning gigabytes per event
would cost more than the copies.

The JAX package's process workers (``ProcessWorkerPool``, ``IoDispatch``
and its ``/dev/shm`` arena) are not ported yet.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint.faults import crash_point

_SENTINEL = object()


class AsyncWriteError(RuntimeError):
    pass


class PendingResult:
    """Return value of ``submit``: readable after the lane's drain."""
    __slots__ = ("_value", "_error", "_event")

    def __init__(self) -> None:
        self._value = None
        self._error: Optional[BaseException] = None
        self._event = threading.Event()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise AsyncWriteError(
                "result not ready; drain() the writer first")
        if self._error is not None:
            raise self._error
        return self._value


class _LaneState:
    """Per-lane accounting, guarded by ``TransferPool._cond``."""
    __slots__ = ("outstanding", "errors")

    def __init__(self) -> None:
        self.outstanding = 0
        self.errors: List[BaseException] = []


class TransferPool:
    """Bounded thread pool with per-lane accounting.

    ``submit(lane, fn, ...)`` enqueues work; ``drain(lane)`` blocks until
    that lane's outstanding count is zero and raises its collected errors.
    Each task fires the crash point ``pool:<lane>`` before it runs."""

    def __init__(self, num_threads: int = 2, max_queue: int = 0):
        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._cond = threading.Condition()
        self._open = True
        self._lanes: Dict[str, _LaneState] = {}
        self._threads = [
            threading.Thread(target=self._run, name=f"ckpt-transfer-{i}",
                             daemon=True)
            for i in range(max(1, num_threads))
        ]
        for t in self._threads:
            t.start()

    def _lane(self, lane: str) -> _LaneState:
        st = self._lanes.get(lane)
        if st is None:
            st = self._lanes[lane] = _LaneState()
        return st

    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is _SENTINEL:
                    return
                lane, fn, args, kwargs, pending = item
                try:
                    crash_point(f"pool:{lane}")
                    pending._value = fn(*args, **kwargs)
                except BaseException as e:  # noqa: BLE001
                    pending._error = e
                    with self._cond:
                        self._lane(lane).errors.append(e)
                finally:
                    pending._event.set()
                    with self._cond:
                        st = self._lane(lane)
                        st.outstanding -= 1
                        self._cond.notify_all()
            finally:
                self._q.task_done()

    def submit(self, lane: str, fn: Callable, *args, **kwargs
               ) -> PendingResult:
        pending = PendingResult()
        with self._cond:
            if not self._open:
                raise AsyncWriteError("transfer pool is closed")
            self._lane(lane).outstanding += 1
        # Put outside the lock: a full queue still drains, and close()
        # waits on the counters, so this item can never be stranded.
        self._q.put((lane, fn, args, kwargs, pending))
        return pending

    def drain(self, lane: str) -> None:
        """Block until ``lane`` has no outstanding work; raise its errors."""
        with self._cond:
            self._cond.wait_for(lambda: self._lane(lane).outstanding == 0)
            st = self._lane(lane)
            errs, st.errors = st.errors, []
        if errs:
            raise AsyncWriteError(
                f"{len(errs)} checkpoint transfer(s) failed on lane "
                f"{lane!r}: {errs[0]!r}") from errs[0]

    def close(self) -> None:
        with self._cond:
            if not self._open:
                return
            self._open = False
            self._cond.wait_for(
                lambda: all(st.outstanding == 0
                            for st in self._lanes.values()))
        for _ in self._threads:
            self._q.put(_SENTINEL)
        for t in self._threads:
            t.join(timeout=10)


class AsyncWriter:
    """Saver-facing facade over the ``"write"`` lane of a shared
    :class:`TransferPool`; ``close()`` drains that lane and refuses later
    submits (the pool's owner closes the pool)."""

    LANE = "write"

    def __init__(self, pool: TransferPool):
        self.pool = pool
        self._state_lock = threading.Lock()
        self._open = True

    def submit(self, fn: Callable, *args, **kwargs) -> PendingResult:
        with self._state_lock:
            if not self._open:
                raise AsyncWriteError("writer is closed")
            return self.pool.submit(self.LANE, fn, *args, **kwargs)

    def drain(self) -> None:
        """Block until all queued writes finish; raise collected errors."""
        self.pool.drain(self.LANE)

    def close(self) -> None:
        with self._state_lock:
            if not self._open:
                return
            self._open = False
        self.pool.drain(self.LANE)


class StagingSlot:
    """One host staging buffer.  ``view(n)`` appends an ``n``-byte region
    and returns it as a uint8 tensor (the device->host copy's target);
    regions stay valid until the slot is released to its arena."""

    def __init__(self, nbytes: int, pin: bool):
        self.buf = torch.empty(max(1, int(nbytes)), dtype=torch.uint8,
                               pin_memory=pin)
        self._used = 0

    @property
    def capacity(self) -> int:
        return self.buf.numel()

    def reset(self) -> None:
        self._used = 0

    def view(self, nbytes: int) -> torch.Tensor:
        end = self._used + int(nbytes)
        if end > self.capacity:
            raise AsyncWriteError(f"staging slot overflow: {end} > "
                                  f"{self.capacity} bytes")
        out = self.buf[self._used:end]
        self._used = end
        return out


class StagingArena:
    """Reusable staging slots for the overlapped saver.

    ``acquire(nbytes)`` hands out the smallest free slot that holds
    ``nbytes``; failing that, it grows the largest free slot (re-made, not
    copied), or mints a new one when none is free.  Slots are never freed
    before ``close()``, so after the first events the arena holds one slot
    per unit an event stages at once, each as large as the largest unit it
    has carried, and later events allocate nothing."""

    def __init__(self, *, pin: bool, min_bytes: int = 1 << 16):
        self.pin = bool(pin)
        self.min_bytes = int(min_bytes)
        self._lock = threading.Lock()
        self._free: List[StagingSlot] = []
        self._all: List[StagingSlot] = []
        self._closed = False
        self.allocated_bytes = 0    # host bytes held by the slots

    def _size(self, nbytes: int) -> int:
        return max(self.min_bytes, 1 << max(1, int(nbytes) - 1).bit_length())

    def acquire(self, nbytes: int) -> StagingSlot:
        with self._lock:
            if self._closed:
                raise AsyncWriteError("staging arena is closed")
            fits = [s for s in self._free if s.capacity >= nbytes]
            if fits:
                slot = min(fits, key=lambda s: s.capacity)
                self._free.remove(slot)
            elif self._free:
                old = max(self._free, key=lambda s: s.capacity)
                self._free.remove(old)
                slot = StagingSlot(self._size(nbytes), self.pin)
                self._all[self._all.index(old)] = slot
                self.allocated_bytes += slot.capacity - old.capacity
            else:
                slot = StagingSlot(self._size(nbytes), self.pin)
                self._all.append(slot)
                self.allocated_bytes += slot.capacity
        slot.reset()
        return slot

    def release(self, slot: StagingSlot) -> None:
        """Return a slot once its unit's write resolved."""
        with self._lock:
            if self._closed or slot not in self._all or slot in self._free:
                return
            self._free.append(slot)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._free.clear()
            self._all.clear()
            self.allocated_bytes = 0


__all__ = ["AsyncWriteError", "AsyncWriter", "PendingResult",
           "StagingArena", "StagingSlot", "TransferPool"]
