"""FaultInjectingBackend — a hostile IO tier for resiliency drills (the
port's copy of the JAX package's decorator).

Wraps any :class:`~repro_torch.checkpoint.backends.base.StorageBackend`
and misbehaves on cue:

- ``crash_on_write=N``     the Nth matching write raises
                           :class:`InjectedCrash` before the inner write
                           (``crash_mode="raise"``) or hard-kills the
                           process (``"exit"``, ``os._exit``);
- ``error_on_write=N|{N,...}|"all"``   raise ``write_error`` (default
                           ``OSError``) on those 1-based write indices;
- ``error_on_read=...``    the same for reads;
- ``torn_on_write=N|{N,...}``  pass only the first half of the payload to
                           the inner tier, then raise: a torn copy that an
                           honest tier must detect;
- ``write_latency`` / ``read_latency``  seconds slept per matching op;
- ``error_rate_write`` / ``error_rate_read``  seeded per-op error rates:
                           op N fails iff ``hash(seed, kind, N) < rate``;
- ``match=fn``             only keys with ``fn(key)`` true are counted and
                           faulted.
"""
from __future__ import annotations

import hashlib
import os
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterator, Optional, Set, Union

from repro_torch.checkpoint.backends.base import (Data, StorageBackend,
                                                  data_bytes)
from repro_torch.checkpoint.faults import EXIT_CRASHED, InjectedCrash

_Idx = Union[int, Set[int], frozenset, str, None]  # N | {N,...} | "all"


def _due(spec: _Idx, n: int) -> bool:
    if spec is None:
        return False
    if spec == "all":
        return True
    if isinstance(spec, int):
        return n == spec
    return n in spec


def _seeded_due(rate: float, seed: int, kind: str, n: int) -> bool:
    """Deterministic Bernoulli(rate) draw for op ``n`` of ``kind``."""
    if rate <= 0.0:
        return False
    h = hashlib.blake2b(f"{seed}:{kind}:{n}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big") / 2.0 ** 64 < rate


class FaultInjectingBackend(StorageBackend):
    """A StorageBackend decorator that injects failures on demand."""

    name = "faulty"

    def __init__(self, inner: StorageBackend, *,
                 crash_on_write: Optional[int] = None,
                 crash_mode: str = "raise",
                 exit_code: int = EXIT_CRASHED,
                 error_on_write: _Idx = None,
                 write_error: Optional[Exception] = None,
                 error_on_read: _Idx = None,
                 read_error: Optional[Exception] = None,
                 torn_on_write: _Idx = None,
                 write_latency: float = 0.0,
                 read_latency: float = 0.0,
                 error_rate_write: float = 0.0,
                 error_rate_read: float = 0.0,
                 seed: int = 0,
                 match: Optional[Callable[[str], bool]] = None) -> None:
        if crash_mode not in ("raise", "exit"):
            raise ValueError(f"unknown crash_mode {crash_mode!r}")
        self.inner = inner
        self.crash_on_write = crash_on_write
        self.crash_mode = crash_mode
        self.exit_code = exit_code
        self.error_on_write = error_on_write
        self.write_error = write_error or OSError("injected write error")
        self.error_on_read = error_on_read
        self.read_error = read_error or OSError("injected read error")
        self.torn_on_write = torn_on_write
        self.write_latency = write_latency
        self.read_latency = read_latency
        self.error_rate_write = error_rate_write
        self.error_rate_read = error_rate_read
        self.seed = seed
        self.match = match
        self.writes = 0          # matching writes attempted
        self.reads = 0
        self.faults = 0          # faults fired
        self._lock = threading.Lock()

    def heal(self) -> None:
        """Drop every fault knob (the counters keep advancing)."""
        self.crash_on_write = None
        self.error_on_write = None
        self.error_on_read = None
        self.torn_on_write = None
        self.write_latency = 0.0
        self.read_latency = 0.0
        self.error_rate_write = 0.0
        self.error_rate_read = 0.0

    def _matches(self, key: str) -> bool:
        return self.match is None or self.match(key)

    # ---- byte IO ----
    def write(self, key: str, data: Data) -> int:
        if not self._matches(key):
            return self.inner.write(key, data)
        with self._lock:
            self.writes += 1
            n = self.writes
            crash = (self.crash_on_write is not None
                     and n == self.crash_on_write)
            err = (_due(self.error_on_write, n)
                   or _seeded_due(self.error_rate_write, self.seed,
                                  "w", n))
            torn = _due(self.torn_on_write, n)
            if crash or err or torn:
                self.faults += 1
        if self.write_latency:
            time.sleep(self.write_latency)
        if crash:
            if self.crash_mode == "exit":
                os._exit(self.exit_code)
            raise InjectedCrash(
                f"injected crash on write #{n} of {key!r}")
        if torn:
            # half the payload reaches the inner tier, then the writer dies
            blob = data_bytes(data)
            self.inner.write(key, blob[: max(1, len(blob) // 2)])
            raise self.write_error
        if err:
            raise self.write_error
        return self.inner.write(key, data)

    def read_into(self, key: str, alloc) -> memoryview:
        if self._matches(key):
            with self._lock:
                self.reads += 1
                n = self.reads
                err = (_due(self.error_on_read, n)
                       or _seeded_due(self.error_rate_read, self.seed,
                                      "r", n))
                if err:
                    self.faults += 1
            if self.read_latency:
                time.sleep(self.read_latency)
            if err:
                raise self.read_error
        return self.inner.read_into(key, alloc)

    def has(self, key: str) -> bool:
        return self.inner.has(key)

    def size(self, key: str) -> int:
        return self.inner.size(key)

    def delete(self, key: str) -> int:
        return self.inner.delete(key)

    def keys(self) -> Iterator[str]:
        return self.inner.keys()

    # ---- maintenance / introspection: pure passthrough ----
    def sweep_tmp(self) -> int:
        return self.inner.sweep_tmp()

    def close(self) -> None:
        self.inner.close()

    def locate(self, key: str) -> Optional[str]:
        return self.inner.locate(key)

    def durable_tier(self) -> str:
        return self.inner.durable_tier()

    def drain(self) -> None:
        self.inner.drain()

    def pending_spill(self) -> int:
        return self.inner.pending_spill()

    def tier_stats(self) -> Dict[str, int]:
        stats = dict(self.inner.tier_stats())
        stats["injected_faults"] = self.faults
        return stats

    def path_of(self, key: str) -> Optional[Path]:
        return self.inner.path_of(key)
