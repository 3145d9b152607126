"""Retry/backoff primitives for fault-tolerant storage tiers.

Three small, composable pieces (no storage imports — the remote backend,
the chunk store's read paths, and tests all reuse them):

- :class:`RetryPolicy` — bounded exponential backoff with *deterministic*
  jitter: the per-attempt delay is derived from a blake2 hash of
  ``(seed, key, attempt)``, so two runs of the same scenario sleep the
  same schedule (CI-reproducible) while distinct keys still decorrelate
  (no thundering herd of identical retry waves).
- :class:`CircuitBreaker` — consecutive-failure trip wire: after
  ``failures`` failures in a row the circuit *opens* and callers fail
  fast (no retries, no sleeps) until ``cooldown`` seconds pass, at which
  point probes are allowed again (half-open); one success closes it.
  This is what lets a tiered composition degrade to its disk tier during
  a sustained remote outage instead of stalling every save on a full
  retry schedule per object.
- :class:`LatencyTracker` — ring buffer of recent op latencies with a
  percentile query, feeding the remote backend's hedged-GET trigger
  ("issue a second GET once the first has outlived p95 × factor").

Transience classification: ``default_transient`` retries ``OSError``
(except ``FileNotFoundError`` — an absent key is an answer, not a fault)
and ``TimeoutError``.  Everything else — corruption, ``InjectedCrash``,
programming errors — propagates immediately.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Callable, List, Optional


def default_transient(exc: BaseException) -> bool:
    """Whether ``exc`` is worth retrying (see module docstring)."""
    if isinstance(exc, FileNotFoundError):
        return False
    return isinstance(exc, (OSError, TimeoutError))


def _hash01(seed: int, key: str, n: int) -> float:
    """Deterministic uniform-ish float in [0, 1) from (seed, key, n)."""
    h = hashlib.blake2b(f"{seed}:{key}:{n}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big") / 2.0 ** 64


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff with deterministic jitter.

    ``attempts`` is the TOTAL number of tries (1 = no retry).  The delay
    before retry *i* (1-based) is ``min(max_delay, base_delay * 2**(i-1))``
    scaled by ``1 + jitter * u`` where ``u`` is the deterministic hash of
    ``(seed, key, i)``.  ``timeout`` is a per-attempt budget that ops may
    honor (the simulated remote transport raises ``RemoteTimeout`` when
    an op's injected latency exceeds it); the policy itself only threads
    it through via ``self.timeout``.
    """

    attempts: int = 4
    base_delay: float = 0.005
    max_delay: float = 0.25
    jitter: float = 0.5
    timeout: Optional[float] = None
    seed: int = 0

    def delay(self, key: str, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based) of op ``key``."""
        base = min(self.max_delay, self.base_delay * (2.0 ** (attempt - 1)))
        return base * (1.0 + self.jitter * _hash01(self.seed, key, attempt))

    def run(self, op: Callable[[], object], *, key: str = "",
            classify: Callable[[BaseException], bool] = default_transient,
            on_retry: Optional[Callable[[int, BaseException], None]] = None,
            sleep: Callable[[float], None] = time.sleep):
        """Call ``op()`` with up to ``attempts`` tries.

        Non-transient exceptions propagate immediately; the last
        transient exception propagates once attempts are exhausted.
        ``on_retry(attempt, exc)`` fires before each backoff sleep —
        counters hang off it.
        """
        last: Optional[BaseException] = None
        for i in range(1, max(1, self.attempts) + 1):
            try:
                return op()
            except BaseException as e:  # noqa: BLE001 - classified below
                if not classify(e) or i >= max(1, self.attempts):
                    raise
                last = e
                if on_retry is not None:
                    on_retry(i, e)
                sleep(self.delay(key, i))
        raise last  # pragma: no cover - loop always returns or raises


class CircuitBreaker:
    """Consecutive-failure circuit: closed → open → (cooldown) half-open.

    ``allow()`` answers "may this op run?"; while open it returns False
    (the caller fails fast) until ``cooldown`` seconds have passed, after
    which probes run again.  ``record_success`` closes the circuit and
    zeroes the failure streak; ``record_failure`` advances it and opens
    the circuit at ``failures``.
    """

    def __init__(self, *, failures: int = 5, cooldown: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        self.failures = max(1, failures)
        self.cooldown = cooldown
        self._clock = clock
        self._lock = threading.Lock()
        self._streak = 0
        self._open_until: Optional[float] = None
        self.opens = 0          # times the circuit tripped (monotonic)

    @property
    def state(self) -> str:
        with self._lock:
            if self._open_until is None:
                return "closed"
            return "half-open" if self._clock() >= self._open_until \
                else "open"

    def allow(self) -> bool:
        with self._lock:
            return (self._open_until is None
                    or self._clock() >= self._open_until)

    def record_success(self) -> None:
        with self._lock:
            self._streak = 0
            self._open_until = None

    def record_failure(self) -> None:
        with self._lock:
            self._streak += 1
            if self._streak >= self.failures:
                if self._open_until is None \
                        or self._clock() >= self._open_until:
                    self.opens += 1  # closed/half-open -> open transition
                self._open_until = self._clock() + self.cooldown


class LatencyTracker:
    """Ring buffer of recent op latencies (seconds) with percentiles."""

    def __init__(self, capacity: int = 64, min_samples: int = 4):
        self.capacity = max(1, capacity)
        self.min_samples = max(1, min_samples)
        self._lock = threading.Lock()
        self._buf: List[float] = []
        self._next = 0

    def record(self, seconds: float) -> None:
        with self._lock:
            if len(self._buf) < self.capacity:
                self._buf.append(seconds)
            else:
                self._buf[self._next] = seconds
                self._next = (self._next + 1) % self.capacity

    def percentile(self, p: float) -> Optional[float]:
        """p in [0, 100]; None until ``min_samples`` ops were recorded."""
        with self._lock:
            if len(self._buf) < self.min_samples:
                return None
            s = sorted(self._buf)
        idx = min(len(s) - 1, int(round((p / 100.0) * (len(s) - 1))))
        return s[idx]
