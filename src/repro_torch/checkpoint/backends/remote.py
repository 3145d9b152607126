"""RemoteBackend — an S3/GCS-shaped object tier, simulated locally (the
port's copy of the JAX package's tier; same bucket layout, same verbs in
the same order, so one seed gives one fault schedule in both).

- :class:`SimulatedObjectService` — the "cloud": a directory bucket
  (``<root>/<key[:2]>/<key>.blob``) speaking object-store verbs
  (multipart PUT: initiate / put_part / complete, ranged GET, HEAD,
  DELETE, LIST) through a fault-injecting transport: per-op latency,
  seeded errors and throttles, latency spikes, and a cross-process outage
  marker file (``OUTAGE`` in the bucket root).  Every draw is a blake2 of
  ``(seed, verb, op_index)``.
- :class:`RemoteBackend` — the :class:`StorageBackend` over the service:
  every verb runs under a :class:`~.retry.RetryPolicy`; GETs are hedged (a
  second GET races a first that outlived the tracked latency percentile ×
  factor, each into its own buffer, and the first success wins); a
  :class:`~.retry.CircuitBreaker` fails ops fast during an outage so a
  tier above degrades to disk.  ``tier_stats`` exposes the counters.

``write`` takes an object as several buffers back to back and cuts their
concatenation into ``part_size`` parts, as the JAX tier cuts its one
buffer.  ``read_into``/``write``/``size`` raise after bounded retries;
``has``/``delete``/``keys`` degrade softly (False / 0 / empty, counted).
"""
from __future__ import annotations

import hashlib
import logging
import os
import shutil
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Set

from repro_torch.checkpoint.backends.base import (Data, StorageBackend,
                                                  data_len, data_parts)
from repro_torch.checkpoint.backends.localfs import read_file_into
from repro_torch.checkpoint.backends.retry import (CircuitBreaker,
                                                   LatencyTracker,
                                                   RetryPolicy)

log = logging.getLogger("repro_torch.checkpoint.backends")


class RemoteError(OSError):
    """A simulated remote failure (transient: an OSError)."""


class RemoteOutage(RemoteError):
    """Service unavailable (5xx-shaped, or the outage marker)."""


class RemoteThrottle(RemoteError):
    """Rate limited (429-shaped)."""


class RemoteTimeout(RemoteError):
    """An op exceeded its per-op timeout."""


class RemoteUnavailable(RemoteError):
    """Fast fail: the circuit breaker is open (no attempt was made)."""


def _h01(seed: int, tag: str, n: int) -> float:
    h = hashlib.blake2b(f"{seed}:{tag}:{n}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big") / 2.0 ** 64


DEFAULT_PART_SIZE = 8 << 20


def split_parts(data: Data, part_size: int) -> List[List[memoryview]]:
    """The concatenation of ``data``'s buffers cut into ``part_size``
    pieces, each as the list of views that makes it up (no copy)."""
    out: List[List[memoryview]] = []
    cur: List[memoryview] = []
    room = part_size
    for p in data_parts(data):
        mv = memoryview(p).cast("B")
        off = 0
        while off < mv.nbytes:
            take = min(room, mv.nbytes - off)
            cur.append(mv[off:off + take])
            off += take
            room -= take
            if room == 0:
                out.append(cur)
                cur, room = [], part_size
    if cur:
        out.append(cur)
    return out


def _append_file(src, dst) -> int:
    """Copy the file ``src`` to the end of ``dst`` (both open; ``dst``'s
    buffer empty) by ``copy_file_range``, or by reads and writes where the
    filesystem refuses it; returns the bytes copied."""
    size = os.fstat(src.fileno()).st_size
    done = 0
    try:
        while done < size:
            k = os.copy_file_range(src.fileno(), dst.fileno(), size - done)
            if not k:
                break
            done += k
    except OSError:
        if done:
            raise
        shutil.copyfileobj(src, dst, 8 << 20)
        dst.flush()  # the next part's copy writes at the descriptor
        return size
    if done != size:
        raise OSError(f"short copy of {src.name}: {done} of {size} bytes")
    return done


class SimulatedObjectService:
    """Directory-backed bucket behind a fault-injecting transport.  A
    multipart upload stages its parts under ``<root>/uploads/`` and
    publishes atomically on ``complete``: an upload that dies leaves staged
    garbage (``sweep_uploads``), never a torn object."""

    def __init__(self, root: Path | str, *, latency: float = 0.0,
                 error_rate: float = 0.0, throttle_rate: float = 0.0,
                 spike_rate: float = 0.0, spike_latency: float = 0.0,
                 spike_ops: Optional[Set[int]] = None, seed: int = 0):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.latency = latency
        self.error_rate = error_rate
        self.throttle_rate = throttle_rate
        self.spike_rate = spike_rate
        self.spike_latency = spike_latency
        self.spike_ops = spike_ops  # explicit 1-based op indices
        self.seed = seed
        self._lock = threading.Lock()
        self._op_n = 0
        self.ops: Dict[str, int] = {}

    # ---- fault controls ----
    @property
    def outage_marker(self) -> Path:
        return self.root / "OUTAGE"

    def set_outage(self, down: bool) -> None:
        """While the marker file exists every op raises RemoteOutage (any
        process can take the bucket down by touching it)."""
        if down:
            self.outage_marker.touch()
        else:
            try:
                self.outage_marker.unlink()
            except FileNotFoundError:
                pass

    def heal(self) -> None:
        self.set_outage(False)
        self.error_rate = self.throttle_rate = 0.0
        self.spike_rate = 0.0
        self.spike_ops = None

    # ---- transport ----
    def _op(self, verb: str, *, timeout: Optional[float] = None) -> None:
        with self._lock:
            self._op_n += 1
            n = self._op_n
            self.ops[verb] = self.ops.get(verb, 0) + 1
        if self.outage_marker.exists():
            raise RemoteOutage(f"remote outage (op #{n} {verb})")
        if self.error_rate and _h01(self.seed, "err", n) < self.error_rate:
            raise RemoteOutage(f"injected remote error (op #{n} {verb})")
        if self.throttle_rate \
                and _h01(self.seed, "thr", n) < self.throttle_rate:
            raise RemoteThrottle(f"injected throttle (op #{n} {verb})")
        lat = self.latency
        if (self.spike_ops is not None and n in self.spike_ops) or (
                self.spike_rate
                and _h01(self.seed, "spk", n) < self.spike_rate):
            lat += self.spike_latency
        if timeout is not None and lat > timeout:
            time.sleep(timeout)  # the budget, not the whole latency
            raise RemoteTimeout(
                f"op #{n} {verb} exceeded {timeout}s (simulated {lat}s)")
        if lat:
            time.sleep(lat)

    # ---- object verbs ----
    def blob_path(self, key: str) -> Path:
        return self.root / key[:2] / f"{key}.blob"

    def head(self, key: str, *, timeout: Optional[float] = None) -> int:
        self._op("head", timeout=timeout)
        try:
            return self.blob_path(key).stat().st_size
        except FileNotFoundError:
            raise FileNotFoundError(f"remote object {key} not found")

    def get_into(self, key: str, alloc, start: int = 0,
                 end: Optional[int] = None, *,
                 timeout: Optional[float] = None) -> memoryview:
        """Ranged GET of bytes [start, end) (end=None: to EOF) into a
        buffer from ``alloc(nbytes)``."""
        self._op("get", timeout=timeout)
        try:
            return read_file_into(self.blob_path(key), alloc, start, end)
        except FileNotFoundError:
            raise FileNotFoundError(f"remote object {key} not found")

    def initiate(self, key: str, *, timeout: Optional[float] = None) -> str:
        self._op("initiate", timeout=timeout)
        upload = (f"{key}.{os.getpid():x}-{threading.get_ident():x}"
                  f"-{time.monotonic_ns():x}")
        (self.root / "uploads" / upload).mkdir(parents=True, exist_ok=True)
        return upload

    def put_part(self, upload: str, index: int, data: Data,
                 *, timeout: Optional[float] = None) -> None:
        self._op("put_part", timeout=timeout)
        part = self.root / "uploads" / upload / f"part-{index:06d}"
        with open(part, "wb") as f:
            for p in data_parts(data):
                f.write(p)

    def complete(self, key: str, upload: str,
                 *, timeout: Optional[float] = None) -> int:
        self._op("complete", timeout=timeout)
        stage = self.root / "uploads" / upload
        parts = sorted(stage.glob("part-*"))
        # the parts back to back, copied by the kernel (no joined copy)
        path = self.blob_path(key)
        tmp = path.with_suffix(
            path.suffix + f".tmp-{os.getpid():x}-{threading.get_ident():x}")
        tmp.parent.mkdir(parents=True, exist_ok=True)
        n = 0
        with open(tmp, "wb") as f:
            for p in parts:
                with open(p, "rb") as src:
                    n += _append_file(src, f)
        os.replace(tmp, path)
        for p in parts:
            p.unlink()
        try:
            stage.rmdir()
        except OSError:
            pass
        return n

    def abort(self, upload: str) -> None:
        stage = self.root / "uploads" / upload
        if stage.is_dir():
            for p in stage.glob("part-*"):
                p.unlink()
            try:
                stage.rmdir()
            except OSError:
                pass

    def delete(self, key: str, *, timeout: Optional[float] = None) -> int:
        self._op("delete", timeout=timeout)
        p = self.blob_path(key)
        try:
            freed = p.stat().st_size
            p.unlink()
        except FileNotFoundError:
            return 0
        try:
            p.parent.rmdir()
        except OSError:
            pass
        return freed

    def list_keys(self, *, timeout: Optional[float] = None) -> List[str]:
        self._op("list", timeout=timeout)
        return sorted(p.stem for p in self.root.glob("*/*.blob"))

    def sweep_uploads(self) -> int:
        """Staged parts of other processes' uploads that never completed."""
        freed = 0
        updir = self.root / "uploads"
        if updir.is_dir():
            own = f".{os.getpid():x}-"
            for stage in updir.iterdir():
                if own in stage.name:
                    continue  # possibly live in this process
                for p in stage.glob("part-*"):
                    freed += p.stat().st_size
                    p.unlink()
                try:
                    stage.rmdir()
                except OSError:
                    pass
        return freed


class RemoteBackend(StorageBackend):
    """StorageBackend over a :class:`SimulatedObjectService` with retries,
    hedged GETs and a circuit breaker (see the module doc)."""

    name = "remote"

    def __init__(self, service: SimulatedObjectService, *,
                 policy: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 part_size: int = DEFAULT_PART_SIZE,
                 range_bytes: Optional[int] = None,
                 hedge: bool = True, hedge_percentile: float = 95.0,
                 hedge_factor: float = 2.0,
                 hedge_min_delay: float = 0.005):
        self.service = service
        self.policy = policy if policy is not None else RetryPolicy()
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self.part_size = max(1, part_size)
        # None: whole-object GETs; else ranged GETs of this size (a
        # transient error mid-object retries one range)
        self.range_bytes = range_bytes
        self.hedge = hedge
        self.hedge_percentile = hedge_percentile
        self.hedge_factor = hedge_factor
        self.hedge_min_delay = hedge_min_delay
        self.latencies = LatencyTracker()
        self._pool: Optional[ThreadPoolExecutor] = None
        self._lock = threading.Lock()
        self._stats = {"remote_gets": 0, "remote_puts": 0,
                       "remote_put_parts": 0, "remote_retries": 0,
                       "remote_hedges": 0, "remote_hedge_wins": 0,
                       "remote_breaker_opens": 0, "remote_fast_fails": 0,
                       "remote_soft_fails": 0}

    def _bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._stats[key] += n

    def _call(self, verb: str, key: str, fn):
        """``fn()`` under the breaker and the retry policy, its latency
        recorded."""
        if not self.breaker.allow():
            self._bump("remote_fast_fails")
            raise RemoteUnavailable(
                f"remote circuit open; {verb} {key} failed fast")

        def on_retry(attempt: int, exc: BaseException) -> None:
            self._bump("remote_retries")
            self.breaker.record_failure()

        t0 = time.monotonic()
        before = self.breaker.opens
        try:
            out = self.policy.run(fn, key=f"{verb}:{key}",
                                  on_retry=on_retry)
        except FileNotFoundError:
            # an absent key is an answer from a healthy service
            self.breaker.record_success()
            raise
        except BaseException:
            self.breaker.record_failure()
            if self.breaker.opens > before:
                self._bump("remote_breaker_opens",
                           self.breaker.opens - before)
                log.warning("remote circuit OPEN after repeated %s "
                            "failures; degrading to lower tiers", verb)
            raise
        self.breaker.record_success()
        self.latencies.record(time.monotonic() - t0)
        return out

    # ---- byte IO ----
    def _get_once(self, key: str, alloc) -> memoryview:
        to = self.policy.timeout
        if self.range_bytes is None:
            return self.service.get_into(key, alloc, timeout=to)
        size = self.service.head(key, timeout=to)
        buf = memoryview(alloc(size)).cast("B")
        for off in range(0, size, self.range_bytes):
            end = min(off + self.range_bytes, size)
            view = buf[off:end]
            self.service.get_into(key, lambda n, v=view: v, off, end,
                                  timeout=to)
        return buf

    def _hedge_after(self) -> Optional[float]:
        p = self.latencies.percentile(self.hedge_percentile)
        if p is None:
            return None
        return max(self.hedge_min_delay, p * self.hedge_factor)

    def read_into(self, key: str, alloc) -> memoryview:
        self._bump("remote_gets")

        def run() -> memoryview:
            # one buffer per attempt: a hedged pair never shares one
            return self._call("get", key, lambda: self._get_once(key, alloc))

        after = self._hedge_after() if self.hedge else None
        if after is None:
            return run()
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=4, thread_name_prefix="remote-hedge")
            pool = self._pool
        primary = pool.submit(run)
        done, _ = wait({primary}, timeout=after)
        if done:
            return primary.result()
        # the primary outlived the latency percentile: race a second GET
        self._bump("remote_hedges")
        hedged = pool.submit(run)
        pending = {primary, hedged}
        last_exc: Optional[BaseException] = None
        while pending:
            done, pending = wait(pending, return_when=FIRST_COMPLETED)
            for f in done:
                exc = f.exception()
                if exc is None:
                    if f is hedged:
                        self._bump("remote_hedge_wins")
                    for p in pending:
                        p.cancel()
                    return f.result()
                last_exc = exc
        raise last_exc  # both attempts failed

    def write(self, key: str, data: Data) -> int:
        self._bump("remote_puts")
        to = self.policy.timeout
        upload = self._call("initiate", key,
                            lambda: self.service.initiate(key, timeout=to))
        try:
            for i, chunk in enumerate(split_parts(data, self.part_size)):
                self._bump("remote_put_parts")
                self._call(
                    "put_part", key,
                    lambda u=upload, i=i, c=chunk:
                        self.service.put_part(u, i, c, timeout=to))
            if not data_len(data):  # a zero-byte object still publishes
                self._call("put_part", key,
                           lambda: self.service.put_part(upload, 0, b"",
                                                         timeout=to))
            self._call("complete", key,
                       lambda: self.service.complete(key, upload,
                                                     timeout=to))
        except BaseException:
            self.service.abort(upload)
            raise
        return data_len(data)

    def has(self, key: str) -> bool:
        try:
            self._call("head", key,
                       lambda: self.service.head(
                           key, timeout=self.policy.timeout))
            return True
        except FileNotFoundError:
            return False
        except OSError:
            # a dedup probe must not crash a save over a remote blip
            self._bump("remote_soft_fails")
            return False

    def size(self, key: str) -> int:
        return self._call("head", key,
                          lambda: self.service.head(
                              key, timeout=self.policy.timeout))

    def delete(self, key: str) -> int:
        try:
            return self._call("delete", key,
                              lambda: self.service.delete(
                                  key, timeout=self.policy.timeout))
        except OSError:
            # a later GC round sweeps the orphan
            self._bump("remote_soft_fails")
            return 0

    def keys(self) -> Iterator[str]:
        try:
            ks = self._call("list", "*",
                            lambda: self.service.list_keys(
                                timeout=self.policy.timeout))
        except OSError:
            self._bump("remote_soft_fails")
            return iter(())
        return iter(ks)

    # ---- maintenance / introspection ----
    def sweep_tmp(self) -> int:
        try:
            return self.service.sweep_uploads()
        except OSError:
            return 0

    def close(self) -> None:
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    def durable_tier(self) -> str:
        return "remote"

    def durability(self) -> Dict[str, object]:
        return {"durable_tier": "remote", "pending_spill": 0,
                "durable_on": "remote"}

    def tier_stats(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self._stats)
        out["remote_breaker_state"] = self.breaker.state
        for verb, n in self.service.ops.items():
            out[f"remote_op_{verb}"] = n
        return out

    def path_of(self, key: str) -> Optional[Path]:
        # a remote tier has no local path (``service.blob_path`` has)
        return None
