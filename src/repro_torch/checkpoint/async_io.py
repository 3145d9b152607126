"""Background transfer executor, staging slots and the process IO workers
of the port (the JAX package's ``checkpoint/async_io.py``).

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

Two worker backends sit under the lanes (``TransferPool(worker_backend=)``,
the JAX package's): ``"thread"`` runs every task on the pool's threads;
``"process"`` keeps the threads as coordinators and sends the hot byte
work they run (chunk framing with its crc32s, XD01 and BD02 deltas, object
decode and its checks, atomic file writes) through :class:`IoDispatch` to
a :class:`ProcessWorkerPool` of subprocess workers.  A worker is a fresh
interpreter (``subprocess.Popen``, never a fork of a process that holds
CUDA) that imports ``repro_torch.checkpoint.workers``, which imports the
standard library and numpy alone, never torch and never jax.  Only
builtins cross its pipe: buffers of ``SHM_MIN_BYTES`` or more travel
through ``/dev/shm``, an ``Int8Record`` as a tuple.  The parent leases
segments from a free-list arena (:class:`_ShmArena`): an argument already
in a lease (an object the restore read into one) is passed by name and
offset, any other is copied once into a new lease; the worker maps the
segments read-only, and a result buffer that is a view of one (a
record's bytes in a decoded object, a framed chunk's data) comes back by
reference, as a view of the parent's lease, which that view keeps
checked out.  Other results are written into the worker's scratch file
and read back into a buffer of the caller's allocator.  Per lane, the
bytes copied through ``/dev/shm`` (``bytes_shm``), the parent's time
copying them (``shm_seconds``) and the bytes passed by reference
(``bytes_shared``) are counted.  A worker that dies fails its task with
:class:`AsyncWriteError` on the caller (and so on its lane's ``drain()``)
and is respawned; a pool whose workers cannot start raises.  Segment and
scratch names are ``repro-io-<owner pid:x>-...``, so a pool's start sweeps
what dead owners left (:func:`sweep_dead_owner_shm`).
"""
from __future__ import annotations

import collections
import glob
import mmap
import os
import pickle
import queue
import re
import subprocess
import sys
import threading
import time
import weakref
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack
from repro_torch.checkpoint import workers as _workers
from repro_torch.checkpoint.faults import crash_point

_SENTINEL = object()

# Buffers at least this long cross to a worker through shared memory;
# shorter ones ride the pickle pipe.
SHM_MIN_BYTES = 32 * 1024

WORKER_BACKENDS = ("thread", "process")
_MAP_POPULATE = getattr(mmap, "MAP_POPULATE", 0)


class AsyncWriteError(RuntimeError):
    pass


class WorkerError(RuntimeError):
    """A task's failure as a worker reports it: ``kind`` is "corrupt",
    "codec", "missing" or "error"; :class:`IoDispatch` raises the
    exception the inline path would have raised instead."""

    def __init__(self, kind: str, message: str, tb: str = ""):
        super().__init__(message)
        self.kind = kind
        self.worker_traceback = tb


def _map_worker_error(e: WorkerError) -> BaseException:
    if e.kind == "corrupt":
        return _workers.CorruptObject(str(e))
    if e.kind == "codec":
        return _workers.CodecUnavailable(str(e))
    if e.kind == "missing":
        return FileNotFoundError(str(e))
    return AsyncWriteError(f"io worker task failed: {e}")


# The lane of the task the current pool thread runs: a dispatch call deep
# in store code counts its worker traffic there.
_ACTIVE_LANE = threading.local()


def current_lane(default: Optional[str] = None) -> Optional[str]:
    return getattr(_ACTIVE_LANE, "lane", None) or default


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


def _buffer_parts(obj) -> Optional[List[memoryview]]:
    """The byte pieces of a buffer-like argument (a ``Blob`` part by
    part), or None for any other value."""
    if isinstance(obj, _msgpack.Blob):
        return obj.parts
    if isinstance(obj, (bytes, bytearray, memoryview, np.ndarray)):
        return [memoryview(obj).cast("B")]
    return None


def _address(buf: memoryview) -> int:
    """Start address of a (non-empty) buffer."""
    return np.frombuffer(buf, np.uint8).ctypes.data


class _ShmArena:
    """Parent-owned ``/dev/shm`` segments (files ``<prefix>-<n>``) in
    power-of-two size classes, handed out as *leases*: ``lease(n)`` maps a
    free segment (a new one if none fits) and returns an ``n``-byte uint8
    array over the map.  The lease lasts as long as any view of it (an
    array slice, a memoryview, a tensor): when the last goes the map is
    collected and the segment is free again, its tmpfs pages kept for the
    next lease.  ``find`` tells whether a buffer lies in a live lease, so
    the pool passes such a buffer to a worker by name and offset instead
    of copying it.  ``close`` unlinks every file; workers map the files
    read-only and never attach, so no other process can unlink one."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        self._lock = threading.Lock()
        self._free: Dict[int, List[str]] = {}
        self._files: Dict[str, Tuple[int, int]] = {}    # name -> (fd, size)
        # lease id -> (start address, end address, name, map)
        self._live: Dict[int, Tuple[int, int, str, Any]] = {}
        # (lease id, name, size) of leases whose map was collected; a map
        # may be collected in any thread (the cycle collector's included),
        # so its finalizer only appends here and the next call under the
        # lock returns the segment to the free list
        self._done: "collections.deque" = collections.deque()
        self._seq = 0           # segment files made
        self._leases = 0        # leases handed out
        self._closed = False

    def _reap(self) -> None:
        """Free the segments of collected leases (caller holds the lock)."""
        while self._done:
            lid, name, size = self._done.popleft()
            self._live.pop(lid, None)
            if not self._closed:
                self._free.setdefault(size, []).append(name)

    @staticmethod
    def _size_class(n: int) -> int:
        return max(SHM_MIN_BYTES, 1 << max(1, n - 1).bit_length())

    def lease(self, n: int) -> np.ndarray:
        return self._lease(n)[1]

    def _lease(self, n: int) -> Tuple[str, np.ndarray]:
        size = self._size_class(int(n))
        with self._lock:
            if self._closed:
                raise AsyncWriteError("shared-memory arena is closed")
            self._reap()
            bucket = self._free.get(size)
            if bucket:
                name = bucket.pop()
                fd = self._files[name][0]
            else:
                self._seq += 1
                name = f"{self.prefix}-{self._seq:x}"
                fd = os.open(os.path.join(_workers.SHM_DIR, name),
                             os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
                os.ftruncate(fd, size)
                self._files[name] = (fd, size)
        # the pages the lease uses, their tables set up in one pass
        # (MAP_POPULATE), not a fault per page
        length = -(-max(1, int(n)) // mmap.PAGESIZE) * mmap.PAGESIZE
        m = mmap.mmap(fd, length, flags=mmap.MAP_SHARED | _MAP_POPULATE,
                      prot=mmap.PROT_READ | mmap.PROT_WRITE)
        arr = np.frombuffer(m, np.uint8, count=int(n))
        start = _address(memoryview(m))
        with self._lock:
            self._leases += 1
            lid = self._leases
            self._live[lid] = (start, start + length, name, weakref.ref(m))
        weakref.finalize(m, self._done.append, (lid, name, size))
        return name, arr

    def put(self, parts: List[memoryview]) -> Tuple[str, np.ndarray]:
        """(segment name, a lease holding ``parts`` back to back)."""
        name, arr = self._lease(sum(p.nbytes for p in parts))
        off = 0
        for p in parts:
            arr[off:off + p.nbytes] = np.frombuffer(p, np.uint8)
            off += p.nbytes
        return name, arr

    def find(self, buf: memoryview) -> Optional[Tuple[str, int, Any]]:
        """``(segment name, offset, the lease's map)`` of a buffer lying in
        a live lease, else None."""
        addr = _address(buf)
        with self._lock:
            self._reap()
            for start, end, name, ref in self._live.values():
                if start <= addr and addr + buf.nbytes <= end:
                    m = ref()       # None: collected, not reaped yet
                    if m is not None:
                        return name, addr - start, m
        return None

    def segment_names(self) -> List[str]:
        with self._lock:
            self._reap()
            return sorted(self._files)

    def close(self) -> None:
        """Unlink every segment (a live lease keeps its pages until its map
        is collected)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            files = list(self._files.items())
            self._files.clear()
            self._free.clear()
        for name, (fd, _) in files:
            os.close(fd)
            try:
                os.unlink(os.path.join(_workers.SHM_DIR, name))
            except FileNotFoundError:  # pragma: no cover - already gone
                pass


# -c bootstrap of a worker: put the port's source root on the path and run
# ``repro_torch.checkpoint.workers``; neither package ``__init__`` on the
# way imports anything, so the worker holds the stdlib and numpy alone.
_BOOTSTRAP = (
    "import sys\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "from repro_torch.checkpoint import workers\n"
    "sys.exit(workers.worker_main())\n"
)
_SRC_ROOT = str(Path(__file__).resolve().parents[2])


class _Worker:
    """One subprocess worker: a pickle pipe pair plus its persistent
    ``/dev/shm`` scratch file, into which it writes the large buffers of
    its results."""

    def __init__(self, scratch_name: str):
        self.scratch_name = scratch_name
        self._scratch_fd: Optional[int] = None
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _BOOTSTRAP, _SRC_ROOT],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE)

    @property
    def pid(self) -> int:
        return self.proc.pid

    def wait_ready(self) -> None:
        """The worker's start-up announcement; raises ``OSError`` if it
        exited instead."""
        try:
            msg = pickle.load(self.proc.stdout)
        except (EOFError, pickle.UnpicklingError) as e:
            self.proc.wait()
            raise OSError(f"io worker pid {self.pid} exited "
                          f"{self.proc.returncode} at start-up") from e
        if not (isinstance(msg, tuple) and msg[0] == "ready"):
            raise OSError(f"io worker pid {self.pid} said {msg!r} at "
                          "start-up")

    def read_scratch(self, offset: int, length: int, buf) -> None:
        """Bytes ``[offset, offset + length)`` of the scratch file into
        ``buf`` (a writable buffer of ``length`` bytes)."""
        if self._scratch_fd is None:
            self._scratch_fd = os.open(
                os.path.join(_workers.SHM_DIR, self.scratch_name),
                os.O_RDONLY)
        mv = memoryview(buf).cast("B")
        got = 0
        while got < length:
            k = os.preadv(self._scratch_fd, [mv[got:]], offset + got)
            if k <= 0:
                raise OSError(f"short read of {self.scratch_name}")
            got += k

    def close_scratch(self) -> None:
        if self._scratch_fd is not None:
            os.close(self._scratch_fd)
            self._scratch_fd = None
        try:
            os.unlink(os.path.join(_workers.SHM_DIR, self.scratch_name))
        except OSError:
            pass

    def call(self, fn_id: str, args: tuple,
             spec: Tuple[str, int]) -> Any:
        pickle.dump((fn_id, args, spec), self.proc.stdin,
                    protocol=pickle.HIGHEST_PROTOCOL)
        self.proc.stdin.flush()
        return pickle.load(self.proc.stdout)

    def shutdown(self, timeout: float = 5.0) -> None:
        try:
            if self.proc.stdin and not self.proc.stdin.closed:
                self.proc.stdin.close()  # EOF: the loop returns
        except OSError:  # pragma: no cover - already a broken pipe
            pass
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:  # pragma: no cover - stuck task
            self.proc.kill()
            self.proc.wait(timeout=timeout)
        if self.proc.stdout:
            self.proc.stdout.close()
        self.close_scratch()


# Every /dev/shm file this module and the JAX package create is named
# repro-io-<creator pid hex>-...
_SHM_OWNER_RE = re.compile(r"^repro-io-([0-9a-f]+)-")


def sweep_dead_owner_shm() -> List[str]:
    """Unlink ``/dev/shm`` files ``repro-io-<pid>-*`` whose creator pid is
    no longer alive (a killed trainer cannot unlink its own); a live pid's
    files, our own included, are left alone.  Returns the names removed."""
    try:
        names = os.listdir(_workers.SHM_DIR)
    except OSError:  # pragma: no cover - no tmpfs on this host
        return []
    removed: List[str] = []
    for name in names:
        m = _SHM_OWNER_RE.match(name)
        if not m:
            continue
        pid = int(m.group(1), 16)
        if pid == os.getpid():
            continue
        try:
            os.kill(pid, 0)
            continue
        except ProcessLookupError:
            pass
        except PermissionError:  # pragma: no cover - another user's pid
            continue
        try:
            os.unlink(os.path.join(_workers.SHM_DIR, name))
            removed.append(name)
        except OSError:  # pragma: no cover - raced another sweeper
            pass
    return removed


class ProcessWorkerPool:
    """Fixed-size pool of subprocess workers behind the pickle + shared
    memory protocol.

    ``call(fn_id, *args)`` checks an idle worker out, copies the large
    buffers of ``args`` into arena segments, waits for the answer, reads
    the result's large buffers back out of the worker's scratch file (into
    ``alloc(n)`` buffers when given), and returns the worker.  A worker
    that dies mid-task fails that task with :class:`AsyncWriteError` and
    is replaced at once; it never hangs another caller.  Workers that
    cannot start raise from the constructor (or from the respawn)."""

    def __init__(self, num_workers: int = 2, *,
                 shm_min_bytes: int = SHM_MIN_BYTES):
        sweep_dead_owner_shm()
        self.num_workers = max(1, int(num_workers))
        self.shm_min_bytes = int(shm_min_bytes)
        self.arena = _ShmArena(
            f"repro-io-{os.getpid():x}-{id(self) & 0xFFFFFF:x}")
        self._idle: "queue.Queue[_Worker]" = queue.Queue()
        self._lock = threading.Lock()
        self._open = True
        self._procs: List[_Worker] = []
        self.worker_restarts = 0
        self._broken: Optional[BaseException] = None
        self._sseq = 0
        self._lane_stats: Dict[str, Dict[str, Any]] = {}
        started = [self._start() for _ in range(self.num_workers)]
        try:
            for w in started:
                w.wait_ready()
        except OSError as e:
            self.close()
            raise AsyncWriteError(f"io workers failed to start: {e}") from e
        for w in started:
            self._idle.put(w)

    def _start(self) -> _Worker:
        with self._lock:
            self._sseq += 1
            scratch = f"{self.arena.prefix}-s{self._sseq:x}"
        w = _Worker(scratch)
        with self._lock:
            self._procs.append(w)
        return w

    def worker_pids(self) -> List[int]:
        with self._lock:
            return [w.pid for w in self._procs if w.proc.poll() is None]

    def _marshal_buffer(self, parts: List[memoryview], leases: Dict,
                        counted: Dict) -> Any:
        """One buffer (a ``Blob`` part, or a buffer argument) for the
        pipe: short ones inline, one lying in a live lease by reference
        (no copy), any other copied into a new lease."""
        n = sum(p.nbytes for p in parts)
        if n < self.shm_min_bytes:
            return b"".join(parts)
        if len(parts) == 1:
            hit = self.arena.find(parts[0])
            if hit is not None:
                name, off, m = hit
                leases[name] = m            # held until the call ends
                counted["bytes_shared"] += n
                return (_workers.SHM_MARK, name, n, off)
        t0 = time.perf_counter()
        name, arr = self.arena.put(parts)
        leases[name] = arr
        counted["shm_seconds"] += time.perf_counter() - t0
        counted["bytes_shm"] += n
        return (_workers.SHM_MARK, name, n, 0)

    def _marshal(self, obj: Any, leases: Dict, counted: Dict) -> Any:
        """Arguments for the pipe: buffers through shared memory, a
        ``Blob`` part by part, an ``Int8Record`` as a tuple."""
        if isinstance(obj, _msgpack.Blob):
            return (_workers.BLOB_MARK,
                    [self._marshal_buffer([p], leases, counted)
                     for p in obj.parts])
        parts = _buffer_parts(obj)
        if parts is not None:
            return self._marshal_buffer(parts, leases, counted)
        if isinstance(obj, _workers.Int8Record):
            return (_workers.INT8_MARK,
                    self._marshal(obj.data, leases, counted), int(obj.n_q),
                    int(obj.n_scale), list(obj.shape), obj.dtype)
        if isinstance(obj, tuple):
            return tuple(self._marshal(v, leases, counted) for v in obj)
        if isinstance(obj, list):
            return [self._marshal(v, leases, counted) for v in obj]
        if isinstance(obj, dict):
            return {k: self._marshal(v, leases, counted)
                    for k, v in obj.items()}
        return obj

    def _unstage(self, obj: Any, w: _Worker, leases: Dict, counted: Dict,
                 alloc) -> Any:
        """A result's markers back to buffers: a segment reference to a
        view of the argument's lease (which the view keeps alive), a
        scratch range read out of the worker's scratch file (before the
        worker takes its next task) into an ``alloc(n)`` buffer; blob and
        int8 tuples back to ``Blob`` s and ``Int8Record`` s."""
        if isinstance(obj, tuple) and obj:
            tag = obj[0]
            if tag == _workers.SEG_MARK:
                _, name, off, n = obj
                counted["bytes_shared"] += n
                return memoryview(leases[name]).cast("B")[off:off + n]
            if (tag == _workers.SHM_MARK and len(obj) == 3
                    and isinstance(obj[1], int)):
                t0 = time.perf_counter()
                buf = alloc(obj[2]) if alloc is not None \
                    else bytearray(obj[2])
                w.read_scratch(obj[1], obj[2], buf)
                counted["shm_seconds"] += time.perf_counter() - t0
                counted["bytes_shm"] += obj[2]
                return memoryview(buf).cast("B")
            if tag == _workers.BLOB_MARK:
                return _msgpack.Blob([self._unstage(p, w, leases, counted,
                                                    alloc)
                                      for p in obj[1]])
            if tag == _workers.INT8_MARK:
                return _workers.Int8Record(
                    self._unstage(obj[1], w, leases, counted, alloc),
                    obj[2], obj[3], tuple(obj[4]), obj[5])
        if isinstance(obj, tuple):
            return tuple(self._unstage(v, w, leases, counted, alloc)
                         for v in obj)
        if isinstance(obj, list):
            return [self._unstage(v, w, leases, counted, alloc)
                    for v in obj]
        if isinstance(obj, dict):
            return {k: self._unstage(v, w, leases, counted, alloc)
                    for k, v in obj.items()}
        return obj

    def _checkout(self) -> _Worker:
        """An idle worker; raises once the pool is closed or has lost a
        worker it could not replace, instead of waiting forever."""
        while True:
            try:
                return self._idle.get(timeout=0.5)
            except queue.Empty:
                with self._lock:
                    if not self._open or self._broken is not None:
                        raise AsyncWriteError(
                            "io worker pool is closed or lost a worker: "
                            f"{self._broken!r}")

    def _replace(self, w: _Worker) -> None:
        """Retire a dead worker and start its replacement."""
        with self._lock:
            self.worker_restarts += 1
            try:
                self._procs.remove(w)
            except ValueError:  # pragma: no cover
                pass
            reopen = self._open
        try:
            w.proc.kill()
        except OSError:  # pragma: no cover - already reaped
            pass
        w.proc.wait()
        w.close_scratch()
        if reopen:
            try:
                nw = self._start()
                nw.wait_ready()
            except OSError as e:
                with self._lock:
                    self._broken = e
                raise AsyncWriteError(
                    f"io worker could not be replaced: {e}") from e
            self._idle.put(nw)

    def lease(self, n: int) -> np.ndarray:
        """An ``n``-byte buffer in shared memory: a read into it (an object
        the restore sends to a worker) passes to the worker by reference."""
        return self.arena.lease(n)

    def call(self, fn_id: str, *args, lane: Optional[str] = None,
             alloc: Optional[Callable[[int], Any]] = None) -> Any:
        lane = lane or current_lane("io")
        # segment name -> the lease its buffer lies in, held for the call
        leases: Dict[str, Any] = {}
        counted = {"bytes_shm": 0, "shm_seconds": 0.0, "bytes_shared": 0}
        try:
            marshalled = self._marshal(args, leases, counted)
            w = self._checkout()
            try:
                if w.proc.poll() is not None:
                    raise OSError(f"worker pid {w.pid} exited "
                                  f"{w.proc.returncode}")
                resp = w.call(fn_id, marshalled,
                              (w.scratch_name, self.shm_min_bytes))
            except (EOFError, OSError, pickle.UnpicklingError) as e:
                self._replace(w)
                raise AsyncWriteError(
                    f"io worker pid {w.pid} died running {fn_id!r}: "
                    f"{e!r}") from e
            try:
                if isinstance(resp, tuple) and resp and resp[0] == "ok":
                    resp = ("ok", self._unstage(resp[1], w, leases,
                                                counted, alloc))
            finally:
                self._idle.put(w)
        finally:
            leases.clear()
            with self._lock:
                st = self._lane_stats.setdefault(lane, dict(
                    {k: 0 for k in counted}, tasks=0))
                st["tasks"] += 1
                for k, v in counted.items():
                    st[k] += v
        if isinstance(resp, tuple) and resp and resp[0] == "ok":
            return resp[1]
        if isinstance(resp, tuple) and len(resp) == 4 and resp[0] == "err":
            raise WorkerError(resp[1], resp[2], resp[3])
        raise AsyncWriteError(
            f"malformed response from io worker for {fn_id!r}: {resp!r}")

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"workers": len(self._procs),
                    "worker_restarts": self.worker_restarts,
                    "lanes": {lane: dict(st)
                              for lane, st in self._lane_stats.items()}}

    def close(self) -> None:
        with self._lock:
            if not self._open:
                return
            self._open = False
            procs = list(self._procs)
            self._procs.clear()
        for w in procs:
            w.shutdown()
        self.arena.close()
        # a worker killed between writing a result and the parent reading
        # it leaves its scratch under the arena's prefix
        for path in glob.glob(os.path.join(_workers.SHM_DIR,
                                           self.arena.prefix + "-*")):
            try:
                os.unlink(path)
            except OSError:  # pragma: no cover - already gone
                pass


class IoDispatch:
    """Runs the hot byte tasks (``workers.WORKER_FNS``) inline or in a
    :class:`ProcessWorkerPool`: the one seam the store, the backends and
    the restore call.  With no pool a task runs in this process (the same
    code); with one, a worker's error kinds come back as the exceptions
    the inline path raises (``CorruptObject`` alias ``ChunkCorruption``,
    ``CodecUnavailable``, ``FileNotFoundError``)."""

    def __init__(self, pool: Optional[ProcessWorkerPool] = None):
        self.pool = pool

    @property
    def is_process(self) -> bool:
        return self.pool is not None

    @property
    def backend(self) -> str:
        return "process" if self.pool is not None else "thread"

    def call(self, fn_id: str, *args, lane: Optional[str] = None,
             alloc: Optional[Callable[[int], Any]] = None) -> Any:
        """Run task ``fn_id``; ``alloc(n)`` gives the buffers a worker's
        large result buffers are read into (a bytearray by default)."""
        if self.pool is None:
            return _workers.run(fn_id, *args)
        try:
            return self.pool.call(fn_id, *args, lane=lane, alloc=alloc)
        except WorkerError as e:
            raise _map_worker_error(e) from e

    def stats(self) -> Optional[Dict[str, Any]]:
        return None if self.pool is None else self.pool.stats()

    def buffer_alloc(self) -> Optional[Callable[[int], Any]]:
        """Where to read bytes bound for a worker: shared-memory leases on
        the process backend (passed to the worker by reference), None
        (the caller's default) inline."""
        return None if self.pool is None else self.pool.lease


#: The inline dispatch every store and backend uses unless a process
#: backed pool hands it another.
INLINE_DISPATCH = IoDispatch()


def lane_delta(before: Optional[Dict[str, Any]],
               after: Optional[Dict[str, Any]],
               lane: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """What a pool's workers did between two ``IoDispatch.stats()``
    snapshots: ``{"tasks", "bytes_shm", "shm_seconds", "bytes_shared",
    "worker_restarts"}`` of ``lane``, or ``{"lanes": {lane: ...},
    "worker_restarts"}`` of every lane that ran a task (None under the
    thread backend).  ``bytes_shm`` are the bytes copied through
    ``/dev/shm`` (into a segment, or out of a worker's scratch file),
    ``shm_seconds`` this process's time copying them, ``bytes_shared``
    the bytes a worker was handed, or handed back, by reference."""
    if before is None or after is None:
        return None
    zero = {"tasks": 0, "bytes_shm": 0, "shm_seconds": 0.0,
            "bytes_shared": 0}

    def diff(name: str) -> Dict[str, Any]:
        b = before["lanes"].get(name, zero)
        a = after["lanes"].get(name, zero)
        return {k: a[k] - b[k] for k in zero}

    if lane is not None:
        return dict(diff(lane), worker_restarts=after["worker_restarts"])
    lanes = {name: d for name in after["lanes"]
             for d in [diff(name)] if d["tasks"]}
    return {"lanes": lanes, "worker_restarts": after["worker_restarts"]}


class _LaneState:
    """Per-lane accounting, guarded by ``TransferPool._cond``."""
    __slots__ = ("outstanding", "errors", "tasks")

    def __init__(self) -> None:
        self.outstanding = 0
        self.errors: List[BaseException] = []
        self.tasks = 0


class TransferPool:
    """Bounded thread pool with per-lane accounting.

    ``submit(lane, fn, ...)`` enqueues work; ``drain(lane)`` blocks until
    that lane's outstanding count is zero and raises its collected errors.
    Each task fires the crash point ``pool:<lane>`` before it runs.
    ``worker_backend="process"`` attaches a :class:`ProcessWorkerPool` of
    ``io_workers`` workers (``max(2, num_threads)`` by default), exposed
    through ``self.dispatch``; the threads then coordinate while the byte
    work runs in the workers."""

    def __init__(self, num_threads: int = 2, max_queue: int = 0, *,
                 worker_backend: str = "thread",
                 io_workers: Optional[int] = None,
                 shm_min_bytes: int = SHM_MIN_BYTES):
        if worker_backend not in WORKER_BACKENDS:
            raise ValueError(f"worker_backend must be one of "
                             f"{WORKER_BACKENDS}, got {worker_backend!r}")
        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._cond = threading.Condition()
        self._open = True
        self._lanes: Dict[str, _LaneState] = {}
        self.worker_backend = worker_backend
        self.workers: Optional[ProcessWorkerPool] = None
        if worker_backend == "process":
            self.workers = ProcessWorkerPool(
                io_workers if io_workers else max(2, num_threads),
                shm_min_bytes=shm_min_bytes)
        self.dispatch = IoDispatch(self.workers)
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
                _ACTIVE_LANE.lane = lane
                try:
                    crash_point(f"pool:{lane}")
                    pending._value = fn(*args, **kwargs)
                except BaseException as e:  # noqa: BLE001
                    pending._error = e
                    with self._cond:
                        self._lane(lane).errors.append(e)
                finally:
                    _ACTIVE_LANE.lane = None
                    pending._event.set()
                    with self._cond:
                        st = self._lane(lane)
                        st.outstanding -= 1
                        st.tasks += 1
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

    def submit_task(self, lane: str, fn_id: str, *args) -> PendingResult:
        """Submit a worker task (``workers.WORKER_FNS``) on a lane: run in
        a subprocess under the process backend, on the pool thread
        otherwise."""
        return self.submit(lane, self.dispatch.call, fn_id, *args)

    def outstanding(self, lane: str) -> int:
        with self._cond:
            st = self._lanes.get(lane)
            return st.outstanding if st is not None else 0

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

    def lane_stats(self) -> Dict[str, Dict[str, int]]:
        with self._cond:
            return {name: {"tasks": st.tasks, "outstanding": st.outstanding}
                    for name, st in self._lanes.items()}

    def stats(self) -> Dict[str, Any]:
        """``{backend, worker_restarts, bytes_shm, lanes: {lane: {tasks,
        outstanding[, worker_tasks, bytes_shm, shm_seconds,
        bytes_shared]}}}`` (see ``lane_delta``)."""
        out: Dict[str, Any] = {"backend": self.worker_backend,
                               "worker_restarts": 0, "bytes_shm": 0,
                               "lanes": self.lane_stats()}
        if self.workers is not None:
            ws = self.workers.stats()
            out["worker_restarts"] = ws["worker_restarts"]
            for lane, st in ws["lanes"].items():
                d = out["lanes"].setdefault(lane, {"tasks": 0,
                                                   "outstanding": 0})
                d["worker_tasks"] = st["tasks"]
                for k in ("bytes_shm", "shm_seconds", "bytes_shared"):
                    d[k] = st[k]
                out["bytes_shm"] += st["bytes_shm"]
        return out

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
        if self.workers is not None:
            self.workers.close()


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


__all__ = ["INLINE_DISPATCH", "SHM_MIN_BYTES", "WORKER_BACKENDS",
           "AsyncWriteError", "AsyncWriter", "IoDispatch", "PendingResult",
           "ProcessWorkerPool", "StagingArena", "StagingSlot",
           "TransferPool", "WorkerError", "current_lane", "lane_delta",
           "sweep_dead_owner_shm"]
