"""LocalFSBackend — the POSIX object tree, in the JAX package's layout:

    <dir>/ab/abcdef...123.chunk     # two-hex-char fan-out, one file/object

``atomic_write`` is the tmp+rename(+fsync) protocol the manifest store
uses as well.  With a process-backed ``dispatch`` (``io_backend=
"process"``), an object write runs ``workers.file_write_atomic`` in a
subprocess worker, its bytes through shared memory, and its tmp file
named after this (the coordinating) process.
"""
from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import TYPE_CHECKING, Dict, Iterator, Optional

from repro_torch.checkpoint._msgpack import Blob
from repro_torch.checkpoint.backends.base import (Data, StorageBackend,
                                                  data_len, data_parts)

if TYPE_CHECKING:
    from repro_torch.checkpoint.async_io import IoDispatch


def _fsync_dir(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write(path: Path, data: Data, *, fsync: bool = True) -> None:
    """Write ``data`` (one buffer or several, back to back) to a unique tmp
    file and rename it over ``path``."""
    tmp = path.with_suffix(
        path.suffix + f".tmp-{os.getpid():x}-{threading.get_ident():x}")
    tmp.parent.mkdir(parents=True, exist_ok=True)
    with open(tmp, "wb") as f:
        for part in data_parts(data):
            f.write(part)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if fsync:
        _fsync_dir(path.parent)


def read_file_into(path: Path, alloc, start: int = 0,
                   end: Optional[int] = None) -> memoryview:
    """Bytes ``[start, end)`` of ``path`` (to EOF when ``end`` is None)
    read into a buffer from ``alloc(nbytes)``."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        stop = size if end is None else min(end, size)
        n = max(0, stop - start)
        buf = memoryview(alloc(n)).cast("B")
        f.seek(start)
        got = 0
        while got < n:
            k = f.readinto(buf[got:])
            if not k:
                raise OSError(f"short read of {path}")
            got += k
    return buf


class LocalFSBackend(StorageBackend):
    name = "local"

    def __init__(self, root: Path | str, *, fsync: bool = False,
                 dispatch: Optional["IoDispatch"] = None):
        self.root = Path(root)
        # Objects are published by rename without fsync by default (the
        # JAX package's default); the manifest written last is fsynced.
        self.fsync = fsync
        self.dispatch = dispatch
        self._lock = threading.Lock()
        self._stats = {"reads": 0, "writes": 0, "read_bytes": 0,
                       "written_bytes": 0}

    def _path(self, key: str) -> Path:
        return self.root / key[:2] / f"{key}.chunk"

    def read_into(self, key: str, alloc) -> memoryview:
        buf = read_file_into(self._path(key), alloc)
        with self._lock:
            self._stats["reads"] += 1
            self._stats["read_bytes"] += buf.nbytes
        return buf

    def write(self, key: str, data: Data) -> int:
        if self.dispatch is not None and self.dispatch.is_process:
            tag = f"{os.getpid():x}-{threading.get_ident():x}"
            self.dispatch.call("file_write_atomic", str(self._path(key)),
                               Blob(data_parts(data)), self.fsync, tag)
        else:
            atomic_write(self._path(key), data, fsync=self.fsync)
        n = data_len(data)
        with self._lock:
            self._stats["writes"] += 1
            self._stats["written_bytes"] += n
        return n

    def has(self, key: str) -> bool:
        return self._path(key).is_file()

    def size(self, key: str) -> int:
        return self._path(key).stat().st_size

    def delete(self, key: str) -> int:
        p = self._path(key)
        try:
            freed = p.stat().st_size
            p.unlink()
        except FileNotFoundError:
            return 0
        try:
            p.parent.rmdir()  # prune empty fan-out dirs opportunistically
        except OSError:
            pass
        return freed

    def keys(self) -> Iterator[str]:
        if self.root.is_dir():
            for f in sorted(self.root.glob("*/*.chunk")):
                yield f.stem

    def sweep_tmp(self) -> int:
        """Crash-leftover ``*.tmp-*`` files of other processes (a tmp file
        with our own pid may be a live write, e.g. a spill racing GC)."""
        freed = 0
        own = f"{os.getpid():x}-"
        if self.root.is_dir():
            for tmp in self.root.glob("*/*.tmp-*"):
                if tmp.name.rsplit(".tmp-", 1)[-1].startswith(own):
                    continue
                try:
                    freed += tmp.stat().st_size
                    tmp.unlink()
                except FileNotFoundError:
                    continue
        return freed

    def tier_stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._stats)

    def path_of(self, key: str) -> Optional[Path]:
        return self._path(key)
