"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface and loaded with ``ctypes``.  Libraries live under
``<repo>/build/kernels/`` (listed in ``.gitignore``), named by a hash of the
source and the compiler flags, so a checkout builds them at first use and an
edit of a source rebuilds it.  Several sources build concurrently (one
``nvcc`` each, all started together).  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


class KernelBuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").is_file():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found: the CUDA kernels build only "
                               "on a machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """The library's path, keyed by its source, the shared headers of
    ``csrc/`` and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode() + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


class _Builder:
    """Builds each library at most once per process and keeps the loaded
    handles and the compiler's resource report (saved beside each library,
    so a library built by an earlier process still has it)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._libs: Dict[str, ctypes.CDLL] = {}
        self.logs: Dict[str, str] = {}
        # the libraries this process compiled (a library found built is
        # loaded, not compiled)
        self.compiled: List[str] = []

    def build(self, names: Iterable[str]) -> Dict[str, Path]:
        """Compile every library in ``names`` that is not built yet, all
        concurrently; returns name -> library path."""
        names = list(dict.fromkeys(names))
        paths = {n: library_path(n) for n in names}
        todo = [n for n in names if not paths[n].is_file()]
        for n in names:   # a library built earlier: its compiler report
            log = paths[n].with_suffix(".log")
            if n not in todo and n not in self.logs and log.is_file():
                self.logs[n] = log.read_text()
        if not todo:
            return paths
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        procs = []
        for n in todo:
            tmp = paths[n].with_suffix(f".tmp-{os.getpid()}.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs.append((n, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors: List[str] = []
        for n, tmp, p in procs:
            out, _ = p.communicate()
            self.logs[n] = out.decode(errors="replace")
            if p.returncode != 0:
                errors.append(f"nvcc failed for {n}.cu (exit {p.returncode})"
                              f":\n{self.logs[n]}")
                tmp.unlink(missing_ok=True)
            else:
                paths[n].with_suffix(".log").write_text(self.logs[n])
                os.replace(tmp, paths[n])
                self.compiled.append(n)
        if errors:
            raise KernelBuildError("\n".join(errors))
        return paths

    def load(self, name: str) -> ctypes.CDLL:
        with self._lock:
            lib = self._libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(self.build([name])[name]))
                self._libs[name] = lib
            return lib


BUILDER = _Builder()


class CudaKernel:
    """One C entry point of a kernel library plus its launch count.

    ``launches`` goes up by one for every launch the wrapper makes, and
    nowhere else (under a lock: saves may run on several threads); callers
    may reset it to 0 to count one run."""

    def __init__(self, lib: str, fn: str, argtypes: list):
        self.lib = lib
        self.fn_name = fn
        self.argtypes = argtypes
        self.launches = 0
        self._count_lock = threading.Lock()
        self._fn: Optional[ctypes._CFuncPtr] = None

    def _entry(self):
        if self._fn is None:
            fn = getattr(BUILDER.load(self.lib), self.fn_name)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        err = self._entry()(*args)
        if err != 0:
            raise RuntimeError(f"{self.fn_name} launch failed: cudaError "
                               f"{err}")
        with self._count_lock:
            self.launches += 1


def check_strided_operand(kernel: str, name: str, t) -> None:
    """Raise unless ``t`` is what a kernel reading (B, S, heads, D)
    tensors through their strides takes: the last dim contiguous, the
    start and the first three strides on 16 bytes (its 16-byte loads)."""
    if t.stride(-1) != 1:
        raise ValueError(f"{kernel}: {name}'s last dim must be contiguous")
    size = t.element_size()
    if t.data_ptr() % 16 or any(t.stride(i) * size % 16
                                for i in range(3) if t.shape[i] > 1):
        raise ValueError(f"{kernel}: {name} must start on 16 bytes and keep "
                         "16-byte strides")
