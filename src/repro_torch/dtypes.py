"""Dtype names and byte views shared by the port's layers.

Checkpoint tables, envelopes and manifests name dtypes in numpy form
(``"bfloat16"``, ``"float32"``): the fingerprint table hashes that string,
so the port writes exactly the names the JAX package writes, never
``str(torch.bfloat16)``.  bf16 crosses to the host as raw bytes (a uint8
view), so the host side needs no bf16-aware numpy.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_NAMES: Dict[torch.dtype, str] = {
    torch.float32: "float32",
    torch.bfloat16: "bfloat16",
    torch.float16: "float16",
    torch.float64: "float64",
    torch.int64: "int64",
    torch.int32: "int32",
    torch.int16: "int16",
    torch.int8: "int8",
    torch.uint8: "uint8",
    torch.bool: "bool",
}
_BY_NAME = {v: k for k, v in _NAMES.items()}


def dtype_name(dtype: torch.dtype) -> str:
    try:
        return _NAMES[dtype]
    except KeyError:
        raise TypeError(f"dtype {dtype} has no checkpoint name") from None


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _BY_NAME[name]
    except KeyError:
        raise TypeError(f"unknown checkpoint dtype {name!r}") from None


def byte_view(x: torch.Tensor) -> torch.Tensor:
    """Flat uint8 view (detached) of a contiguous tensor's little-endian
    bytes."""
    if not x.is_contiguous():
        raise ValueError("byte_view needs a contiguous tensor")
    return x.detach().reshape(-1).view(torch.uint8)


def from_bytes(raw, shape, name: str) -> torch.Tensor:
    """CPU tensor of dtype ``name`` over the bytes in ``raw`` (a writable
    buffer is shared; a read-only one is copied)."""
    mv = memoryview(raw).cast("B")
    arr = np.frombuffer(mv, np.uint8)
    if mv.readonly:
        arr = arr.copy()
    return torch.from_numpy(arr).view(torch_dtype(name)).reshape(
        tuple(shape))
