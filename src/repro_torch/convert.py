"""Byte-exact conversion between the JAX package's train state (numpy
arrays, bf16 included) and the port's (torch tensors).

bf16 crosses as raw 16-bit words, so no bf16-aware numpy is needed here;
``state_to_numpy`` returns bf16 leaves as uint16 words unless the caller
passes a numpy bfloat16 dtype to view them as.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.devices import resolve_device

PyTree = Any


def _to_torch(arr, device: torch.device) -> torch.Tensor:
    a = np.array(arr, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _to_numpy(t: torch.Tensor, bf16_dtype) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        words = t.view(torch.uint16).numpy().copy()
        return words if bf16_dtype is None else words.view(bf16_dtype)
    return t.numpy().copy()


def state_from_numpy(tree: PyTree, device=None) -> PyTree:
    """Nested dict of numpy arrays -> the same tree of tensors on
    ``device`` (the card by default, see ``resolve_device``)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: state_from_numpy(v, dev) for k, v in tree.items()}
    return _to_torch(tree, dev)


def state_to_numpy(state: PyTree, bf16_dtype: Optional[Any] = None
                   ) -> PyTree:
    """Tree of tensors -> the same tree of numpy arrays, byte for byte."""
    if isinstance(state, dict):
        return {k: state_to_numpy(v, bf16_dtype) for k, v in state.items()}
    return _to_numpy(state, bf16_dtype)
