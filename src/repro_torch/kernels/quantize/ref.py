"""Plain PyTorch versions of the blockwise int8 codec's two kernels.

They compute what the JAX package's host codec computes in numpy
(``repro/checkpoint/workers.py``, ``quantize_int8``/``dequantize_int8``)
bit for bit: the input flattened, cast to float32 and zero-padded to a
multiple of 256; per 256-element block ``scale = amax / 127`` by a
division (replaced by 1 where it is 0), ``q = clamp(round(x / scale),
-127, 127)`` with round half to even; dequantized ``float(q) * scale``,
cast to the output dtype (round to nearest even).  Every division is
tensor by tensor: PyTorch may turn a division by a Python scalar into a
multiply by its reciprocal, which is not numpy's arithmetic.  NaN in a
block gives a NaN scale (``amax`` propagates it, as ``np.max`` does).
"""
from __future__ import annotations

from typing import Tuple

import torch

QUANT_BLOCK = 256


def n_quant_blocks(n: int) -> int:
    """Blocks of a leaf of ``n`` elements (the last one zero-padded)."""
    return -(-int(n) // QUANT_BLOCK)


def quantize_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q int8 (nq, 256), scales float32 (nq, 1))`` of ``x`` flattened."""
    flat = x.detach().reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % QUANT_BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.view(-1, QUANT_BLOCK)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    scales = amax / torch.full_like(amax, 127.0)
    scales = torch.where(scales == 0, torch.ones_like(scales), scales)
    q = torch.clamp(torch.round(blocks / scales), -127, 127).to(torch.int8)
    return q, scales


def dequantize_plain(q: torch.Tensor, scales: torch.Tensor, size: int,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """The first ``size`` dequantized elements, flat, in ``out_dtype``."""
    blocks = q.reshape(-1, QUANT_BLOCK).to(torch.float32)
    out = blocks * scales.reshape(-1, 1).to(torch.float32)
    return out.reshape(-1)[:size].to(out_dtype)
