"""Deterministic synthetic LM data with checkpointable iterator state.

Sequences are noisy repetitions of per-sequence motifs drawn from a small
motif bank, so a model can actually learn (CE drops quickly from ln(V)) and
loss-curve comparisons across resume scenarios are meaningful — the
batch at global step k is a pure function of (seed, k), so an uninterrupted
run and a restored run see byte-identical data, which is what makes the
paper's Table 1 "trajectory overlays" reproducible here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class DataState:
    seed: int
    step: int

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: Dict) -> "DataState":
        return DataState(seed=int(d["seed"]), step=int(d["step"]))


class SyntheticTokens:
    """Iterator over (tokens,) batches; state = (seed, step)."""

    def __init__(self, *, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0, motif_len: int = 16, n_motifs: int = 64,
                 noise: float = 0.05):
        assert vocab_size > 2
        self.vocab_size = vocab_size
        self.batch = batch
        self.seq_len = seq_len
        self.noise = noise
        self.motif_len = motif_len
        self.state = DataState(seed=seed, step=0)
        bank_rng = np.random.RandomState(seed ^ 0x5EED)
        self._motifs = bank_rng.randint(
            0, vocab_size, size=(n_motifs, motif_len), dtype=np.int64)

    def peek(self, step: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Batch for an arbitrary step (pure function; no state change)."""
        step = self.state.step if step is None else step
        rng = np.random.RandomState(
            (self.state.seed * 1_000_003 + step) % (2**31 - 1))
        midx = rng.randint(0, len(self._motifs), size=self.batch)
        reps = -(-self.seq_len // self.motif_len)
        toks = np.tile(self._motifs[midx], (1, reps))[:, :self.seq_len]
        flip = rng.random_sample(toks.shape) < self.noise
        toks = np.where(flip, rng.randint(0, self.vocab_size, toks.shape),
                        toks)
        return {"tokens": toks.astype(np.int32)}

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = self.peek()
        self.state.step += 1
        return batch

    def __iter__(self):
        return self

    # ---- checkpointable state ----
    def state_dict(self) -> Dict:
        return self.state.to_json()

    def load_state(self, d: Dict) -> None:
        self.state = DataState.from_json(d)
