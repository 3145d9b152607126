"""Deterministic synthetic LM data (numpy), as in the JAX package."""
from repro_torch.data.synthetic import DataState, SyntheticTokens  # noqa: F401
