"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention blocks.

54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000, ssm_state=64.  A single
*shared-weight* transformer block is invoked every ``shared_period`` Mamba2
layers (Zamba2's shared attention; per-invocation LoRA deltas are omitted,
as in the JAX package).  [arXiv:2411.15242; hf]
"""
from repro_torch.configs.base import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    rope_theta=10_000.0,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_kernel=4,
                  chunk_size=256),
    hybrid=HybridConfig(shared_period=6, shared_d_ff=10240),
    source="arXiv:2411.15242; hf",
)
