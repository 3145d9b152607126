"""arctic-480b [moe] — dense-residual MoE.

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, 128 experts top-2
running in parallel with a dense residual MLP.
[hf:Snowflake/snowflake-arctic-base; hf]
"""
from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    rope_theta=10_000.0,
    moe=MoEConfig(
        num_experts=128,
        top_k=2,
        d_ff_expert=4864,
        d_ff_dense_residual=4864,  # a dense MLP residual in parallel
    ),
    source="hf:Snowflake/snowflake-arctic-base; hf",
)
