"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512) + fine-grained MoE.

27L d_model=2048 16H d_ff(expert)=1408 vocab=102400, 64 routed experts top-6
+ 2 shared experts, first layer dense.  [arXiv:2405.04434; hf]

The HF config of DeepSeek-V2-Lite has 64 routed experts (160 belongs to
the full V2): 64 routed + 2 shared, top-6, as in the JAX package.
"""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=192,  # qk_nope(128) + qk_rope(64); v_head_dim is 128 (see MLA)
    d_ff=1408,
    vocab_size=102400,
    rope_theta=10_000.0,
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        d_ff_expert=1408,
        num_shared_experts=2,
        first_k_dense=1,
        d_ff_first_dense=10944,
    ),
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=0,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    source="arXiv:2405.04434; hf",
)
