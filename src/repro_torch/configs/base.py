"""Config system of the port: frozen dataclasses with the JAX package's
fields and defaults.

One ``ModelConfig`` per architecture lives in
``repro_torch/configs/<arch>.py``.
Reduced ("smoke") variants come from ``ModelConfig.reduced()``, which is
the JAX package's rule unchanged, so CPU tests of both packages build the
same shapes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration."""

    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_dense_residual: int = 0
    first_k_dense: int = 0
    d_ff_first_dense: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2)."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD configuration."""

    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    chunk_size: int = 256
    ngroups: int = 1


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    shared_period: int = 6
    shared_d_ff: int = 0


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    num_encoder_layers: int = 12
    num_decoder_layers: int = 12


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    num_patches: int = 2880
    patch_embed_dim: int = 1024


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // num_heads
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    attn_chunk_size: int = 1024
    remat: str = "full"  # "none" | "full" | "dots"
    source: str = ""

    def __post_init__(self) -> None:
        if self.family not in FAMILIES:
            raise ValueError(f"{self.name}: unknown family {self.family!r}")
        if self.family in ("dense", "moe", "vlm", "encdec", "hybrid"):
            if self.num_heads <= 0:
                raise ValueError(f"{self.name}: attention arch needs heads")
            if self.mla is None and self.num_heads % max(self.num_kv_heads,
                                                         1):
                raise ValueError(f"{self.name}: num_heads % num_kv_heads != 0")
        if self.family == "moe" and self.moe is None:
            raise ValueError(f"{self.name}: moe family needs MoEConfig")
        if self.family in ("ssm", "hybrid") and self.ssm is None:
            raise ValueError(f"{self.name}: ssm/hybrid family needs SSMConfig")

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests."""
        upd = dict(
            name=self.name + "-smoke",
            num_layers=min(self.num_layers,
                           4 if self.family != "hybrid" else 6),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) or 2,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
        )
        if self.moe is not None:
            upd["moe"] = dataclasses.replace(
                self.moe,
                num_experts=4,
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=64,
                d_ff_dense_residual=128 if self.moe.d_ff_dense_residual else 0,
                d_ff_first_dense=256 if self.moe.first_k_dense else 0,
                first_k_dense=min(self.moe.first_k_dense, 1),
                capacity_factor=8.0,
            )
        if self.mla is not None:
            upd["mla"] = dataclasses.replace(
                self.mla, kv_lora_rank=64, qk_nope_head_dim=32,
                qk_rope_head_dim=16, v_head_dim=32)
            upd["head_dim"] = 48
        if self.ssm is not None:
            upd["ssm"] = dataclasses.replace(
                self.ssm, state_dim=16, head_dim=16, chunk_size=32)
        if self.hybrid is not None:
            upd["hybrid"] = dataclasses.replace(self.hybrid, shared_period=3)
        if self.encdec is not None:
            upd["encdec"] = EncDecConfig(num_encoder_layers=2,
                                         num_decoder_layers=2)
        if self.vlm is not None:
            upd["vlm"] = VLMConfig(num_patches=16, patch_embed_dim=64)
        return dataclasses.replace(self, **upd)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer / schedule / checkpointing knobs for a training run."""

    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    adam_eps: float = 1e-8
    grad_clip_norm: float = 1.0
    seed: int = 0
    ckpt_interval: int = 100
    ckpt_policy: str = "full"
    ckpt_dir: str = "/tmp/repro_ckpt"
    ckpt_async: bool = True
    ckpt_keep: int = 8
    ckpt_compression: str = "auto"

    def to_json(self):
        return dataclasses.asdict(self)
