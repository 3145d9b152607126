from repro_torch.kernels.fused_adamw.ops import (  # noqa: F401
    KERNEL,
    bias_corrections,
    fused_adamw,
    fused_adamw_plain,
)
