from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    KERNEL,
    flash_attention,
)
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    NEG_INF,
    attention_plain,
    softmax_scale,
)
