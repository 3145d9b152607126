from repro_torch.kernels.block_gather.ops import (  # noqa: F401
    KERNEL,
    MAX_LEAVES,
    GatherResult,
    gather_dirty,
    gather_dirty_plain,
    gather_tree_dirty,
    round_capacity,
)
from repro_torch.kernels.block_gather.ref import (  # noqa: F401
    gather_dirty_oracle,
)
