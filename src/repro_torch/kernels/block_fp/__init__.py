from repro_torch.kernels.block_fp.ops import (  # noqa: F401
    KERNEL,
    block_fingerprint,
    fingerprint_plain,
    fingerprint_tree,
    fingerprint_unit,
    gather_blocks,
    leaves_match,
    tree_to_host,
)
from repro_torch.kernels.block_fp.ref import (  # noqa: F401
    DEFAULT_BLOCK_BYTES,
    LeafFP,
    dirty_block_indices,
    fingerprint_bytes,
)
