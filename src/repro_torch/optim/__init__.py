from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    clip_scale,
    global_norm,
    init_opt_state,
)
from repro_torch.optim.groups import (  # noqa: F401
    GroupSpec,
    ParamGroup,
    build_group_spec,
    decay_mask,
    get_at,
    set_at,
    tree_leaves,
    tree_map,
)
from repro_torch.optim.schedule import warmup_cosine  # noqa: F401
