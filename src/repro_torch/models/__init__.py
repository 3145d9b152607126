from repro_torch.models.model_api import (  # noqa: F401
    BaseLM,
    LayerUnit,
    TensorSpec,
    build_model,
)
