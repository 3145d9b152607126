from repro_torch.kernels.quantize.ops import (  # noqa: F401
    DEQUANTIZE,
    MAX_LEAVES,
    QUANTIZE,
    QuantizedUnit,
    dequantize,
    dequantize_unit,
    quantize,
    quantize_unit,
    record_nbytes,
)
from repro_torch.kernels.quantize.ref import (  # noqa: F401
    QUANT_BLOCK,
    dequantize_plain,
    n_quant_blocks,
    quantize_plain,
)
