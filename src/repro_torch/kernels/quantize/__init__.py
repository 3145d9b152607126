from repro_torch.kernels.quantize.ops import (  # noqa: F401
    DEQUANTIZE,
    MAX_LEAVES,
    QUANTIZE,
    STAGE_BYTES,
    LeafTable,
    QuantizedUnit,
    dequantize,
    dequantize_unit,
    leaf_stages,
    leaf_tables,
    quantize,
    quantize_unit,
    record_nbytes,
    record_rows,
    stage_blocks,
)
from repro_torch.kernels.quantize.ref import (  # noqa: F401
    QUANT_BLOCK,
    dequantize_plain,
    n_quant_blocks,
    quantize_plain,
)
