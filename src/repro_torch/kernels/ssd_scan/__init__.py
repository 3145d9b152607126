from repro_torch.kernels.ssd_scan.ops import (  # noqa: F401
    KERNEL,
    ssd_scan,
)
from repro_torch.kernels.ssd_scan.ref import ssd_scan_plain  # noqa: F401
