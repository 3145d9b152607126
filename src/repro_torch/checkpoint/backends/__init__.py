"""IO tiers under the content-addressed chunk store.  Only the ``local``
POSIX tree is ported so far."""
from repro_torch.checkpoint.backends.base import StorageBackend  # noqa: F401
from repro_torch.checkpoint.backends.localfs import (  # noqa: F401
    LocalFSBackend,
    atomic_write,
)
