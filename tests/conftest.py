import os
import sys
from pathlib import Path

# Tests must see the single real CPU device (the 512-device flag is set ONLY
# inside launch/dryrun.py); keep any inherited flag out of the environment.
os.environ.pop("XLA_FLAGS", None)

SRC = Path(__file__).resolve().parent.parent / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long end-to-end trainer/subprocess tests (excluded from the "
        "smoke tier: scripts/check.sh smoke)")
    config.addinivalue_line(
        "markers",
        "process_io: subprocess IO-worker conformance/stress tests "
        "(spawn worker processes and shared-memory segments; see "
        "tests/test_io_workers.py)")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device and nvcc (the port's kernels); skips "
        "without one (see tests/test_torch_cuda.py)")


@pytest.fixture(scope="session", autouse=True)
def shm_clean_guard():
    """/dev/shm hygiene: every ``repro-io-*`` shared-memory segment this
    test process created — worker arena/scratch files (process-backed IO
    lanes), ``-stage-`` staging slots (overlapped saves), and ``-cache-``
    block-cache segments (shm-backed BlockCache, docs/serving.md) share
    the owner-pid prefix — must be unlinked by the time the session ends;
    a leak means some TransferPool, ProcessWorkerPool, StagingArena, or
    BlockCache was never closed."""
    import glob
    prefix = f"/dev/shm/repro-io-{os.getpid():x}-"
    yield
    leftovers = sorted(glob.glob(prefix + "*"))
    assert not leftovers, (
        f"leaked IO-worker shared-memory segments: {leftovers}")


@pytest.fixture(scope="session")
def rng():
    import jax
    return jax.random.PRNGKey(0)
