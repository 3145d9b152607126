"""IO tiers under the content-addressed chunk store (the port's copies of
the JAX package's backends, same layouts on disk):

- :class:`LocalFSBackend` — the POSIX ``objects/`` fan-out tree (default);
- :class:`MemoryBackend` — a RAM tier for volatile checkpoints;
- :class:`TieredBackend` — a hot tier over a durable tier with
  asynchronous spill, promotion on read and LRU eviction under a byte
  budget;
- :class:`RemoteBackend` — an S3/GCS-shaped object tier (multipart PUT,
  ranged GET) simulated in a directory, with retries, hedged GETs and a
  circuit breaker;
- :class:`FaultInjectingBackend` — a hostile decorator for drills.

``make_backend`` maps the ``store_backend=`` knob ("local" | "memory" |
"tiered" | "remote" | "remote3") to an instance rooted under a
checkpoint root's ``objects/`` (the durable disk) and ``remote/`` (the
simulated bucket).  ``remote3`` is RAM → disk → remote: the outer tier
spills to disk on the pool's ``spill`` lane, the inner, best-effort tier
replicates disk → remote on ``remote_spill`` and degrades to honest
disk-durable commits while the remote is down.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional

from repro_torch.checkpoint.async_io import IoDispatch, TransferPool
from repro_torch.checkpoint.backends.base import StorageBackend  # noqa: F401
from repro_torch.checkpoint.backends.faulty import (  # noqa: F401
    FaultInjectingBackend,
)
from repro_torch.checkpoint.backends.localfs import (  # noqa: F401
    LocalFSBackend,
    atomic_write,
)
from repro_torch.checkpoint.backends.memory import MemoryBackend  # noqa: F401
from repro_torch.checkpoint.backends.remote import (  # noqa: F401
    RemoteBackend,
    RemoteError,
    RemoteOutage,
    RemoteThrottle,
    RemoteTimeout,
    RemoteUnavailable,
    SimulatedObjectService,
)
from repro_torch.checkpoint.backends.retry import (  # noqa: F401
    CircuitBreaker,
    LatencyTracker,
    RetryPolicy,
)
from repro_torch.checkpoint.backends.tiered import (  # noqa: F401
    SPILL_LANE,
    TieredBackend,
)

BACKEND_NAMES = ("local", "memory", "tiered", "remote", "remote3")

#: lane of the disk -> remote spill (RAM -> disk keeps SPILL_LANE), so one
#: pool carries both without their barriers entangling
REMOTE_SPILL_LANE = "remote_spill"

# remote_opts keys of the simulated service; the rest configure the retry
# policy, the breaker and the RemoteBackend's hedging
_SERVICE_KEYS = ("latency", "error_rate", "throttle_rate", "spike_rate",
                 "spike_latency", "spike_ops", "seed")
_POLICY_KEYS = ("attempts", "base_delay", "max_delay", "jitter", "timeout")


def _build_remote(root: Path, opts: Dict[str, Any]) -> RemoteBackend:
    opts = dict(opts)
    service_kw = {k: opts.pop(k) for k in _SERVICE_KEYS if k in opts}
    policy_kw = {k: opts.pop(k) for k in _POLICY_KEYS if k in opts}
    service = SimulatedObjectService(root / "remote", **service_kw)
    policy = RetryPolicy(**policy_kw) if policy_kw else None
    breaker_kw = {k: opts.pop(k) for k in ("failures", "cooldown")
                  if k in opts}
    breaker = CircuitBreaker(**breaker_kw) if breaker_kw else None
    return RemoteBackend(service, policy=policy, breaker=breaker, **opts)


def make_backend(spec: "str | StorageBackend", root: Path | str, *,
                 pool: Optional[TransferPool] = None,
                 spill_threads: int = 2,
                 hot_budget_bytes: Optional[int] = None,
                 remote_opts: Optional[Dict[str, Any]] = None,
                 dispatch: Optional[IoDispatch] = None
                 ) -> StorageBackend:
    """Resolve a ``store_backend`` knob into a backend rooted at checkpoint
    root ``root`` (disk tree ``root/objects``, bucket ``root/remote``).  A
    StorageBackend instance passes through untouched.  ``pool`` carries
    the spill lanes (a pool of the backend's own when None);
    ``remote_opts`` configures the simulated service
    (latency/error_rate/seed/...), the retry policy (attempts/timeout/...),
    the breaker (failures/cooldown) and the hedging.  ``dispatch`` (a
    process-backed ``IoDispatch``) moves the disk tiers' atomic writes,
    a tiered spill's included, into subprocess workers."""
    if isinstance(spec, StorageBackend):
        return spec
    root = Path(root)
    if spec == "local":
        return LocalFSBackend(root / "objects", dispatch=dispatch)
    if spec == "memory":
        return MemoryBackend()
    if spec == "tiered":
        return TieredBackend(MemoryBackend(),
                             LocalFSBackend(root / "objects",
                                            dispatch=dispatch),
                             pool=pool, spill_threads=spill_threads,
                             hot_budget_bytes=hot_budget_bytes)
    if spec == "remote":
        return _build_remote(root, dict(remote_opts or {}))
    if spec == "remote3":
        remote = _build_remote(root, dict(remote_opts or {}))
        own_pool = pool is None
        if pool is None:
            # one pool, two lanes; unbounded queue: spill tasks submit
            # follow-on spill tasks
            pool = TransferPool(max(2, spill_threads * 2), max_queue=0)
        inner = TieredBackend(
            LocalFSBackend(root / "objects", dispatch=dispatch), remote,
            pool=pool, lane=REMOTE_SPILL_LANE,
            hot_label="durable", durable_label=None,
            promote_on_read=True,  # a lost disk copy re-warms from remote
            required=False)        # remote down: degrade, don't fail
        outer = TieredBackend(MemoryBackend(), inner, pool=pool,
                              hot_budget_bytes=hot_budget_bytes,
                              durable_label=None)
        # the outer tier closes the pool iff it was made here (after the
        # durable side is down)
        outer._owns_pool = own_pool
        return outer
    raise ValueError(
        f"unknown store backend {spec!r}; expected one of {BACKEND_NAMES} "
        "or a StorageBackend instance")
