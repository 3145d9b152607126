"""Named crash points — the fault-injection seam of the save pipeline
(the port's own copy of the JAX package's catalog and arming rules).

The resiliency story (docs/resiliency.md) rests on one invariant: *a
crash anywhere before the manifest commit leaves the previous manifest
authoritative, and a crash after it loses nothing*.  This module makes
"anywhere" testable: the save/commit pipeline calls
:func:`crash_point` at every stage where a real process loss would be
interesting, and tests / the trainer CLI *arm* those points to die
there on demand.  Disarmed (the default, and the only state production
code ever runs in) a crash point is a dict lookup on an empty dict.

Catalog (``CRASH_POINTS``) — where each named point fires:

==================== ======================================================
``fingerprint``       saver ``_save_unit_fp``: after the device fingerprint
                      pass, before any payload moves
``gather``            saver ``_save_unit_fp``: after the dirty-block /
                      full gather crossed device->host, before the write
``object_write``      ``ChunkStore._write_object``: before the object blob
                      reaches the backend (fires on writer threads)
``spill``             ``TieredBackend._spill_one``: before the hot object
                      is copied to the durable tier (spill lane)
``participant_record`` ``ShardedSaver.save_shards``: before the
                      per-participant completion record is published
``barrier``           ``ShardCoordinator.commit``: after record validation,
                      before the manifest commit
``manifest_commit``   ``ManifestStore.commit``: before the manifest file
                      is written
``manifest_latest``   ``ManifestStore.commit``: after the manifest file,
                      before the LATEST pointer moves (torn commit)
``snapshot_overlap``  ``OverlappedSaver.begin``: after the event's device
                      gathers + async D2H copies are dispatched and
                      staged, before any spread slice runs (the event is
                      entirely in flight, nothing committed)
``spread_slice``      ``OverlappedSaver`` tick: before a spread slice
                      materializes/writes its share of staged units
                      (mid-spread, some units written, no commit yet)
``swap_apply``        ``swap.WeightService.swap``: before each changed
                      unit's delta is applied onto the staged device
                      tree (mid-swap — the OLD weights must keep
                      serving, never a half-applied tensor)
==================== ======================================================

plus the generic transfer-layer points ``pool:<lane>`` fired by
:class:`~repro_torch.checkpoint.async_io.TransferPool` before executing
each task of a lane (``pool:write``, ``pool:spill``, ...).

The port's save path reaches ``fingerprint``, ``gather``,
``object_write``, ``manifest_commit``, ``manifest_latest``,
``snapshot_overlap``, ``spread_slice`` and ``pool:write``, and its
hot-swap ``swap_apply``; the tiered and sharded points are cataloged for
the stages still to port.

Arming semantics (:func:`arm`):

- ``hit=N``     fire on the Nth time the point is reached (1 = first);
- ``sticky``    keep firing on every later hit too (a persistently
                failing resource instead of a one-shot crash) — a
                one-shot point disarms itself after firing so recovery
                paths (spill retries, restarts in-process) proceed;
- ``mode``      ``"raise"`` raises :class:`InjectedCrash` (in-process
                tests; surfaces through the normal error paths, e.g. an
                async lane's drain), ``"exit"`` calls ``os._exit`` —
                a hard kill with no unwinding, no atexit, no flushing,
                exactly what a subprocess crash drill wants — and
                ``"delay"`` sleeps ``delay`` seconds then continues
                (injected latency at a named point);
- ``delay``     seconds slept before the action (any mode).

The registry is process-global (the trainer CLI arms from ``--fail-at
12@spill`` and the crash fires deep inside writer threads) and
thread-safe; :func:`scoped` is the context-manager form tests use.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

#: Exit code used by ``mode="exit"`` crash points (distinguishable from
#: python tracebacks (1) and the trainer's preemption exit).
EXIT_CRASHED = 43

CRASH_POINTS = (
    "fingerprint",
    "gather",
    "object_write",
    "spill",
    "participant_record",
    "barrier",
    "manifest_commit",
    "manifest_latest",
    "snapshot_overlap",
    "spread_slice",
    "swap_apply",
)


class InjectedCrash(RuntimeError):
    """Raised by an armed crash point in ``mode="raise"``.

    Deliberately an ordinary ``RuntimeError`` subclass: the point of the
    drill is that injected failures travel the SAME error paths a real
    one would (async lanes collect it, drains re-raise it wrapped in
    ``AsyncWriteError``, the trainer dies with a traceback)."""


@dataclasses.dataclass
class _Arm:
    point: str
    hit: int = 1            # fire on the Nth hit
    mode: str = "raise"     # "raise" | "exit" | "delay"
    delay: float = 0.0
    sticky: bool = False
    exit_code: int = EXIT_CRASHED
    count: int = 0
    fired: int = 0


_lock = threading.Lock()
_armed: Dict[str, _Arm] = {}


def arm(point: str, *, hit: int = 1, mode: str = "raise",
        delay: float = 0.0, sticky: bool = False,
        exit_code: int = EXIT_CRASHED) -> None:
    """Arm ``point``; replaces any previous arming of the same point."""
    if mode not in ("raise", "exit", "delay"):
        raise ValueError(f"unknown crash mode {mode!r}")
    if hit < 1:
        raise ValueError(f"hit must be >= 1, got {hit}")
    with _lock:
        _armed[point] = _Arm(point=point, hit=int(hit), mode=mode,
                             delay=float(delay), sticky=bool(sticky),
                             exit_code=int(exit_code))


def disarm(point: Optional[str] = None) -> None:
    """Disarm one point (or every point: ``disarm()``)."""
    with _lock:
        if point is None:
            _armed.clear()
        else:
            _armed.pop(point, None)


def pending() -> List[str]:
    """Armed points that have not fired yet — the trainer checks this at
    the end of a run so an armed-but-never-reached point fails loudly
    instead of silently passing."""
    with _lock:
        return sorted(a.point for a in _armed.values() if not a.fired)


def crash_point(name: str) -> None:
    """Instrumentation hook: no-op unless ``name`` is armed and due."""
    if not _armed:  # fast path: benign unlocked read of a dict's emptiness
        return
    with _lock:
        a = _armed.get(name)
        if a is None:
            return
        a.count += 1
        if a.count < a.hit or (a.fired and not a.sticky):
            return
        a.fired += 1
        if not a.sticky and a.mode != "exit":
            # One-shot: self-disarm so recovery paths (spill retries,
            # in-process restarts) run clean.
            _armed.pop(name, None)
    if a.delay:
        time.sleep(a.delay)
    if a.mode == "delay":
        return
    if a.mode == "exit":
        os._exit(a.exit_code)
    raise InjectedCrash(
        f"injected crash at point {name!r} (hit {a.count})")


@contextmanager
def scoped(point: str, **kwargs):
    """``with faults.scoped("spill", sticky=True): ...`` — arm for the
    block, always disarm on the way out."""
    arm(point, **kwargs)
    try:
        yield
    finally:
        disarm(point)


def parse_fail_at(spec: "str | int") -> Tuple[int, Optional[str], int]:
    """Parse the trainer's ``--fail-at`` value.

    ``"40"``            -> (40, None, 1): the legacy step-boundary raise.
    ``"12@spill"``      -> (12, "spill", 1): arm the named crash point
                           when training reaches step 12, so the failure
                           fires *mid-save* inside the pipeline stage.
    ``"12@spill:2"``    -> fire on the 2nd hit of the point.
    """
    s = str(spec)
    if "@" not in s:
        return int(s), None, 1
    step_s, point = s.split("@", 1)
    hit = 1
    if ":" in point:
        point, hit_s = point.rsplit(":", 1)
        hit = int(hit_s)
    if not point:
        raise ValueError(f"empty crash point in --fail-at {spec!r}")
    return int(step_s), point, hit
