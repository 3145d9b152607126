"""Restorability probe of the port: restore a checkpoint without a training
process and report what the restore plan had to do.

    probe = probe_restore(ckpt_root, "yi-9b", reduced=False, num_layers=2)

The supervisor (``launch/supervisor.py``) runs it between a death and the
relaunch, so a checkpoint a restarted trainer would choke on is caught
before the restart, and ``fallback_units`` shows units that fell back to
an older manifest.  It reads stores of global objects and of shard sets
alike (a shard set restores whole).  The restore onto a mesh of several
devices (``restore_on_mesh`` of the JAX package) is ROADMAP A4.2.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

from repro_torch.checkpoint.saver import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.layer_registry import LayerRegistry
from repro_torch.core.policies import make_policy
from repro_torch.devices import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models import build_model


def probe_restore(ckpt_root: "str | Path", arch: str, *,
                  reduced: bool = True,
                  num_layers: Optional[int] = None,
                  parts: Tuple[str, ...] = ("params",),
                  store_backend: str = "local",
                  device=None) -> Dict[str, Any]:
    """Rebuild the model from its arch id (``num_layers`` cuts its depth),
    restore ``parts`` of the newest manifest onto ``device`` (the card
    unless ``"cpu"``) and report the step, the parts, the bytes read, the
    units that fell back to an older manifest and the seconds taken."""
    t0 = time.time()
    dev = resolve_device(device)
    cfg = get_config(arch, reduced=reduced)
    if num_layers is not None:
        cfg = cfg.replace(num_layers=int(num_layers))
    model = build_model(cfg)
    mgr = CheckpointManager(Path(ckpt_root), LayerRegistry(model),
                            make_policy("full", model.layer_units()),
                            async_save=False, store_backend=store_backend)
    try:
        state = mgr.restore(steps_lib.state_specs(model), device=dev,
                            parts=parts)
        stats = dict(mgr.last_restore_stats)
        return {
            "step": (int(state["step"]) if "step" in state
                     else mgr.manifests.latest_step()),
            "parts": list(parts),
            "bytes_read": stats.get("bytes_read"),
            "fallback_units": stats.get("fallback_units", []),
            "seconds": time.time() - t0,
        }
    finally:
        mgr.close()
