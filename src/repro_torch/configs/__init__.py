"""Architecture config registry of the port.

``get_config(arch_id)`` returns the full published config;
``get_config(arch_id, reduced=True)`` returns the smoke-test variant.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig, TrainConfig  # noqa: F401

_ARCH_MODULES: Dict[str, str] = {
    "yi-9b": "repro_torch.configs.yi_9b",
    "llama3.2-3b": "repro_torch.configs.llama3_2_3b",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)


def get_config(arch: str, *, reduced: bool = False) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; ported: {ARCH_IDS}")
    cfg: ModelConfig = importlib.import_module(_ARCH_MODULES[arch]).CONFIG
    return cfg.reduced() if reduced else cfg
