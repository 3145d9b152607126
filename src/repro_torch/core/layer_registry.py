"""Layer registry: layer units <-> slices of the train-state trees.

A unit's full training state is its bf16 weights plus the three float32
optimizer tensors (master, m, v).  Units of the stacked blocks are slices
along the leading 'layers' dim: ``extract_unit`` returns views ``x[i]`` (no
copy) and ``insert_unit`` copies into them in place on the device.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.models.model_api import BaseLM, LayerUnit
from repro_torch.optim.groups import (GroupSpec, build_group_spec, get_at,
                                      tree_map)

PyTree = Any

OPT_KINDS = ("master", "m", "v")


class LayerRegistry:
    def __init__(self, model: BaseLM, *, weight_decay: float = 0.1,
                 group_spec: Optional[GroupSpec] = None):
        self.model = model
        self.units: List[LayerUnit] = model.layer_units()
        self.by_name: Dict[str, LayerUnit] = {u.name: u for u in self.units}
        self.group_spec = group_spec or build_group_spec(
            model, weight_decay=weight_decay)

    def extract_unit(self, params: PyTree, name: str) -> PyTree:
        """Unit subtree; stacked units are views ``x[i]``."""
        u = self.by_name[name]
        sub = get_at(params, u.path)
        if u.index is None:
            return sub
        return tree_map(lambda x: x[u.index], sub)

    def insert_unit(self, params: PyTree, name: str, value: PyTree) -> PyTree:
        """Copy ``value`` into the unit's tensors in place (host or device
        source); returns ``params`` for symmetry with the JAX package."""
        with torch.no_grad():
            tree_map(lambda dst, src: dst.copy_(src),
                     self.extract_unit(params, name), value)
        return params

    def extract_opt_unit(self, opt: Dict[str, PyTree],
                         name: str) -> Dict[str, PyTree]:
        return {k: self.extract_unit(opt[k], name) for k in OPT_KINDS}

    def insert_opt_unit(self, opt: Dict[str, PyTree], name: str,
                        value: Dict[str, PyTree]) -> Dict[str, PyTree]:
        for k in OPT_KINDS:
            self.insert_unit(opt[k], name, value[k])
        return opt

    def unit_names(self) -> List[str]:
        return [u.name for u in self.units]
