"""Layer-aligned parameter groups (LLMTailor §4.1): the paper's 2L + x
groups, one (decay, no-decay) pair per block and one group per auxiliary
layer, in the JAX package's fixed order.  The checkpoint layout and the
per-leaf weight decay of the AdamW update both key off it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

from repro_torch.models.model_api import BaseLM, LayerUnit

PyTree = Any
Path = Tuple[str, ...]


def _leaf_paths(tree: PyTree, prefix: Path = ()) -> List[Path]:
    if isinstance(tree, dict):
        out: List[Path] = []
        for k in sorted(tree):
            out.extend(_leaf_paths(tree[k], prefix + (k,)))
        return out
    return [prefix]


def get_at(tree: PyTree, path: Path) -> PyTree:
    for k in path:
        tree = tree[k]
    return tree


def set_at(tree: PyTree, path: Path, value: PyTree) -> PyTree:
    """Functional set — returns a new tree sharing unmodified subtrees."""
    if not path:
        return value
    new = dict(tree)
    new[path[0]] = set_at(tree[path[0]], path[1:], value)
    return new


def tree_map(fn, tree: PyTree, *rest: PyTree) -> PyTree:
    """Map over the leaves of nested dicts (all trees share one structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree: PyTree) -> list:
    return [get_at(tree, p) for p in _leaf_paths(tree)]


def is_no_decay(path: Path, ndim: int) -> bool:
    """AdamW convention: norms / biases / scalars are exempt from decay."""
    name = path[-1] if path else ""
    if any(t in name for t in ("ln", "norm", "bias", "scale", "A_log",
                               "D_skip", "dt_bias")):
        return True
    return ndim <= 1


@dataclasses.dataclass(frozen=True)
class ParamGroup:
    index: int
    unit: str
    decay: bool
    paths: Tuple[Path, ...]    # param subpaths relative to the unit subtree
    weight_decay: float = 0.0


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    groups: Tuple[ParamGroup, ...]
    units: Tuple[LayerUnit, ...]

    @property
    def num_groups(self) -> int:
        return len(self.groups)


def build_group_spec(model: BaseLM, *, weight_decay: float) -> GroupSpec:
    """The 2L + x groups: no-decay groups of every block, then the aux
    layers, then the decay groups of every block."""
    units = tuple(model.layer_units())
    specs = model.param_specs()

    def split_paths(u: LayerUnit) -> Tuple[List[Path], List[Path]]:
        sub = get_at(specs, u.path)
        decay_paths, nodecay_paths = [], []
        for p in _leaf_paths(sub):
            ndim = get_at(sub, p).ndim - (1 if u.index is not None else 0)
            (nodecay_paths if is_no_decay(p, ndim) else decay_paths).append(p)
        return decay_paths, nodecay_paths

    groups: List[ParamGroup] = []
    pending: List[Tuple[LayerUnit, List[Path]]] = []
    for u in (u for u in units if u.kind == "block"):
        dec, nodec = split_paths(u)
        groups.append(ParamGroup(len(groups), u.name, False, tuple(nodec)))
        pending.append((u, dec))
    for u in (u for u in units if u.kind != "block"):
        dec, nodec = split_paths(u)
        decay = bool(dec)
        groups.append(ParamGroup(len(groups), u.name, decay,
                                 tuple(dec + nodec),
                                 weight_decay=weight_decay if decay else 0.0))
    for u, dec in pending:
        groups.append(ParamGroup(len(groups), u.name, True, tuple(dec),
                                 weight_decay=weight_decay))
    return GroupSpec(groups=tuple(groups), units=units)


def decay_mask(model: BaseLM, spec: Optional[GroupSpec] = None) -> PyTree:
    """Tree of bool: True where weight decay applies (from the groups)."""
    spec = spec or build_group_spec(model, weight_decay=1.0)
    units = {u.name: u for u in spec.units}
    mask = tree_map(lambda _: False, model.param_specs())
    for g in spec.groups:
        if g.decay:
            for p in g.paths:
                mask = set_at(mask, units[g.unit].path + p, True)
    return mask
