"""Merge recipes: the MergeKit-style YAML interface of the explicit merge
(the port's copy of the JAX package's ``core/recipe.py``).

Schema (YAML or JSON):

    base: /path/to/ckpt_root@1000        # checkpoint root + step
    output: /path/to/merged_root         # where the Frankenstein lands
    optimizer: true                       # merge optimizer groups too
    select:
      - units: block_000..block_013      # range, name, or glob-ish list
        from: /path/to/ckpt_root@900
      - units: [embed, final_norm]
        from: /path/to/ckpt_root@900

Unmentioned units come from ``base``.  ``from``/``base`` accept
"root@step" (a specific manifest) or "root" (the LATEST manifest).
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

from repro_torch.core import jsonutil, yamlish

_RANGE_RE = re.compile(r"^(.*?)(\d+)\.\.(.*?)(\d+)$")


def expand_patterns(patterns: Sequence[str],
                    all_units: Sequence[str]) -> List[str]:
    """Resolve recipe unit patterns against the known unit names.

    Three forms: a zero-padded range (``block_000..block_013``), a
    glob-ish prefix (``block_*``), or an exact name.  Unknown exact names
    raise ``KeyError``: a recipe (or a serving variant selection, which
    reuses this) naming a unit the model does not have is a configuration
    error, not an empty match.
    """
    out: List[str] = []
    for pat in patterns:
        m = _RANGE_RE.match(pat)
        if m and m.group(1) == m.group(3):
            prefix, lo, hi = m.group(1), int(m.group(2)), int(m.group(4))
            width = len(m.group(2))
            for i in range(lo, hi + 1):
                name = f"{prefix}{i:0{width}d}"
                if name in all_units:
                    out.append(name)
        elif pat.endswith("*"):
            out.extend(u for u in all_units if u.startswith(pat[:-1]))
        elif pat in all_units:
            out.append(pat)
        else:
            raise KeyError(f"recipe names unknown unit {pat!r}")
    return out


@dataclasses.dataclass(frozen=True)
class CheckpointRef:
    root: Path
    step: Optional[int] = None  # None => LATEST

    @staticmethod
    def parse(s: str) -> "CheckpointRef":
        if "@" in s:
            root, _, step = s.rpartition("@")
            return CheckpointRef(Path(root), int(step))
        return CheckpointRef(Path(s), None)

    def __str__(self) -> str:
        return f"{self.root}@{self.step}" if self.step is not None \
            else str(self.root)


@dataclasses.dataclass
class SelectRule:
    units: List[str]            # patterns, expanded against the model's units
    source: CheckpointRef

    def expand(self, all_units: Sequence[str]) -> List[str]:
        return expand_patterns(self.units, all_units)


@dataclasses.dataclass
class Recipe:
    base: CheckpointRef
    output: Path
    select: List[SelectRule]
    optimizer: bool = True

    @staticmethod
    def from_dict(d: Dict) -> "Recipe":
        rules = []
        for item in d.get("select", []) or []:
            units = item.get("units")
            if isinstance(units, str):
                units = [units]
            rules.append(SelectRule(
                units=list(units),
                source=CheckpointRef.parse(str(item["from"]))))
        return Recipe(
            base=CheckpointRef.parse(str(d["base"])),
            output=Path(d["output"]),
            select=rules,
            optimizer=bool(d.get("optimizer", True)),
        )

    @staticmethod
    def load(path: Union[str, Path]) -> "Recipe":
        text = Path(path).read_text()
        if str(path).endswith(".json"):
            return Recipe.from_dict(jsonutil.loads(text))
        return Recipe.from_dict(yamlish.loads(text))

    def assignment(self, all_units: Sequence[str]
                   ) -> Dict[str, CheckpointRef]:
        """unit -> source checkpoint (later rules win; base fills the rest)."""
        out = {u: self.base for u in all_units}
        for rule in self.select:
            for u in rule.expand(all_units):
                out[u] = rule.source
        return out
