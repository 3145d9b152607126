"""JSON (de)serialization of manifests: stdlib ``json`` with the layout the
JAX package writes (2-space indent), so stores load in either package."""
from __future__ import annotations

import json
from typing import Any, Union


def dumps(obj: Any, *, indent: bool = False) -> bytes:
    return json.dumps(obj, indent=2 if indent else None,
                      separators=None if indent else (",", ":")).encode()


def loads(data: Union[bytes, str]) -> Any:
    if isinstance(data, bytes):
        data = data.decode()
    return json.loads(data)
