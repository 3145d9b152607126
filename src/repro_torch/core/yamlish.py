"""Minimal YAML subset parser/emitter for merge recipes (the port's copy
of the JAX package's ``core/yamlish.py``: same grammar, same scalar rules,
so both packages read every recipe the same way).

Supports the MergeKit-style recipe grammar LLMTailor needs: nested mappings
by 2-space indentation, block lists ("- item" / "- key: value"), scalars
(int, float, bool, null, quoted and bare strings), inline comments (#) and
blank lines.  Not supported (by design): anchors, multi-line strings, flow
collections beyond simple [a, b] / {k: v}.
"""
from __future__ import annotations

from typing import Any, List, Tuple


def _parse_scalar(s: str) -> Any:
    s = s.strip()
    if not s or s in ("null", "~", "None"):
        return None
    if s in ("true", "True"):
        return True
    if s in ("false", "False"):
        return False
    if (s.startswith('"') and s.endswith('"')) or \
       (s.startswith("'") and s.endswith("'")):
        return s[1:-1]
    if s.startswith("[") and s.endswith("]"):
        inner = s[1:-1].strip()
        return [_parse_scalar(x) for x in inner.split(",")] if inner else []
    if s.startswith("{") and s.endswith("}"):
        out = {}
        inner = s[1:-1].strip()
        if inner:
            for pair in inner.split(","):
                k, _, v = pair.partition(":")
                out[k.strip()] = _parse_scalar(v)
        return out
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    return s


def _strip_comment(line: str) -> str:
    out, quote = [], None
    for ch in line:
        if quote:
            if ch == quote:
                quote = None
            out.append(ch)
        elif ch in "\"'":
            quote = ch
            out.append(ch)
        elif ch == "#":
            break
        else:
            out.append(ch)
    return "".join(out).rstrip()


def _lines(text: str) -> List[Tuple[int, str]]:
    out = []
    for raw in text.splitlines():
        line = _strip_comment(raw)
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(" "))
        out.append((indent, line.strip()))
    return out


def loads(text: str) -> Any:
    lines = _lines(text)
    if not lines:
        return None
    value, rest = _parse_block(lines, 0, lines[0][0])
    if rest:
        raise ValueError(f"unparsed trailing content: {rest[0][1]!r}")
    return value


def _parse_block(lines: List[Tuple[int, str]], pos: int, indent: int):
    if pos >= len(lines):
        return None, []
    first = lines[pos][1]
    if first.startswith("- ") or first == "-":
        return _parse_list(lines, pos, indent)
    return _parse_map(lines, pos, indent)


def _parse_list(lines, pos, indent):
    items = []
    while pos < len(lines):
        ind, content = lines[pos]
        if ind < indent:
            break
        if ind > indent:
            raise ValueError(f"bad indent in list: {content!r}")
        if not (content.startswith("- ") or content == "-"):
            break
        body = content[2:].strip() if content != "-" else ""
        if not body:
            sub, rest = _parse_block(lines[pos + 1:], 0,
                                     _next_indent(lines, pos + 1, indent))
            items.append(sub)
            pos = len(lines) - len(rest)
            continue
        if ":" in body and not body.split(":", 1)[1].strip().startswith("//"):
            # "- key: value" — an inline map entry; absorb deeper lines.
            key, _, val = body.partition(":")
            entry = {key.strip(): _parse_scalar(val) if val.strip() else None}
            pos += 1
            while pos < len(lines) and lines[pos][0] > indent:
                ind2, c2 = lines[pos]
                k2, _, v2 = c2.partition(":")
                if v2.strip():
                    entry[k2.strip()] = _parse_scalar(v2)
                    pos += 1
                else:
                    sub, rest = _parse_block(
                        lines[pos + 1:], 0,
                        _next_indent(lines, pos + 1, ind2))
                    entry[k2.strip()] = sub
                    pos = len(lines) - len(rest)
            items.append(entry)
            continue
        items.append(_parse_scalar(body))
        pos += 1
    return items, lines[pos:]


def _next_indent(lines, pos, default):
    return lines[pos][0] if pos < len(lines) else default + 2


def _parse_map(lines, pos, indent):
    out = {}
    while pos < len(lines):
        ind, content = lines[pos]
        if ind < indent:
            break
        if ind > indent:
            raise ValueError(f"bad indent in map: {content!r}")
        if content.startswith("- ") or content == "-":
            break
        key, sep, val = content.partition(":")
        if not sep or key.strip().startswith("-"):
            raise ValueError(f"expected 'key:' got {content!r}")
        key = key.strip()
        if val.strip():
            out[key] = _parse_scalar(val)
            pos += 1
        else:
            if pos + 1 < len(lines) and lines[pos + 1][0] > ind:
                sub, rest = _parse_block(lines[pos + 1:], 0, lines[pos + 1][0])
                out[key] = sub
                pos = len(lines) - len(rest)
            else:
                out[key] = None
                pos += 1
    return out, lines[pos:]


def _is_scalar_list(v: Any) -> bool:
    return isinstance(v, list) and all(
        not isinstance(x, (dict, list)) for x in v)


def _emit_value_inline(v: Any) -> str:
    if _is_scalar_list(v):
        return "[" + ", ".join(_emit_scalar(x) for x in v) + "]"
    return _emit_scalar(v)


def dumps(obj: Any, indent: int = 0) -> str:
    pad = " " * indent
    if isinstance(obj, dict):
        lines = []
        for k, v in obj.items():
            if isinstance(v, (dict, list)) and v and not _is_scalar_list(v):
                lines.append(f"{pad}{k}:")
                lines.append(dumps(v, indent + 2))
            else:
                lines.append(f"{pad}{k}: {_emit_value_inline(v)}")
        return "\n".join(lines)
    if isinstance(obj, list):
        lines = []
        for v in obj:
            if isinstance(v, dict) and v:
                keys = list(v)
                first = keys[0]
                if isinstance(v[first], (dict, list)) \
                        and not _is_scalar_list(v[first]):
                    lines.append(f"{pad}- {first}:")
                    lines.append(dumps(v[first], indent + 4))
                else:
                    lines.append(
                        f"{pad}- {first}: {_emit_value_inline(v[first])}")
                for k in keys[1:]:
                    if isinstance(v[k], (dict, list)) and v[k] \
                            and not _is_scalar_list(v[k]):
                        lines.append(f"{pad}  {k}:")
                        lines.append(dumps(v[k], indent + 4))
                    else:
                        lines.append(
                            f"{pad}  {k}: {_emit_value_inline(v[k])}")
            elif isinstance(v, list):
                lines.append(f"{pad}-")
                lines.append(dumps(v, indent + 2))
            else:
                lines.append(f"{pad}- {_emit_value_inline(v)}")
        return "\n".join(lines)
    return f"{pad}{_emit_value_inline(obj)}"


def _emit_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        needs_quote = (v == "" or v != v.strip() or
                       any(c in v for c in ":#[]{},\"'") or
                       v in ("true", "false", "null"))
        return f'"{v}"' if needs_quote else v
    return str(v)
