"""Parser for the YAML subset the configuration schema uses.

The reference's configs (reference: src/infra/Config.jl, test/infra/test.yaml)
need only: nested block mappings, plain or quoted scalars, flow sequences of
scalars such as ``[temperature, salinity]``, and ``#`` comments. This module
parses exactly that and raises ``ValueError`` on anything else (block
sequences, anchors, multi-line scalars, tabs), so the package needs no YAML
library at run time.

Plain scalars resolve as YAML 1.1 does for the forms the schema holds:
``true``/``false`` -> bool, ``null``/``~``/empty -> None, decimal integers
-> int, decimal floats (``1.5``, ``1.e25``, ``.inf``) -> float, anything
else -> str. MPAS timestamps such as ``0001-01-01_00:00:00`` stay strings;
``config.parse_timestamp`` turns them into dates and periods.
"""

from __future__ import annotations

import re
from typing import Any

__all__ = ["load"]

_INT = re.compile(r"^[-+]?\d+$")
_FLOAT = re.compile(r"^[-+]?(\d+\.\d*|\.\d+|\d+)([eE][-+]?\d+)?$")
_INF = re.compile(r"^[-+]?\.(inf|Inf|INF)$")
_NAN = re.compile(r"^\.(nan|NaN|NAN)$")
_ESCAPES = {"n": "\n", "t": "\t", "\\": "\\", '"': '"'}
_KEY = re.compile(r"^([^\s#'\"\[\]{},:][^#:]*?|'[^']*'|\"[^\"]*\")\s*:(\s+|$)")


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment that starts the line or follows whitespace,
    ignoring ``#`` inside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _unquote(text: str, lineno: int) -> str:
    q = text[0]
    if len(text) < 2 or text[-1] != q:
        raise ValueError(f"line {lineno}: unterminated quoted scalar {text!r}")
    body = text[1:-1]
    if q == "'":
        return body.replace("''", "'")
    return re.sub(r"\\(.)", lambda m: _ESCAPES.get(m.group(1), m.group(1)),
                  body)


def _scalar(text: str, lineno: int) -> Any:
    text = text.strip()
    if not text or text in ("~", "null", "Null", "NULL"):
        return None
    if text[0] in "'\"":
        return _unquote(text, lineno)
    if text[0] in "[{&*!|>@`" or text.startswith("- "):
        raise ValueError(f"line {lineno}: unsupported YAML value {text!r}")
    if text in ("true", "True", "TRUE"):
        return True
    if text in ("false", "False", "FALSE"):
        return False
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    if _INF.match(text):
        return float("-inf") if text[0] == "-" else float("inf")
    if _NAN.match(text):
        return float("nan")
    return text


def _value(text: str, lineno: int) -> Any:
    text = text.strip()
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"line {lineno}: unterminated flow sequence")
        inner = text[1:-1].strip()
        if not inner:
            return []
        if any(c in inner for c in "[]{}"):
            raise ValueError(f"line {lineno}: nested flow collections")
        return [_scalar(item, lineno) for item in _split_flow(inner, lineno)]
    return _scalar(text, lineno)


def _split_flow(inner: str, lineno: int) -> list[str]:
    items, cur, quote = [], [], None
    for ch in inner:
        if quote:
            cur.append(ch)
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
            cur.append(ch)
        elif ch == ",":
            items.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if quote:
        raise ValueError(f"line {lineno}: unterminated quote in flow sequence")
    items.append("".join(cur))
    if any(not item.strip() for item in items):
        raise ValueError(f"line {lineno}: empty flow sequence entry")
    return items


def load(text: str) -> dict:
    """Parse a YAML document of nested block mappings into nested dicts."""
    lines = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError(f"line {lineno}: tab indentation")
        line = _strip_comment(raw)
        if not line.strip() or line.strip() in ("---", "..."):
            continue
        lines.append((lineno, len(line) - len(line.lstrip()), line.strip()))

    root: dict = {}
    # stack of (indent of the mapping's keys, mapping); a key whose value is
    # left empty opens a child mapping whose indent the next line fixes
    stack: list[tuple[int, dict]] = [(0 if not lines else lines[0][1], root)]
    pending = None  # (parent mapping, key) awaiting a nested block
    for lineno, indent, body in lines:
        if pending is not None:
            parent, key = pending
            pending = None
            if indent > stack[-1][0]:
                child: dict = {}
                parent[key] = child
                stack.append((indent, child))
        while indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            raise ValueError(f"line {lineno}: inconsistent indentation")
        m = _KEY.match(body)
        if m is None:
            raise ValueError(f"line {lineno}: expected 'key: value', got {body!r}")
        key = m.group(1).strip()
        if key[0] in "'\"":
            key = _unquote(key, lineno)
        mapping = stack[-1][1]
        if key in mapping:
            raise ValueError(f"line {lineno}: duplicate key {key!r}")
        rest = body[m.end():]
        if rest.strip():
            mapping[key] = _value(rest, lineno)
        else:
            mapping[key] = None
            pending = (mapping, key)
    return root
