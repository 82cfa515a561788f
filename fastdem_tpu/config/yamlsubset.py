"""YAML loading without a hard PyYAML dependency.

``load_yaml`` uses PyYAML's ``safe_load`` when PyYAML is importable. Where
it is not, it parses the subset of YAML the presets and the reference's
configs use: block mappings nested by indentation, plain and quoted
scalars, flow (inline) lists of scalars, and ``#`` comments. Plain scalars
resolve as YAML 1.1 does (PyYAML's implicit resolvers for null, bool,
decimal int and float), so both paths give the same values on that
subset. Anything outside it raises ValueError rather than loading wrong.
"""

from __future__ import annotations

import re
from typing import Any, List, Tuple

_NULL = re.compile(r"^(?:~|null|Null|NULL)?$")
_BOOL_TRUE = re.compile(r"^(?:yes|Yes|YES|true|True|TRUE|on|On|ON)$")
_BOOL_FALSE = re.compile(r"^(?:no|No|NO|false|False|FALSE|off|Off|OFF)$")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?\.(?:inf|Inf|INF)"
    r"|\.(?:nan|NaN|NAN))$"
)


def load_yaml(path: str) -> Any:
    """Parse a YAML file: PyYAML when installed, else :func:`safe_load`."""
    with open(path) as f:
        text = f.read()
    try:
        import yaml
    except ImportError:
        return safe_load(text)
    return yaml.safe_load(text)


def safe_load(text: str) -> Any:
    """Parse the supported YAML subset (module docstring); None if empty."""
    lines = _logical_lines(text)
    if not lines:
        return None
    value, i = _parse_mapping(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"line {lines[i][2]}: unexpected indentation")
    return value


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in ("'", '"'):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _logical_lines(text: str) -> List[Tuple[int, str, int]]:
    """(indent, content, line number) of every non-blank, non-comment line."""
    out = []
    for num, raw in enumerate(text.splitlines(), start=1):
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError(f"line {num}: tab indentation")
        body = _strip_comment(raw).rstrip()
        if not body.strip():
            continue
        if body.strip() in ("---", "..."):
            raise ValueError(f"line {num}: document markers not supported")
        out.append((len(body) - len(body.lstrip(" ")), body.strip(), num))
    return out


def _split_key(content: str, num: int) -> Tuple[str, str]:
    """Split ``key: rest`` at the first colon outside quotes that ends the
    line or is followed by a space."""
    quote = None
    for i, ch in enumerate(content):
        if quote:
            if ch == quote:
                quote = None
        elif ch in ("'", '"'):
            quote = ch
        elif ch == ":" and (i + 1 == len(content) or content[i + 1] == " "):
            key = _scalar(content[:i].strip(), num)
            return str(key), content[i + 1 :].strip()
    raise ValueError(f"line {num}: expected 'key: value', got {content!r}")


def _parse_mapping(lines, i: int, indent: int) -> Tuple[dict, int]:
    out = {}
    while i < len(lines):
        ind, content, num = lines[i]
        if ind < indent:
            break
        if ind > indent:
            raise ValueError(f"line {num}: unexpected indentation")
        if content.startswith("- ") or content == "-":
            raise ValueError(f"line {num}: block sequences not supported")
        key, rest = _split_key(content, num)
        if key in out:
            raise ValueError(f"line {num}: duplicate key {key!r}")
        i += 1
        if rest:
            out[key] = _value(rest, num)
        elif i < len(lines) and lines[i][0] > indent:
            out[key], i = _parse_mapping(lines, i, lines[i][0])
        else:
            out[key] = None
    return out, i


def _value(text: str, num: int) -> Any:
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"line {num}: unterminated flow list")
        inner = text[1:-1].strip()
        if not inner:
            return []
        return [_scalar(item.strip(), num) for item in _split_items(inner, num)]
    if text.startswith(("{", "&", "*", "!", "|", ">")):
        raise ValueError(f"line {num}: {text[0]!r} not supported")
    return _scalar(text, num)


def _split_items(inner: str, num: int) -> List[str]:
    items, start, quote = [], 0, None
    for i, ch in enumerate(inner):
        if quote:
            if ch == quote:
                quote = None
        elif ch in ("'", '"'):
            quote = ch
        elif ch in "[]{}":
            raise ValueError(f"line {num}: nested flow collections")
        elif ch == ",":
            items.append(inner[start:i])
            start = i + 1
    items.append(inner[start:])
    return items


def _scalar(text: str, num: int) -> Any:
    if len(text) >= 2 and text[0] == text[-1] == '"':
        return (
            text[1:-1]
            .replace("\\\\", "\0")
            .replace('\\"', '"')
            .replace("\\n", "\n")
            .replace("\\t", "\t")
            .replace("\0", "\\")
        )
    if len(text) >= 2 and text[0] == text[-1] == "'":
        return text[1:-1].replace("''", "'")
    if text[:1] in ("'", '"'):
        raise ValueError(f"line {num}: unterminated quoted scalar")
    if _NULL.match(text):
        return None
    if _BOOL_TRUE.match(text):
        return True
    if _BOOL_FALSE.match(text):
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        if t.endswith("inf"):
            return float("-inf") if t.startswith("-") else float("inf")
        if t.endswith("nan"):
            return float("nan")
        return float(t)
    return text
