"""Dotted-name parameter system with YAML presets and strict unused-key errors.

Port of libcml_tpu/runtime/config.py (the reference's Parameter tier:
src/cml/base/Parameter.h:18, AbstractFunction.h:102-114 dotted aliases,
AbstractSlam.h:70-83 YAML application with a fatal unused-parameter check).

Configuration is a tree of frozen dataclasses (DirectConfig, DecisionConfig,
the CLI's SlamConfig). YAML keys address fields by dotted path
("direct.max_frames: 6"); apply_config returns new dataclass instances and
raises on any key that matches nothing, which catches preset typos before a
run silently ignores them.

YAML is read by a small reader of this module (`parse_yaml`), on every
machine, whether PyYAML is installed or not: the subset that `presets/*.yaml`
and the camera files of the datasets use — nested block mappings, scalars
resolved as PyYAML's safe loader resolves them (YAML 1.1: ints, floats,
booleans, null, quoted and plain strings), `#` comments, and flow lists
`[a, b]`, which may span lines. Anything else (block sequences, anchors,
multi-line strings, flow mappings) raises ValueError.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any


class UnusedConfigKey(KeyError):
    pass


def _set_path(obj: Any, path: list[str], value: Any) -> Any:
    """Return a copy of the (possibly nested) frozen dataclass with the field
    at `path` replaced. Raises UnusedConfigKey when the path doesn't exist."""
    if not dataclasses.is_dataclass(obj):
        raise UnusedConfigKey(".".join(path))
    name = path[0]
    fields = {f.name: f for f in dataclasses.fields(obj)}
    if name not in fields:
        raise UnusedConfigKey(".".join(path))
    if len(path) == 1:
        cur = getattr(obj, name)
        if cur is not None and not isinstance(value, type(cur)):
            # YAML int -> float promotion etc.; keep the declared field type
            value = type(cur)(value)
        return dataclasses.replace(obj, **{name: value})
    child = _set_path(getattr(obj, name), path[1:], value)
    return dataclasses.replace(obj, **{name: child})


def apply_config(root: Any, settings: dict[str, Any]) -> Any:
    """Apply {dotted.key: value} settings onto a dataclass tree. Every key
    must resolve; unknown keys raise (reference: AbstractSlam.h:77-82)."""
    unused = []
    for key, value in settings.items():
        try:
            root = _set_path(root, key.split("."), value)
        except UnusedConfigKey:
            unused.append(key)
    if unused:
        raise UnusedConfigKey(
            f"configuration keys matched nothing: {unused} — "
            "check spelling against the config dataclasses"
        )
    return root


def _flatten_yaml(node: Any, prefix: str = "") -> dict[str, Any]:
    out: dict[str, Any] = {}
    if isinstance(node, dict):
        for k, v in node.items():
            key = f"{prefix}.{k}" if prefix else str(k)
            out.update(_flatten_yaml(v, key))
    else:
        out[prefix] = node
    return out


def load_yaml_config(root: Any, path: str) -> Any:
    """Apply a YAML preset file; nested mappings and dotted keys both work
    (reference preset format: evaluation/modslam.yaml etc.)."""
    with open(path) as f:
        data = parse_yaml(f.read()) or {}
    return apply_config(root, _flatten_yaml(data))


# ---------------------------------------------------------------------------
# YAML subset reader
# ---------------------------------------------------------------------------

# PyYAML's implicit resolvers (yaml/resolver.py), sexagesimal forms left out
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_TRUE = {"yes", "true", "on"}
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")


def _scalar(text: str) -> Any:
    """One plain or quoted scalar, resolved as yaml.safe_load resolves it."""
    s = text.strip()
    if len(s) >= 2 and s[0] == s[-1] == "'":
        return s[1:-1].replace("''", "'")
    if len(s) >= 2 and s[0] == s[-1] == '"':
        return s[1:-1].encode("latin-1", "backslashreplace").decode("unicode_escape")
    if s[:1] in ("&", "*", "!", "|", ">", "{", "@", "`") or s.startswith("- "):
        raise ValueError(f"YAML construct outside the supported subset: {s!r}")
    if _NULL.match(s):
        return None
    if _BOOL.match(s):
        return s.lower() in _TRUE
    if _INT.match(s):
        v = s.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if len(v) > 1 and v[0] == "0":
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.match(s):
        v = s.replace("_", "").lower()
        if v.endswith(".inf"):
            return float("-inf") if v[0] == "-" else float("inf")
        if v.endswith(".nan"):
            return float("nan")
        return float(v)
    return s


def _split_flow(body: str) -> list[str]:
    """Top-level comma-separated items of a flow list's body."""
    items, depth, quote, cur = [], 0, None, []
    for ch in body:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append("".join(cur))
            cur = []
            continue
        cur.append(ch)
    items.append("".join(cur))
    if items[-1].strip() == "":          # a trailing comma, or an empty list
        items.pop()
    return items


def _value(text: str) -> Any:
    s = text.strip()
    if s.startswith("["):
        if not s.endswith("]"):
            raise ValueError(f"unterminated YAML flow list: {s!r}")
        return [_value(item) for item in _split_flow(s[1:-1])]
    return _scalar(s)


def _strip_comment(line: str) -> str:
    """`line` without its comment: a `#` at the start or after whitespace,
    outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _logical_lines(text: str):
    """(indent, content) per logical line: comments and blank lines dropped,
    a flow list that spans lines joined into one."""
    pending = None
    for raw in text.splitlines():
        line = _strip_comment(raw)
        if pending is not None:
            pending = (pending[0], pending[1] + " " + line.strip())
            if pending[1].count("[") == pending[1].count("]"):
                yield pending
                pending = None
            continue
        if not line.strip() or line.strip() == "---":
            continue
        body = line.lstrip(" ")
        if body.startswith("\t"):
            raise ValueError("tabs are not allowed in YAML indentation")
        indent = len(line) - len(body)
        if body.count("[") > body.count("]"):
            pending = (indent, body)
            continue
        yield indent, body
    if pending is not None:
        raise ValueError(f"unterminated YAML flow list: {pending[1]!r}")


def _split_key(body: str) -> tuple[Any, str]:
    """`key: value` -> (resolved key, value text); the value may be empty."""
    m = re.match(r"^((?:'[^']*'|\"[^\"]*\"|[^'\":][^:]*?)):(?:\s+(.*)|)$", body)
    if m is None:
        raise ValueError(f"YAML line outside the supported subset: {body!r}")
    return _scalar(m.group(1)), (m.group(2) or "")


def parse_yaml(text: str) -> Any:
    """Parse a YAML document of the supported subset (see the module
    docstring) into dicts, lists and scalars, as yaml.safe_load does."""
    root: dict = {}
    stack: list[tuple[int, dict]] = []
    pending = None            # (mapping, key) whose value may be a nested block
    for indent, body in _logical_lines(text):
        if not stack:
            stack.append((indent, root))
        elif pending is not None and indent > stack[-1][0]:
            child: dict = {}
            pending[0][pending[1]] = child
            stack.append((indent, child))
        else:
            while stack and stack[-1][0] > indent:
                stack.pop()
            if not stack or stack[-1][0] != indent:
                raise ValueError(f"inconsistent YAML indentation at {body!r}")
        pending = None
        key, rest = _split_key(body)
        mapping = stack[-1][1]
        if rest.strip():
            mapping[key] = _value(rest)
        else:
            mapping[key] = None
            pending = (mapping, key)
    return root or None
