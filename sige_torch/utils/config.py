"""Config system: YAML -> attribute-access config + dot-path overrides —
the port of ``sige_tpu.utils.config``.

The reference's diffusion suite reads YAML into an EasyDict and applies
``--hparams "a.b=c d=e"`` overrides (diffusion/utils.py:12-68). The
machine with the card has no PyYAML, so :func:`load_config` reads the
YAML subset that ``configs/*.yml`` and ``configs/*.yaml`` use with its own
reader (:func:`parse_yaml`): block mappings by indentation, flow lists
``[1, 2]`` and flow maps ``{a: 1, b: null}``, plain and quoted scalars
resolved as PyYAML's ``safe_load`` resolves them (YAML 1.1: ``1.0e-4`` is
a float, ``true`` a bool, ``null`` None), and ``#`` comments. Anything
else (block sequences, anchors, multi-line scalars, documents) raises
:class:`ValueError`.
"""

from __future__ import annotations

import importlib
import re
from typing import Any, List, Tuple


class AttrDict(dict):
    """dict with attribute access, recursively."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    @classmethod
    def convert(cls, obj):
        if isinstance(obj, dict):
            return cls({k: cls.convert(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [cls.convert(v) for v in obj]
        return obj


# PyYAML's implicit resolvers (yaml/resolver.py), the ones safe_load uses
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_TRUE = {"yes", "true", "on"}
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")


def _sexagesimal(text: str, conv):
    sign = -1 if text.startswith("-") else 1
    value = 0
    for part in text.lstrip("+-").split(":"):
        value = value * 60 + conv(part)
    return sign * value


def _int(text: str) -> int:
    t = text.replace("_", "")
    sign = -1 if t.startswith("-") else 1
    body = t.lstrip("+-")
    if ":" in body:
        return sign * _sexagesimal(body, int)
    if body.startswith("0b"):
        return sign * int(body[2:], 2)
    if body.startswith("0x"):
        return sign * int(body[2:], 16)
    if len(body) > 1 and body.startswith("0"):
        return sign * int(body, 8)
    return sign * int(body)


def _float(text: str) -> float:
    t = text.replace("_", "").lower()
    sign = -1.0 if t.startswith("-") else 1.0
    body = t.lstrip("+-")
    if body == ".inf":
        return sign * float("inf")
    if body == ".nan":
        return float("nan")
    if ":" in body:
        return sign * _sexagesimal(body, float)
    return sign * float(body)


def _scalar(text: str) -> Any:
    """A plain or quoted scalar, resolved as PyYAML's safe_load does."""
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        body = text[1:-1]
        if text[0] == "'":
            return body.replace("''", "'")
        if "\\" in body:
            raise ValueError(f"escapes in double-quoted scalar {text!r}")
        return body
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in _TRUE
    if _INT.match(text):
        return _int(text)
    if _FLOAT.match(text):
        return _float(text)
    if text[:1] in "&*!|>@`%" or text.startswith(("- ", "? ")):
        raise ValueError(f"YAML feature outside the supported subset: "
                         f"{text!r}")
    return text


def _strip_comment(line: str) -> str:
    """``line`` without a ``#`` comment (one at the start or after
    whitespace, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _flow(text: str, pos: int = 0) -> Tuple[Any, int]:
    """One flow value (a ``[...]`` list, a ``{...}`` map or a scalar)
    starting at ``pos``; returns (value, position after it)."""
    while pos < len(text) and text[pos] == " ":
        pos += 1
    if pos < len(text) and text[pos] in "[{":
        close = "]" if text[pos] == "[" else "}"
        is_map = close == "}"
        items: Any = {} if is_map else []
        pos += 1
        while True:
            while pos < len(text) and text[pos] == " ":
                pos += 1
            if pos >= len(text):
                raise ValueError(f"unclosed flow collection: {text!r}")
            if text[pos] == close:
                return items, pos + 1
            if is_map:
                colon = text.index(":", pos)
                key = _scalar(text[pos:colon])
                value, pos = _flow(text, colon + 1)
                items[key] = value
            else:
                value, pos = _flow(text, pos)
                items.append(value)
            while pos < len(text) and text[pos] == " ":
                pos += 1
            if pos < len(text) and text[pos] == ",":
                pos += 1
    end = pos
    if pos < len(text) and text[pos] in "'\"":
        end = pos + 1
        while end < len(text) and not (
                text[end] == text[pos]
                and text[end:end + 2] != text[pos] * 2):
            end += 2 if text[end:end + 2] == text[pos] * 2 else 1
        return _scalar(text[pos:end + 1]), end + 1
    while end < len(text) and text[end] not in ",]}":
        end += 1
    return _scalar(text[pos:end]), end


def _value(text: str) -> Any:
    text = text.strip()
    if text[:1] in "[{":
        value, end = _flow(text)
        if text[end:].strip():
            raise ValueError(f"text after a flow collection: {text!r}")
        return value
    return _scalar(text)


def parse_yaml(text: str) -> Any:
    """The value of a YAML document in the supported subset (see the
    module's docstring)."""
    lines: List[Tuple[int, str]] = []
    for raw in text.splitlines():
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError("tabs in YAML indentation")
        line = _strip_comment(raw).rstrip()
        if line.strip() in ("", "---"):
            continue
        lines.append((len(line) - len(line.lstrip()), line.strip()))
    if not lines:
        return None

    def block(i: int, indent: int) -> Tuple[dict, int]:
        out: dict = {}
        while i < len(lines):
            ind, body = lines[i]
            if ind < indent:
                break
            if ind > indent:
                raise ValueError(f"unexpected indentation: {body!r}")
            if body.startswith("- "):
                raise ValueError(f"block sequences are not read: {body!r}")
            m = re.match(r"^((?:'[^']*'|\"[^\"]*\"|[^:])+?)\s*:(?:\s+(.*))?$",
                         body)
            if m is None:
                raise ValueError(f"not a mapping entry: {body!r}")
            key, rest = _scalar(m.group(1)), m.group(2)
            i += 1
            if rest:
                out[key] = _value(rest)
            elif i < len(lines) and lines[i][0] > indent:
                out[key], i = block(i, lines[i][0])
            else:
                out[key] = None
        return out, i

    if len(lines) == 1 and lines[0][1][:1] in "[{":
        return _value(lines[0][1])
    tree, end = block(0, lines[0][0])
    if end != len(lines):
        raise ValueError(f"unexpected dedent: {lines[end][1]!r}")
    return tree


def load_config(path: str) -> AttrDict:
    with open(path) as f:
        return AttrDict.convert(parse_yaml(f.read()))


def parse_value(value: str, original: Any = None):
    """Type-inferring scalar/list parser (reference: diffusion/utils.py:33-68)."""
    value = value.strip()
    low = value.lower()
    if "," in value:
        return [parse_value(v) for v in value.split(",")]
    if low == "none":
        ret: Any = None
    elif low == "true":
        ret = True
    elif low == "false":
        ret = False
    else:
        try:
            ret = int(value)
        except ValueError:
            try:
                ret = float(value)
            except ValueError:
                ret = value
    if isinstance(original, (list, tuple)) and not isinstance(ret, list):
        return [ret]
    return ret


def override_config(config: AttrDict, hparams: str) -> AttrDict:
    """Apply ``"a.b=c x=1,2"`` style dot-path overrides in place."""
    for item in hparams.strip().split():
        if "=" not in item:
            continue
        key, value = item.split("=", 1)
        keys = key.split(".")
        node = config
        for k in keys[:-1]:
            if k not in node or not isinstance(node[k], dict):
                node[k] = AttrDict()
            node = node[k]
        node[keys[-1]] = parse_value(value, node.get(keys[-1]))
    return config


def instantiate(target: str, /, **kwargs):
    """Resolve a dotted ``module.Class`` path and construct it — the
    OmegaConf ``target:`` pattern that makes dense<->SIGE a two-line
    config diff (reference: stable-diffusion/configs/{original,sige}.yaml)."""
    module, _, name = target.rpartition(".")
    return getattr(importlib.import_module(module), name)(**kwargs)
