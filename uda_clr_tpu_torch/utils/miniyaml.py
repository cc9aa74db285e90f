"""A reader and writer for the YAML subset of the repo's config files, so
the port needs no PyYAML.

The subset: nested block mappings, block sequences (``- item``) and flow
sequences (``[a, b]``) of scalars, comments, plain, single- and
double-quoted scalars. Plain scalars resolve as PyYAML's ``safe_load``
resolves them (YAML 1.1): ``1.0e-3`` and ``2.5e-05`` are floats but ``1e-3``
is a string (its float pattern needs a dot and a signed exponent), ``yes``
and ``off`` are booleans, ``~`` and an empty value are null. Anything else
(anchors, tags, flow mappings, multi-line scalars) raises ``ValueError``.

``dump`` writes what ``yaml.safe_dump(d, default_flow_style=False)`` writes
for such data: sorted keys, two-space indentation, block sequences at the
key's indentation, floats as ``repr`` with ``.0`` inserted before a bare
exponent, and single quotes around strings that would resolve to another
type.
"""

from __future__ import annotations

import math
import re

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                  |[-+]?0[0-7_]+
                  |[-+]?(?:0|[1-9][0-9_]*)
                  |[-+]?0x[0-9a-fA-F_]+
                  |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")


def _sexagesimal(digits: str) -> float:
    value = 0.0
    for part in digits.split(":"):
        value = value * 60 + float(part)
    return value


def _to_int(s: str) -> int:
    s = s.replace("_", "")
    sign = -1 if s[0] == "-" else 1
    s = s.lstrip("+-")
    if s == "0":
        return 0
    if s.startswith("0b"):
        return sign * int(s[2:], 2)
    if s.startswith("0x"):
        return sign * int(s[2:], 16)
    if s[0] == "0":
        return sign * int(s, 8)
    if ":" in s:
        return sign * int(_sexagesimal(s))
    return sign * int(s)


def _to_float(s: str) -> float:
    s = s.replace("_", "").lower()
    sign = -1.0 if s[0] == "-" else 1.0
    s = s.lstrip("+-")
    if s == ".inf":
        return sign * math.inf
    if s == ".nan":
        return math.nan
    if ":" in s:
        return sign * _sexagesimal(s)
    return sign * float(s)


def resolve_plain(s: str):
    """The value PyYAML's resolver gives an unquoted scalar."""
    if _NULL.match(s):
        return None
    if _BOOL.match(s):
        return s in _TRUE
    if _INT.match(s):
        return _to_int(s)
    if _FLOAT.match(s):
        return _to_float(s)
    if _TIMESTAMP.match(s):
        raise ValueError(f"timestamps are outside the supported YAML subset: {s!r}")
    return s


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment that starts the line or follows whitespace,
    outside quotes."""
    quote = None
    skip = False
    for i, c in enumerate(line):
        if skip:
            skip = False
        elif quote:
            if c == "'" == quote and line[i + 1:i + 2] == "'":
                skip = True  # '' escapes a quote inside single quotes
            elif c == quote:
                quote = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t[,:-"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _scalar(text: str):
    text = text.strip()
    if text.startswith("'"):
        if len(text) < 2 or not text.endswith("'"):
            raise ValueError(f"unterminated quoted scalar {text!r}")
        return text[1:-1].replace("''", "'")
    if text.startswith('"'):
        if len(text) < 2 or not text.endswith('"'):
            raise ValueError(f"unterminated quoted scalar {text!r}")
        body = text[1:-1]
        escapes = {"\\\\": "\\", '\\"': '"', "\\n": "\n", "\\t": "\t", "\\/": "/"}
        return re.sub(r"\\.", lambda m: escapes.get(m.group(0), m.group(0)), body)
    if text[:1] in "&*!|>{%@`":
        raise ValueError(f"outside the supported YAML subset: {text!r}")
    return resolve_plain(text)


def _value(text: str):
    text = text.strip()
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"unterminated flow sequence {text!r}")
        inner = text[1:-1].strip()
        return [_scalar(item) for item in inner.split(",")] if inner else []
    return _scalar(text)


def load(text: str):
    """Parse ``text``; an empty document gives None, as ``safe_load``."""
    lines = []
    for raw in text.splitlines():
        if raw.strip() in ("---", "..."):
            continue
        line = _strip_comment(raw)
        if line.strip():
            if "\t" in line[: len(line) - len(line.lstrip())]:
                raise ValueError(f"tab indentation: {raw!r}")
            lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    if not lines:
        return None
    value, pos = _block(lines, 0, lines[0][0])
    if pos != len(lines):
        raise ValueError(f"unexpected line {lines[pos][1]!r}")
    return value


def _split_key(body: str):
    m = re.match(r"^('(?:[^']|'')*'|\"[^\"]*\"|[^'\"][^:]*?)\s*:(?:\s+(.*))?$", body)
    if m is None:
        raise ValueError(f"expected 'key: value', got {body!r}")
    key = _scalar(m.group(1))
    return key, m.group(2)


def _block(lines, pos: int, indent: int):
    if lines[pos][1].startswith("- ") or lines[pos][1] == "-":
        return _sequence(lines, pos, indent)
    out = {}
    while pos < len(lines) and lines[pos][0] == indent:
        body = lines[pos][1]
        if body.startswith("-"):
            raise ValueError(f"sequence item inside a mapping: {body!r}")
        key, rest = _split_key(body)
        if key in out:
            raise ValueError(f"duplicate key {key!r}")
        pos += 1
        if rest is not None and rest.strip():
            out[key] = _value(rest)
        elif pos < len(lines) and (lines[pos][0] > indent or (
                lines[pos][0] == indent and lines[pos][1].startswith("-"))):
            out[key], pos = _block(lines, pos, lines[pos][0])
        else:
            out[key] = None
    if pos < len(lines) and lines[pos][0] > indent:
        raise ValueError(f"bad indentation at {lines[pos][1]!r}")
    return out, pos


def _sequence(lines, pos: int, indent: int):
    out = []
    while pos < len(lines) and lines[pos][0] == indent and (
            lines[pos][1].startswith("- ") or lines[pos][1] == "-"):
        item = lines[pos][1][1:].strip()
        if ":" in item and not item.startswith(("'", '"', "[")):
            raise ValueError(f"mappings inside sequences are outside the subset: {item!r}")
        out.append(_value(item))
        pos += 1
    return out, pos


def _plain_ok(s: str) -> bool:
    if not s or resolve_plain(s) != s or s != s.strip():
        return False
    if s[0] in "-?:,[]{}#&*!|>'\"%@`" or ": " in s or " #" in s or s.endswith(":"):
        return False
    return all(c.isprintable() for c in s)


def _scalar_text(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (math.inf, -math.inf):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(v, str):
        return v if _plain_ok(v) else "'" + v.replace("'", "''") + "'"
    raise TypeError(f"cannot write {type(v).__name__} to YAML")


def dump(data: dict) -> str:
    """Block-style YAML of a nested dict of scalars and scalar lists."""
    out: list[str] = []

    def emit(d: dict, indent: int):
        for k in sorted(d):
            v = d[k]
            pad = " " * indent
            if isinstance(v, dict):
                if v:
                    out.append(f"{pad}{_scalar_text(k)}:")
                    emit(v, indent + 2)
                else:
                    out.append(f"{pad}{_scalar_text(k)}: {{}}")
            elif isinstance(v, (list, tuple)):
                if v:
                    out.append(f"{pad}{_scalar_text(k)}:")
                    out.extend(f"{pad}- {_scalar_text(item)}" for item in v)
                else:
                    out.append(f"{pad}{_scalar_text(k)}: []")
            else:
                out.append(f"{pad}{_scalar_text(k)}: {_scalar_text(v)}")

    emit(data, 0)
    return "\n".join(out) + "\n"
