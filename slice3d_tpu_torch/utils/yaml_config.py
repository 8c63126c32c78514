"""The CLI's YAML configs without PyYAML: a reader and writer of the subset
that ``configs/*.yaml`` use, and ``main.py``'s config merging.

The subset: block mappings and block sequences (indented or at the key's
indentation), flow sequences and flow mappings on one line, plain,
single-quoted and double-quoted scalars, comments and blank lines.  Plain
scalars resolve as PyYAML's ``safe_load`` resolves them (YAML 1.1): ``null``
/ ``~`` / empty, the eight spellings of true and false (yes/no/on/off
included), decimal ints with ``_`` separators, and floats only in
PyYAML's dotted form (``5.0e-05``; ``1e-6`` stays a string, as there).
Anything else that YAML means (anchors, aliases, tags, block scalars,
multi-line scalars or flows, documents markers, octal, hex, sexagesimal or
timestamp scalars, complex keys) raises a ``ValueError`` with its line
number instead of being read some other way.

``load_config`` / ``deep_merge`` / ``apply_dotlist`` are the root
``main.py``'s (``main.py:72-105``); ``dump_yaml`` writes a tree of dicts,
lists and scalars that PyYAML reads back equal (the run's
``configs/merged.yaml``).
"""

from __future__ import annotations

import math
import re
from typing import Any, Iterable, List, Optional, Tuple

__all__ = ["load_yaml", "dump_yaml", "load_config", "deep_merge", "apply_dotlist"]

_BOOL = {**{s: True for s in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")},
         **{s: False for s in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off",
                               "OFF")}}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
# what YAML 1.1 also resolves (PyYAML's int/float/timestamp/merge/value
# resolvers) and this reader refuses rather than misread
_OTHER = re.compile(r"(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
                    r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?.*|<<|=)$")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": " ", "P": " "}


class _Error(ValueError):
    pass


def _fail(lineno: int, what: str):
    raise _Error(f"line {lineno}: {what} (the YAML subset read without PyYAML: block "
                 "and one-line flow collections, plain or quoted scalars, comments)")


def resolve_plain(text: str, lineno: int = 0) -> Any:
    """A plain scalar as PyYAML's safe_load resolves it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return -math.inf if text.startswith("-") else math.inf
    if _NAN.match(text):
        return math.nan
    if _OTHER.match(text):
        _fail(lineno, f"scalar {text!r} (octal, hex, binary, sexagesimal, timestamp or "
                      "merge key)")
    if text[0] in "&*!|>%@`,[]{}#" or text.startswith(("- ", "? ", ": ")) or text in "-?:":
        _fail(lineno, f"{text!r} starts with a YAML indicator")
    if ": " in text or text.endswith(":"):
        _fail(lineno, f"{text!r}: a mapping inside a plain scalar")
    return text


class _Scanner:
    """One line's flow content: scalars, quoted strings, [...] and {...}."""

    def __init__(self, text: str, lineno: int):
        self.s, self.i, self.lineno = text, 0, lineno

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i] == " ":
            self.i += 1

    def done(self) -> bool:
        self._ws()
        return self.i >= len(self.s)

    def _quoted(self) -> str:
        q = self.s[self.i]
        self.i += 1
        out = []
        while True:
            if self.i >= len(self.s):
                _fail(self.lineno, "a quoted scalar that does not close on its line")
            c = self.s[self.i]
            if q == "'" and c == "'":
                if self.s[self.i + 1:self.i + 2] == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if q == '"' and c == '"':
                self.i += 1
                return "".join(out)
            if q == '"' and c == "\\":
                e = self.s[self.i + 1:self.i + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    self.i += 2
                    continue
                n = {"x": 2, "u": 4, "U": 8}.get(e)
                code = self.s[self.i + 2:self.i + 2 + (n or 0)]
                if not n or len(code) != n or not re.fullmatch(r"[0-9a-fA-F]+", code):
                    _fail(self.lineno, f"escape \\{e} in a double-quoted scalar")
                out.append(chr(int(code, 16)))
                self.i += 2 + n
                continue
            out.append(c)
            self.i += 1

    def _plain(self, flow: bool) -> str:
        """A plain scalar's text: to the line's end, or in a flow to the next
        ``,``, ``]``, ``}`` or ``: ``."""
        start = self.i
        while flow and self.i < len(self.s):
            c = self.s[self.i]
            if c in ",]}" or (c == ":" and self.s[self.i + 1:self.i + 2] in ("", " ")):
                break
            self.i += 1
        if not flow:
            self.i = len(self.s)
        return self.s[start:self.i].strip()

    def value(self, flow: bool) -> Any:
        """A scalar or flow collection; in a flow, plain scalars stop at
        ``,``, ``]``, ``}`` and ``: ``."""
        self._ws()
        if flow and self.i >= len(self.s):
            _fail(self.lineno, "a flow collection that does not close on its line")
        c = self.s[self.i:self.i + 1]
        if c == "[":
            self.i += 1
            out: List[Any] = []
            while True:
                self._ws()
                if self.s[self.i:self.i + 1] == "]":
                    self.i += 1
                    return out
                out.append(self.value(True))
                self._ws()
                nxt = self.s[self.i:self.i + 1]
                self.i += 1
                if nxt == "]":
                    return out
                if nxt != ",":
                    _fail(self.lineno, "a flow sequence that does not close on its line")
        if c == "{":
            self.i += 1
            out_m = {}
            while True:
                self._ws()
                if self.s[self.i:self.i + 1] == "}":
                    self.i += 1
                    return out_m
                key = self.value(True)
                self._ws()
                if self.s[self.i:self.i + 1] != ":":
                    _fail(self.lineno, "a flow mapping entry without ': '")
                self.i += 1
                out_m[key] = self.value(True)
                self._ws()
                nxt = self.s[self.i:self.i + 1]
                self.i += 1
                if nxt == "}":
                    return out_m
                if nxt != ",":
                    _fail(self.lineno, "a flow mapping that does not close on its line")
        if c in ("'", '"'):
            return self._quoted()
        text = self._plain(flow)
        if not text and flow:
            _fail(self.lineno, "an empty entry in a flow collection")
        return resolve_plain(text, self.lineno)


def _strip_comment(line: str) -> str:
    """The line without its comment (a ``#`` at its start or after a space,
    outside quotes)."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
            continue
        if c in "'\"" and (i == 0 or line[i - 1] in " [{,:-"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] == " "):
            return line[:i].rstrip()
    return line.rstrip()


def _split_key(text: str, lineno: int) -> Optional[Tuple[Any, str]]:
    """``key: rest`` -> (key, rest), or None when the text is no mapping
    entry."""
    sc = _Scanner(text, lineno)
    if text[:1] in "'\"":
        key = sc._quoted()
    elif text[:1] in "[{":
        return None
    else:
        key = None
        i = 0
        while True:
            i = text.find(":", i)
            if i < 0:
                return None
            if text[i + 1:i + 2] in ("", " "):
                break
            i += 1
        sc.i = i
        key = resolve_plain(text[:i].strip(), lineno)
    sc._ws()
    if sc.s[sc.i:sc.i + 1] != ":" or sc.s[sc.i + 1:sc.i + 2] not in ("", " "):
        return None if text[:1] not in "'\"" else _fail(lineno, "a quoted key without ': '")
    if isinstance(key, (list, dict)):
        _fail(lineno, "a collection as a mapping key")
    return key, text[sc.i + 1:].strip()


class _Parser:
    def __init__(self, text: str):
        self.lines: List[Tuple[int, int, str]] = []
        for n, raw in enumerate(text.splitlines(), 1):
            line = _strip_comment(raw)
            if not line.strip():
                continue
            body = line.lstrip(" ")
            if body.startswith("\t"):
                _fail(n, "a tab in the indentation")
            if line.startswith(("---", "...", "%")):
                _fail(n, "a document marker or directive")
            self.lines.append((n, len(line) - len(body), body))
        self.k = 0

    def _scalar_line(self, text: str, lineno: int) -> Any:
        sc = _Scanner(text, lineno)
        val = sc.value(False)
        if not sc.done():
            _fail(lineno, f"text after a value: {text!r}")
        return val

    def parse(self) -> Any:
        if not self.lines:
            return None
        if self.lines[0][1] != 0:
            _fail(self.lines[0][0], "a document that does not start at column 0")
        out = self.node(0)
        if self.k < len(self.lines):
            _fail(self.lines[self.k][0], "unexpected indentation")
        return out

    def node(self, indent: int) -> Any:
        lineno, ind, text = self.lines[self.k]
        if text == "-" or text.startswith("- "):
            return self.sequence(ind)
        entry = _split_key(text, lineno)
        if entry is None:
            self.k += 1
            return self._scalar_line(text, lineno)
        return self.mapping(ind)

    def _value_after(self, lineno: int, ind: int, rest: str, seq_ok: bool) -> Any:
        """The value of an entry whose inline text is ``rest``: inline, or
        the block below (deeper, or a sequence at the same indentation when
        ``seq_ok``)."""
        if rest:
            return self._scalar_line(rest, lineno)
        if self.k < len(self.lines):
            _, nind, ntext = self.lines[self.k]
            if nind > ind or (seq_ok and nind == ind
                              and (ntext == "-" or ntext.startswith("- "))):
                return self.node(nind)
        return None

    def mapping(self, ind: int) -> dict:
        out = {}
        while self.k < len(self.lines):
            lineno, lind, text = self.lines[self.k]
            if lind < ind:
                break
            if lind > ind:
                _fail(lineno, "unexpected indentation")
            if text == "-" or text.startswith("- "):
                break
            entry = _split_key(text, lineno)
            if entry is None:
                _fail(lineno, f"expected 'key: value', got {text!r}")
            self.k += 1
            key, rest = entry
            out[key] = self._value_after(lineno, ind, rest, True)
        return out

    def sequence(self, ind: int) -> list:
        out = []
        while self.k < len(self.lines):
            lineno, lind, text = self.lines[self.k]
            if lind < ind or not (text == "-" or text.startswith("- ")):
                if lind > ind:
                    _fail(lineno, "unexpected indentation")
                break
            if lind > ind:
                _fail(lineno, "unexpected indentation")
            rest = text[1:].lstrip(" ")
            if not rest:
                self.k += 1
                out.append(self._value_after(lineno, ind, "", False))
                continue
            # "- content": the content is a node at its own column
            col = ind + len(text) - len(rest)
            self.lines[self.k] = (lineno, col, rest)
            out.append(self.node(col))
        return out


def load_yaml(text: str) -> Any:
    """Parse YAML ``text`` of the subset; what ``yaml.safe_load`` gives."""
    return _Parser(text).parse()


def _dump_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:  # 5e-05 -> 5.0e-05, as PyYAML writes it
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(v, str):
        plain = re.fullmatch(r"[A-Za-z_./][A-Za-z0-9_./ -]*[A-Za-z0-9_./]|[A-Za-z_./]", v)
        try:
            same = plain is not None and resolve_plain(v) == v
        except ValueError:
            same = False
        return v if same else "'" + v.replace("'", "''") + "'"
    raise TypeError(f"cannot write {type(v).__name__} {v!r} as YAML")


def _dump(v: Any, indent: int) -> Iterable[str]:
    pad = " " * indent
    if isinstance(v, dict):
        for k, item in v.items():
            key = _dump_scalar(k)
            if isinstance(item, dict) and item:
                yield f"{pad}{key}:"
                yield from _dump(item, indent + 2)
            elif isinstance(item, (list, tuple)) and item and any(
                    isinstance(x, (dict, list, tuple)) for x in item):
                yield f"{pad}{key}:"
                yield from _dump(list(item), indent + 2)
            else:
                yield f"{pad}{key}: {_inline(item)}"
    else:
        for item in v:
            if isinstance(item, (dict, list, tuple)) and item:
                lines = list(_dump(item, indent + 2))
                yield f"{pad}- {lines[0][indent + 2:]}"
                yield from lines[1:]
            else:
                yield f"{pad}- {_inline(item)}"


def _inline(v: Any) -> str:
    if isinstance(v, dict):
        return "{" + ", ".join(f"{_dump_scalar(k)}: {_inline(x)}" for k, x in v.items()) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_inline(x) for x in v) + "]"
    return _dump_scalar(v)


def dump_yaml(tree: Any) -> str:
    """YAML text of a tree of dicts, lists and scalars (block mappings, flow
    lists of scalars) that ``yaml.safe_load`` and :func:`load_yaml` read
    back equal."""
    if not isinstance(tree, dict):
        return _inline(tree) + "\n"
    return "\n".join(_dump(tree, 0)) + "\n" if tree else "{}\n"


def deep_merge(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def apply_dotlist(cfg: dict, items) -> dict:
    """``a.b.c=value`` overrides (the value read as YAML), in place; items
    without ``=`` are skipped, as ``main.py`` skips them."""
    for item in items:
        if "=" not in item:
            continue
        key, val = item.split("=", 1)
        node = cfg
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = load_yaml(val)
    return cfg


def load_config(bases, dotlist) -> dict:
    """The ``-b`` files merged in order, then the dotlist overrides."""
    cfg: dict = {}
    for path in bases:
        with open(path) as f:
            try:
                cfg = deep_merge(cfg, load_yaml(f.read()) or {})
            except _Error as err:
                raise ValueError(f"{path}: {err}") from None
    return apply_dotlist(cfg, dotlist)
