"""A reader of the YAML subset that the config loaders use, without PyYAML.

`utils/config_io.py` and `utils/arguments.py` read their YAML and JSON
files here (the JAX package reads both with ``yaml.safe_load``; PyYAML is
not a dependency of the port).  On every text inside the subset the result
equals ``yaml.safe_load``'s, YAML 1.1 scalar rules included; so does
`load_json`'s on a JSON text.  The subset:

- block mappings and block sequences, nested by indentation (a sequence may
  sit at its key's own indentation; ``- key: value`` opens a mapping item);
- flow sequences ``[a, b]`` and flow mappings ``{k: v}`` on one line;
- plain, single-quoted and double-quoted scalars on one line;
- ints (decimal, ``0x``, ``0b``, ``0`` octal, ``_`` separators, ``a:b``
  base 60), floats (``1.5``, ``1.0e-4``, ``.inf``, ``.nan``), bools
  (``true``, ``yes``, ``on`` ...), null (``~``, ``null``, empty);
- comments, blank lines, one leading ``---``;
- any key, ``_BASE_`` included (its meaning is the caller's).

Anything else raises `YAMLSubsetError` naming the line: anchors, aliases,
tags, block scalars (``|``, ``>``), multi-line scalars and flows, complex
keys (``?``), merge keys (``<<``), timestamps, directives, more than one
document, tabs.  It never guesses.
"""

from __future__ import annotations

import json
import math
import re
from typing import Any, List, Optional, Tuple

# YAML 1.1's implicit scalar types, as PyYAML resolves them (the first
# character picks the candidates).
_BOOL = re.compile(r"""^(?:yes|Yes|YES|no|No|NO
                    |true|True|TRUE|false|False|FALSE
                    |on|On|ON|off|Off|OFF)$""", re.X)
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
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)

_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": "\u2028",
            "P": "\u2029"}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}
# characters that may not open a plain scalar; the first group is outside
# the subset, the second is an error in YAML itself
_OUTSIDE = {"&": "an anchor", "*": "an alias", "!": "a tag", "|": "a block scalar",
            ">": "a block scalar", "?": "a complex key"}
_INVALID = set(",[]{}#@`%")


class YAMLSubsetError(ValueError):
    """The text lies outside the subset (or is not YAML at all)."""


class _Line:
    __slots__ = ("indent", "text", "no")

    def __init__(self, indent: int, text: str, no: int):
        self.indent, self.text, self.no = indent, text, no


def _err(no: int, msg: str) -> YAMLSubsetError:
    return YAMLSubsetError(f"line {no}: {msg}")


def _quote_end(text: str, start: int, no: int) -> int:
    """Index just past the quoted scalar that opens at ``text[start]``."""
    q = text[start]
    i = start + 1
    while i < len(text):
        c = text[i]
        if q == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                i += 2
                continue
            return i + 1
        if q == '"':
            if c == "\\":
                i += 2
                continue
            if c == '"':
                return i + 1
        i += 1
    raise _err(no, "a quoted scalar that does not close on its line "
                   "(multi-line scalars are outside the subset)")


def _opens_token(text: str, i: int) -> bool:
    """Whether a quote at ``text[i]`` starts a scalar (and is not inside a
    plain one): at the start, or after whitespace that follows an indicator,
    or right after a flow indicator."""
    if i == 0:
        return True
    if text[i - 1] in "[{,":
        return True
    if text[i - 1] != " ":
        return False
    j = i - 1
    while j >= 0 and text[j] == " ":
        j -= 1
    return j < 0 or text[j] in "-:[{,"


def _strip_comment(text: str, no: int) -> str:
    i = 0
    while i < len(text):
        c = text[i]
        if c in "'\"" and _opens_token(text, i):
            i = _quote_end(text, i, no)
            continue
        if c == "#" and (i == 0 or text[i - 1] == " "):
            return text[:i].rstrip(" ")
        i += 1
    return text.rstrip(" ")


def _lines(text: str) -> List[_Line]:
    out: List[_Line] = []
    started = False
    for no, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw:
            raise _err(no, "a tab (outside the subset)")
        body = raw.lstrip(" ")
        indent = len(raw) - len(body)
        if indent == 0 and (body.startswith("---") or body.startswith("...")):
            marker = body[:3]
            rest = body[3:]
            if rest == "" or rest[0] == " ":
                if marker == "---" and not started and not _strip_comment(rest, no):
                    started = True
                    continue
                raise _err(no, f"document marker {marker!r} (one document only, "
                               "with at most a leading '---')")
        body = _strip_comment(body, no)
        if not body:
            continue
        if indent == 0 and body[0] == "%":
            raise _err(no, "a directive (outside the subset)")
        started = True
        out.append(_Line(indent, body, no))
    return out


def _resolve_plain(s: str, no: int) -> Any:
    first = s[:1]
    if first in _OUTSIDE:
        raise _err(no, f"{_OUTSIDE[first]} ({s!r}) is outside the subset")
    if first in _INVALID or s.startswith("- ") or s == "-" or s.startswith(": "):
        raise _err(no, f"a plain scalar may not start with {first!r} ({s!r})")
    if first in "yYnNtTfFoO" and _BOOL.match(s):
        return s.lower() in ("yes", "true", "on")
    if first in "-+0123456789." and _FLOAT.match(s):
        v = s.replace("_", "").lower()
        sign = -1 if v[0] == "-" else 1
        if v[0] in "+-":
            v = v[1:]
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        if ":" in v:
            return sign * _base60([float(p) for p in v.split(":")], 0.0)
        return sign * float(v)
    if first in "-+0123456789" and _INT.match(s):
        v = s.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        if v[0] in "+-":
            v = v[1:]
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        if ":" in v:
            return sign * _base60([int(p) for p in v.split(":")], 0)
        return sign * int(v)
    if s == "<<":
        raise _err(no, "a merge key '<<' is outside the subset")
    if s == "=":
        raise _err(no, "the value key '=' is not a scalar")
    if first in "~nN" and _NULL.match(s):
        return None
    if first in "0123456789" and _TIMESTAMP.match(s):
        raise _err(no, f"a timestamp ({s!r}) is outside the subset")
    return s


def _base60(digits, zero):
    value, base = zero, 1
    for d in reversed(digits):
        value += d * base
        base *= 60
    return value


def _unquote(s: str, no: int) -> str:
    if s[0] == "'":
        return s[1:-1].replace("''", "'")
    out, i, body = [], 0, s[1:-1]
    while i < len(body):
        c = body[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        e = body[i + 1:i + 2]
        if e in _ESCAPES:
            out.append(_ESCAPES[e])
            i += 2
        elif e in _ESCAPE_CODES:
            n = _ESCAPE_CODES[e]
            code = body[i + 2:i + 2 + n]
            if len(code) != n or any(ch not in "0123456789abcdefABCDEF" for ch in code):
                raise _err(no, f"a bad escape \\{e}{code} in {s!r}")
            out.append(chr(int(code, 16)))
            i += 2 + n
        else:
            raise _err(no, f"an unknown escape \\{e} in {s!r}")
    return "".join(out)


def _key_split(text: str, no: int) -> Optional[Tuple[Any, str]]:
    """(key, rest) if ``text`` is a ``key: value`` entry, else None."""
    if text[0] in "'\"":
        end = _quote_end(text, 0, no)
        rest = text[end:].lstrip(" ")
        if rest == ":" or rest.startswith(": "):
            return _unquote(text[:end], no), rest[1:].strip(" ")
        return None
    if text[0] in "[{":
        return None
    for i, c in enumerate(text):
        if c == ":" and (i + 1 == len(text) or text[i + 1] == " "):
            key = text[:i].rstrip(" ")
            if not key:
                raise _err(no, "an empty key")
            return _resolve_plain(key, no), text[i + 1:].strip(" ")
    return None


def _hashable(key: Any, no: int) -> Any:
    try:
        hash(key)
    except TypeError:
        raise _err(no, f"an unhashable key {key!r}") from None
    return key


class _Flow:
    """One-line flow collections: ``[a, [b], {c: d}]``."""

    def __init__(self, text: str, no: int):
        self.s, self.i, self.no = text, 0, no

    def _skip(self) -> None:
        while self.i < len(self.s) and self.s[self.i] == " ":
            self.i += 1

    def _peek(self) -> str:
        self._skip()
        return self.s[self.i:self.i + 1]

    def node(self) -> Any:
        c = self._peek()
        if c == "[":
            return self._seq()
        if c == "{":
            return self._map()
        if c in ("'", '"'):
            start = self.i
            self.i = _quote_end(self.s, start, self.no)
            return _unquote(self.s[start:self.i], self.no)
        start = self.i
        while self.i < len(self.s) and self.s[self.i] not in ",[]{}":
            if self.s[self.i] == ":" and self.s[self.i + 1:self.i + 2] in (" ", ",", "]", "}", ""):
                break
            self.i += 1
        plain = self.s[start:self.i].strip(" ")
        if not plain:
            raise _err(self.no, f"an empty entry in a flow collection ({self.s!r})")
        return _resolve_plain(plain, self.no)

    def _entries(self, close: str, pair: bool):
        self.i += 1
        items = []
        while True:
            if self._peek() == close:
                self.i += 1
                return items
            if not self._peek():
                raise _err(self.no, "a flow collection that does not close on its line "
                                    "(multi-line flows are outside the subset)")
            key = self.node()
            if self._peek() == ":":
                if not pair:
                    raise _err(self.no, "a 'key: value' pair inside a flow sequence is "
                                        "outside the subset")
                self.i += 1
                value = None if self._peek() in (",", close) else self.node()
            elif pair:
                value = None
            items.append((key, value) if pair else key)
            c = self._peek()
            if c == ",":
                self.i += 1
            elif c != close:
                raise _err(self.no, f"expected ',' or {close!r} in {self.s!r}")

    def _seq(self) -> list:
        return self._entries("]", False)

    def _map(self) -> dict:
        return {_hashable(k, self.no): v for k, v in self._entries("}", True)}


def _inline(text: str, no: int) -> Any:
    """A value written on its line: a flow collection or a scalar."""
    c = text[0]
    if c in "[{":
        flow = _Flow(text, no)
        value = flow.node()
        if flow._peek():
            raise _err(no, f"text after a flow collection: {text[flow.i:]!r}")
        return value
    if c in "'\"":
        end = _quote_end(text, 0, no)
        if text[end:].strip(" "):
            raise _err(no, f"text after a quoted scalar: {text[end:]!r}")
        return _unquote(text, no)
    if ": " in text or text.endswith(":"):
        raise _err(no, f"a mapping inside a plain scalar ({text!r})")
    return _resolve_plain(text, no)


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


class _Parser:
    def __init__(self, lines: List[_Line]):
        self.lines, self.i = lines, 0

    def _cur(self) -> Optional[_Line]:
        return self.lines[self.i] if self.i < len(self.lines) else None

    def node(self, parent: int) -> Any:
        """The block that starts at the current line, under an entry at
        indentation ``parent`` (-1 for the document)."""
        line = self._cur()
        if _is_item(line.text):
            return self._seq(line.indent)
        if _key_split(line.text, line.no) is not None:
            return self._map(line.indent)
        self.i += 1
        value = _inline(line.text, line.no)
        self._no_continuation(parent)
        return value

    def _no_continuation(self, parent: int) -> None:
        nxt = self._cur()
        if nxt is not None and nxt.indent > parent:
            raise _err(nxt.no, "a continuation line (multi-line scalars are outside "
                               "the subset)")

    def _nested(self, indent: int, allow_seq_at_indent: bool) -> Any:
        """The block under an entry with no value on its line: deeper lines,
        or a sequence at the entry's own indentation (mappings only)."""
        nxt = self._cur()
        if nxt is None:
            return None
        if nxt.indent > indent:
            return self.node(indent)
        if allow_seq_at_indent and nxt.indent == indent and _is_item(nxt.text):
            return self._seq(indent)
        return None

    def _map(self, indent: int) -> dict:
        out: dict = {}
        while True:
            line = self._cur()
            if line is None or line.indent < indent:
                return out
            if line.indent > indent:
                raise _err(line.no, "unexpected indentation")
            split = _key_split(line.text, line.no)
            if split is None:
                raise _err(line.no, f"expected 'key: value' in a mapping, got {line.text!r}")
            key, rest = split
            key = _hashable(key, line.no)
            self.i += 1
            if rest:
                if _is_item(rest):
                    raise _err(line.no, f"a sequence entry after a key on one line ({rest!r})")
                out[key] = _inline(rest, line.no)
                self._no_continuation(indent)
            else:
                out[key] = self._nested(indent, True)

    def _seq(self, indent: int) -> list:
        out: list = []
        while True:
            line = self._cur()
            if line is None or line.indent < indent:
                return out
            if line.indent > indent:
                raise _err(line.no, "unexpected indentation")
            if not _is_item(line.text):
                return out
            body = line.text[1:]
            content = body.lstrip(" ")
            if not content:
                self.i += 1
                out.append(self._nested(indent, False))
                continue
            # the item's content as a line of its own, at its column
            col = indent + 1 + len(body) - len(content)
            self.lines[self.i] = _Line(col, content, line.no)
            out.append(self.node(indent))


def load(text: str) -> Any:
    """``yaml.safe_load(text)`` for a text inside the subset."""
    lines = _lines(text)
    if not lines:
        return None
    parser = _Parser(lines)
    value = parser.node(-1)
    rest = parser._cur()
    if rest is not None:
        raise _err(rest.no, f"unexpected text {rest.text!r} (indentation does not "
                            "match an open block, or a multi-line scalar)")
    return value


# characters PyYAML's reader refuses anywhere in a stream, and the raw line
# breaks of YAML 1.1, which a double-quoted scalar folds or trims around
# (JSON keeps them as they are)
_JSON_REFUSED = re.compile("[^\x09\x0A\x0D\x20-\x7E\xA0-\u2027\u202A-\uD7FF"
                           "\uE000-\uFFFD\U00010000-\U0010FFFF]")
_JSON_STRING = re.compile(r'"(?:[^"\\]|\\.)*"')
_JSON_ESCAPE = re.compile(r"\\(u[0-9a-fA-F]{4}|.)")


def load_json(text: str) -> Any:
    """``yaml.safe_load(text)`` for a JSON text.

    `json` parses it, and YAML 1.1's resolvers read every number token: a
    float needs a dot and, with an exponent, a signed one (``1.5e-3``), so
    ``1e-5``, ``1E+5`` and ``1.0e5`` stay strings, as do ``NaN`` and
    ``Infinity``.  What PyYAML reads otherwise raises `YAMLSubsetError`: a
    tab outside a string (PyYAML refuses it), a surrogate-pair escape
    (`json` joins the halves, PyYAML keeps them apart), a character PyYAML
    does not print, or a raw line break.  A text that is not JSON
    goes to `load`."""
    text = text[1:] if text.startswith("\ufeff") else text
    if not text.strip():
        return None
    bad = _JSON_REFUSED.search(text)
    if bad:
        raise YAMLSubsetError(f"character {bad.group()!r} at offset {bad.start()}: "
                              "PyYAML refuses it or reads it as a line break")
    if "\t" in _JSON_STRING.sub('""', text):
        raise YAMLSubsetError("a tab outside a string: PyYAML refuses it")
    for string in _JSON_STRING.findall(text):
        for esc in _JSON_ESCAPE.findall(string):
            if esc[0] == "u" and 0xD800 <= int(esc[1:], 16) <= 0xDFFF:
                raise YAMLSubsetError(f"the surrogate escape \\{esc} is outside the subset")
    try:
        return json.loads(text, parse_float=_resolve_number, parse_int=_resolve_number,
                          parse_constant=_resolve_number)
    except json.JSONDecodeError:
        return load(text)


def _resolve_number(token: str) -> Any:
    return _resolve_plain(token, 0)


def load_file(path: str) -> Any:
    """A config file's contents as ``yaml.safe_load`` reads them: `load_json`
    of a ``.json`` file's text, else `load`."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    return load_json(text) if path.lower().endswith(".json") else load(text)
