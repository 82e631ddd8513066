"""A reader for the subset of YAML the repo's config files use, so the port
needs no PyYAML.

It parses block mappings and block sequences (a sequence may sit at its
key's indent or deeper, and an item may open a mapping inline:
`- ResizeAndCrop: {target_size: 256}`), flow mappings and sequences,
which may span lines, and comments. Plain scalars resolve as PyYAML's
`safe_load` resolves them, by the YAML 1.1 rules: `5.0e-4` is a float but
`1e-3` (no dot) a string, `yes`/`on`/`true` are booleans, `0447` an octal
int, `~`/`null`/an empty value None. Quoted scalars are strings.

Anchors, aliases, tags, block scalars (`|`, `>`), multi-line plain
scalars, document markers and timestamps raise `YAMLSubsetError` with the
line number.
"""
from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

__all__ = ["YAMLSubsetError", "safe_load"]


class YAMLSubsetError(ValueError):
    """The text uses YAML the reader does not take (or is malformed)."""


# PyYAML's implicit resolvers (yaml/resolver.py, YAML 1.1)
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
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
_FLOW_END = ",]}"


def _sexagesimal(digits: str, conv) -> Any:
    value = 0
    base = 1
    for part in reversed(digits.split(":")):
        value += conv(part) * base
        base *= 60
    return value


def _resolve(text: str, line: int) -> Any:
    """A plain scalar's value, as PyYAML's SafeLoader constructs it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v.startswith("-") else 1.0
        if v[:1] in "+-":
            v = v[1:]
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        if ":" in v:
            return sign * _sexagesimal(v, float)
        return sign * float(v)
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v.startswith("-") else 1
        if v[:1] in "+-":
            v = v[1:]
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v.startswith("0"):
            return sign * int(v, 8)
        if ":" in v:
            return sign * _sexagesimal(v, int)
        return sign * int(v)
    if _TIMESTAMP.match(text):
        raise YAMLSubsetError(f"line {line}: timestamps are not supported ({text!r})")
    if text == "<<" or text == "=":
        raise YAMLSubsetError(f"line {line}: merge keys are not supported")
    return text


def _strip_comment(s: str) -> str:
    """The line without its comment: a '#' at the start or after
    whitespace, outside quotes."""
    quote = None
    i = 0
    while i < len(s):
        c = s[i]
        if quote:
            if c == "\\" and quote == '"':
                i += 1
            elif c == quote:
                if quote == "'" and s[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif c in "'\"" and (i == 0 or s[i - 1] in " \t[{,:-"):
            quote = c
        elif c == "#" and (i == 0 or s[i - 1] in " \t"):
            return s[:i].rstrip()
        i += 1
    return s.rstrip()


_ESCAPES = {"n": "\n", "t": "\t", "\\": "\\", '"': '"', "/": "/", "0": "\0",
            "r": "\r", " ": " ", "b": "\b", "e": "\x1b", "a": "\x07"}


class _Cursor:
    """A position in a flow collection's text (which may span lines)."""

    def __init__(self, text: str, lines: List[int]):
        self.text, self.lines, self.i = text, lines, 0

    def line(self) -> int:
        return self.lines[min(self.i, len(self.lines) - 1)]

    def fail(self, what: str):
        raise YAMLSubsetError(f"line {self.line()}: {what}")

    def skip_ws(self):
        while self.i < len(self.text) and self.text[self.i] in " \t\n":
            self.i += 1

    def peek(self) -> str:
        return self.text[self.i] if self.i < len(self.text) else ""


def _quoted(cur: _Cursor) -> str:
    q = cur.peek()
    cur.i += 1
    out = []
    while True:
        c = cur.peek()
        if not c:
            cur.fail("unterminated quoted scalar")
        cur.i += 1
        if c == q:
            if q == "'" and cur.peek() == "'":
                out.append("'")
                cur.i += 1
                continue
            return "".join(out)
        if c == "\\" and q == '"':
            e = cur.peek()
            cur.i += 1
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
            elif e in "xuU":
                n = {"x": 2, "u": 4, "U": 8}[e]
                out.append(chr(int(cur.text[cur.i:cur.i + n], 16)))
                cur.i += n
            else:
                cur.fail(f"unknown escape \\{e}")
        elif c == "\n":
            cur.fail("multi-line quoted scalars are not supported")
        else:
            out.append(c)


def _check_node_start(c: str, cur: _Cursor):
    if c in "&*!":
        cur.fail({"&": "anchors", "*": "aliases", "!": "tags"}[c] + " are not supported")
    if c in "|>":
        cur.fail("block scalars are not supported")


def _flow_scalar(cur: _Cursor) -> Tuple[Any, bool]:
    """(value, was_quoted) of a scalar inside a flow collection."""
    c = cur.peek()
    _check_node_start(c, cur)
    if c in "'\"":
        return _quoted(cur), True
    start, line = cur.i, cur.line()
    while cur.i < len(cur.text):
        c = cur.text[cur.i]
        if c in _FLOW_END or c in "[{":
            break
        if c == ":" and (cur.i + 1 == len(cur.text) or cur.text[cur.i + 1] in " \t\n,]}"):
            break
        cur.i += 1
    raw = cur.text[start:cur.i]
    if "\n" in raw.strip():
        parts = [p.strip() for p in raw.split("\n")]
        raw = " ".join(p for p in parts if p)
    return _resolve(raw.strip(), line), False


def _flow_node(cur: _Cursor) -> Any:
    cur.skip_ws()
    c = cur.peek()
    if c == "[":
        cur.i += 1
        items = []
        while True:
            cur.skip_ws()
            if cur.peek() == "]":
                cur.i += 1
                return items
            items.append(_flow_node(cur))
            cur.skip_ws()
            c = cur.peek()
            if c == ",":
                cur.i += 1
            elif c != "]":
                cur.fail(f"expected ',' or ']' in a flow sequence, got {c!r}")
    if c == "{":
        cur.i += 1
        out = {}
        while True:
            cur.skip_ws()
            if cur.peek() == "}":
                cur.i += 1
                return out
            key, _ = _flow_scalar(cur)
            cur.skip_ws()
            value = None
            if cur.peek() == ":":
                cur.i += 1
                cur.skip_ws()
                value = None if cur.peek() in (",", "}") else _flow_node(cur)
            out[key] = value
            cur.skip_ws()
            c = cur.peek()
            if c == ",":
                cur.i += 1
            elif c != "}":
                cur.fail(f"expected ',' or '}}' in a flow mapping, got {c!r}")
    if not c:
        cur.fail("unexpected end of a flow collection")
    return _flow_scalar(cur)[0]


class _Lines:
    """Comment-free, non-empty lines as (line number, indent, text)."""

    def __init__(self, text: str):
        self.rows: List[Tuple[int, int, str]] = []
        for n, raw in enumerate(text.splitlines(), start=1):
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise YAMLSubsetError(f"line {n}: tabs in indentation")
            s = _strip_comment(raw)
            if not s.strip():
                continue
            body = s.lstrip(" ")
            if body.startswith("%") or body.rstrip() in ("---", "...") or \
                    body.startswith(("--- ", "... ")):
                raise YAMLSubsetError(f"line {n}: directives and document markers "
                                      "are not supported")
            self.rows.append((n, len(s) - len(body), body))
        self.k = 0

    def peek(self) -> Optional[Tuple[int, int, str]]:
        return self.rows[self.k] if self.k < len(self.rows) else None


def _split_key(body: str, line: int) -> Optional[Tuple[Any, str]]:
    """(key, rest) if `body` starts a block mapping entry, else None."""
    cur = _Cursor(body, [line])
    c = cur.peek()
    if c in "[{":
        return None
    if c in "'\"":
        key = _quoted(cur)
        rest = body[cur.i:]
        if not rest.lstrip(" ").startswith(":"):
            return None
        rest = rest.lstrip(" ")[1:]
        if rest and rest[0] not in " \t":
            return None
        return key, rest.strip()
    for m in re.finditer(r":(?=[ \t]|$)", body):
        key = body[:m.start()].rstrip()
        if not key:
            return None
        _check_node_start(key[0], cur)
        return _resolve(key, line), body[m.end():].strip()
    return None


def _inline_value(lines: _Lines, text: str, line: int, indent: int) -> Any:
    """The value written after `key:` or `- ` on line `line` (not empty)."""
    c = text[0]
    cur = _Cursor(text, [line] * len(text))
    _check_node_start(c, cur)
    if c in "[{":
        # a flow collection: gather lines until its brackets balance
        buf, nums = [text], [line] * (len(text) + 1)
        while True:
            joined = "\n".join(buf)
            depth = _bracket_depth(joined, line)
            if depth == 0:
                break
            row = lines.peek()
            if row is None:
                raise YAMLSubsetError(f"line {line}: unterminated flow collection")
            lines.k += 1
            buf.append(row[2])
            nums += [row[0]] * (len(row[2]) + 1)
        cur = _Cursor(joined, nums)
        value = _flow_node(cur)
        cur.skip_ws()
        if cur.i != len(joined):
            cur.fail(f"unexpected text after a flow collection: {joined[cur.i:]!r}")
        return value
    if c in "'\"":
        value = _quoted(cur)
        if text[cur.i:].strip():
            cur.fail(f"unexpected text after a quoted scalar: {text[cur.i:]!r}")
    else:
        value = _resolve(text, line)
    row = lines.peek()
    if row is not None and row[1] > indent and _split_key(row[2], row[0]) is None \
            and not row[2].startswith("- ") and row[2] != "-":
        raise YAMLSubsetError(f"line {row[0]}: multi-line plain scalars are not supported")
    return value


def _bracket_depth(text: str, line: int) -> int:
    depth, quote, i = 0, None, 0
    while i < len(text):
        c = text[i]
        if quote:
            if c == "\\" and quote == '"':
                i += 1
            elif c == quote:
                quote = None
        elif c in "'\"" and (i == 0 or text[i - 1] in " \t\n[{,:"):
            quote = c
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
            if depth < 0:
                raise YAMLSubsetError(f"line {line}: unbalanced '{c}'")
        i += 1
    return depth


def _block(lines: _Lines, indent: int) -> Any:
    """The block node whose lines start at column `indent`."""
    row = lines.peek()
    n, ind, body = row
    if body == "-" or body.startswith("- "):
        return _sequence(lines, ind)
    if _split_key(body, n) is not None:
        return _mapping(lines, ind)
    lines.k += 1
    return _inline_value(lines, body, n, ind)


def _value_after(lines: _Lines, rest: str, n: int, indent: int, seq_ok: bool) -> Any:
    """The value of an entry whose text after the indicator is `rest`: an
    inline value, or the block on the following deeper lines (or, for a
    mapping key, a sequence at the same indent)."""
    if rest:
        return _inline_value(lines, rest, n, indent)
    row = lines.peek()
    if row is None:
        return None
    if row[1] > indent:
        return _block(lines, row[1])
    if seq_ok and row[1] == indent and (row[2] == "-" or row[2].startswith("- ")):
        return _sequence(lines, indent)
    return None


def _mapping(lines: _Lines, indent: int) -> dict:
    out = {}
    while True:
        row = lines.peek()
        if row is None or row[1] < indent:
            return out
        n, ind, body = row
        if ind > indent:
            raise YAMLSubsetError(f"line {n}: unexpected indentation")
        kv = _split_key(body, n)
        if kv is None:
            raise YAMLSubsetError(f"line {n}: expected 'key: value', got {body!r}")
        lines.k += 1
        key, rest = kv
        out[key] = _value_after(lines, rest, n, indent, seq_ok=True)


def _sequence(lines: _Lines, indent: int) -> list:
    out = []
    while True:
        row = lines.peek()
        if row is None or row[1] < indent:
            return out
        n, ind, body = row
        if ind > indent:
            raise YAMLSubsetError(f"line {n}: unexpected indentation")
        if not (body == "-" or body.startswith("- ")):
            return out
        rest = body[1:].lstrip(" ")
        item_indent = ind + len(body) - len(rest)
        if rest and _split_key(rest, n) is not None:
            # "- key: value" opens a mapping at the column of `key`
            lines.rows[lines.k] = (n, item_indent, rest)
            out.append(_mapping(lines, item_indent))
        elif rest.startswith("- "):
            lines.rows[lines.k] = (n, item_indent, rest)
            out.append(_sequence(lines, item_indent))
        else:
            lines.k += 1
            out.append(_value_after(lines, rest, n, ind, seq_ok=False))


def safe_load(text: str) -> Any:
    """The document in `text`, as `yaml.safe_load` would return it (None
    for an empty document)."""
    lines = _Lines(text)
    if lines.peek() is None:
        return None
    value = _block(lines, lines.peek()[1])
    row = lines.peek()
    if row is not None:
        raise YAMLSubsetError(f"line {row[0]}: unexpected text {row[2]!r}")
    return value
