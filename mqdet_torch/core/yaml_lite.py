"""A yaml reader and writer without PyYAML, for the config files.

The machine with the card has no PyYAML, and the configs under `configs/`
are yaml. `safe_load(text)` reads the subset of YAML those files use and
gives what PyYAML's `yaml.safe_load` gives for it:

  * block mappings and block sequences, including a sequence at its key's
    indentation (`TEST:` then `- val`, PyYAML's own dump style);
  * flow sequences and flow mappings (`[[800, 1344]]`, `{a: 1}`), which may
    span lines;
  * plain, single-quoted and double-quoted scalars; a quoted scalar, and a
    plain one in block context (PyYAML's dump wraps long strings so), may
    span lines, each line break folded to one space (an empty line to a
    newline) as YAML folds flow scalars;
  * comments;
  * YAML 1.1 resolution of plain scalars as PyYAML's resolver does it: bools
    (`true`, `yes`, `on`, ... in three casings), ints (decimal, `0b`, `0x`,
    a leading 0 for octal, `_` separators, base 60), floats (a dot is
    needed: `1e-4` stays a string; `.inf`, `.nan`) and null (`~`, `null`,
    nothing).

Anything else (anchors and aliases, tags, block scalars `|` and `>`,
complex keys, a plain scalar over several lines inside a flow collection,
`- key: value` on one line, directives and document markers, timestamps,
tabs in the indentation) raises ValueError with the line number: it is never read
differently from PyYAML. `tests/test_torch_port_cli.py` holds the reader
against `yaml.safe_load` on every file under `configs/`.

`dump(data)` writes a tree of dicts, lists, tuples and scalars in this
subset (block mappings, flow sequences, double-quoted strings), which both
this reader and PyYAML read back equal, tuples as lists.
"""
from __future__ import annotations

import math
import re
from typing import Any, List

_BREAK = "\n"
_ESCAPES = {
    "0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n", "v": "\x0b", "f": "\x0c",
    "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0",
    "L": "\u2028", "P": "\u2029",
}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}
_REFUSED_START = "&*!|>%@`"
_FLOW_STOP = ",[]{}"

# PyYAML's implicit resolvers (resolver.py), tried in its order
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9_]+(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$"
)
_INT = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$"
)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_REFUSED_PLAIN = (
    (re.compile(r"^(?:<<)$"), "a merge key"),
    (re.compile(r"^(?:=)$"), "a value key"),
    (re.compile(
        r"^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
        r"(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
        r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$"
    ), "a timestamp"),
)


def _sexagesimal(digits: str) -> float:
    value, base = 0, 1
    for part in reversed(digits.split(":")):
        value += float(part) * base if "." in part else int(part) * base
        base *= 60
    return value


def _int(text: str) -> int:
    v = text.replace("_", "")
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
        return sign * int(_sexagesimal(v))
    return sign * int(v)


def _float(text: str) -> float:
    v = text.replace("_", "").lower()
    sign = -1.0 if v[0] == "-" else 1.0
    if v[0] in "+-":
        v = v[1:]
    if v == ".inf":
        return sign * math.inf
    if v == ".nan":
        return math.nan
    if ":" in v:
        return sign * float(_sexagesimal(v))
    return sign * float(v)


def resolve_plain(text: str, line: int = 0) -> Any:
    """The value PyYAML's SafeLoader gives a plain scalar."""
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.match(text):
        return _float(text)
    if _INT.match(text):
        return _int(text)
    if _NULL.match(text):
        return None
    for pattern, what in _REFUSED_PLAIN:
        if pattern.match(text):
            raise ValueError(f"line {line}: {what} ({text!r}) is outside the subset this reader takes")
    return text


class _Reader:
    def __init__(self, text: str):
        if text.startswith("\ufeff"):
            text = text[1:]
        self.text = text.replace("\r\n", _BREAK).replace("\r", _BREAK) + "\0"
        self.pos = 0
        self.flow_stack: List[str] = []  # the open flow collections

    # ---- positions ------------------------------------------------------
    def line(self, pos=None) -> int:
        return self.text.count(_BREAK, 0, self.pos if pos is None else pos) + 1

    def fail(self, what: str, pos=None):
        raise ValueError(f"line {self.line(pos)}: {what}")

    def peek(self, k: int = 0) -> str:
        return self.text[min(self.pos + k, len(self.text) - 1)]

    def at_end(self) -> bool:
        return self.text[self.pos] == "\0"

    # ---- lines --------------------------------------------------------
    def indent_at(self, pos: int) -> int:
        n = 0
        while self.text[pos + n] == " ":
            n += 1
        if self.text[pos + n] == "\t":
            self.fail("a tab in the indentation", pos)
        return n

    def skip_blank_lines(self) -> None:
        """From a line start, past every empty or comment-only line."""
        while not self.at_end():
            p = self.pos
            while self.text[p] in " \t":
                p += 1
            if self.text[p] == "#":
                while self.text[p] not in (_BREAK, "\0"):
                    p += 1
            if self.text[p] == _BREAK:
                self.pos = p + 1
            elif self.text[p] == "\0":
                self.pos = p
            else:
                ind = self.indent_at(self.pos)
                if ind == 0 and (self.text.startswith(("---", "..."), self.pos)
                                 and self.text[self.pos + 3] in " \t\n\0"):
                    self.fail("a document marker is outside the subset this reader takes")
                if ind == 0 and self.text[self.pos] == "%":
                    self.fail("a directive is outside the subset this reader takes")
                return

    def end_of_line(self) -> None:
        """Only spaces and a comment may follow a value on its line."""
        while self.peek() in " \t":
            self.pos += 1
        if self.peek() == "#" and self.text[self.pos - 1] in " \t":
            while self.peek() not in (_BREAK, "\0"):
                self.pos += 1
        if self.peek() == _BREAK:
            self.pos += 1
        elif not self.at_end():
            self.fail(f"unexpected {self.peek()!r} after a value")

    def is_entry(self, pos: int) -> bool:
        return self.text[pos] == "-" and self.text[pos + 1] in " \t\n\0"

    # ---- block nodes --------------------------------------------------
    def document(self) -> Any:
        self.skip_blank_lines()
        if self.at_end():
            return None
        ind = self.indent_at(self.pos)
        start = self.pos + ind
        if self.text[start] in "[{" or (self.text[start] in "'\"" and not self.quoted_key_at(start)):
            self.pos = start
            value = self.inline_value(-1)
        else:
            value = self.block_node(ind)
        self.skip_blank_lines()
        if not self.at_end():
            self.fail("content after the end of the document")
        return value

    def quoted_key_at(self, start: int) -> bool:
        """Whether the quoted scalar at `start` is a mapping key."""
        save, self.pos = self.pos, start
        try:
            self.quoted()
            while self.peek() in " \t":
                self.pos += 1
            return self.peek() == ":" and self.peek(1) in " \t\n\0"
        finally:
            self.pos = save

    def block_node(self, ind: int) -> Any:
        if self.is_entry(self.pos + ind):
            return self.block_sequence(ind)
        return self.block_mapping(ind)

    def block_mapping(self, n: int) -> dict:
        out = {}
        while True:
            self.skip_blank_lines()
            if self.at_end():
                return out
            ind = self.indent_at(self.pos)
            if ind < n:
                return out
            if ind > n:
                self.fail("indentation deeper than its mapping's")
            self.pos += ind
            if self.is_entry(self.pos):
                self.fail("a sequence entry inside a mapping")
            key_line = self.line()
            key = self.key()
            if isinstance(key, (list, dict)):
                self.fail("a collection as a mapping key")
            out[key] = self.value_after_indicator(n, key_line)

    def key(self) -> Any:
        ch = self.peek()
        if ch in "'\"":
            key = self.quoted()
            while self.peek() in " \t":
                self.pos += 1
        elif ch in _REFUSED_START or ch in "[]{}," or (ch in "?:" and self.peek(1) in " \t\n\0"):
            self.fail(f"{ch!r} starting a key is outside the subset this reader takes")
        else:
            start = self.pos
            while True:
                c = self.peek()
                if c in (_BREAK, "\0") or (c == "#" and self.text[self.pos - 1] in " \t"):
                    self.fail("expected 'key: value'", start)
                if c == ":" and self.peek(1) in " \t\n\0":
                    break
                self.pos += 1
            key = resolve_plain(self.text[start:self.pos].rstrip(" \t"), self.line(start))
        if not (self.peek() == ":" and self.peek(1) in " \t\n\0"):
            self.fail("expected ':' after a mapping key")
        self.pos += 1
        return key

    def value_after_indicator(self, n: int, key_line: int) -> Any:
        """The value after `key:` or `-` at indentation n."""
        while self.peek() in " \t":
            self.pos += 1
        if self.peek() in (_BREAK, "\0") or self.peek() == "#":
            self.end_of_line()
            self.skip_blank_lines()
            if self.at_end():
                return None
            ind = self.indent_at(self.pos)
            if ind > n:
                return self.block_node(ind)
            if ind == n and self.is_entry(self.pos + ind) and key_line > 0:
                return self.block_sequence(n)  # a sequence at its key's indentation
            return None
        value = self.inline_value(n)
        self.end_of_line()
        return value

    def block_sequence(self, n: int) -> list:
        out = []
        while True:
            self.skip_blank_lines()
            if self.at_end():
                return out
            ind = self.indent_at(self.pos)
            if ind > n:
                self.fail("indentation deeper than its sequence's")
            if ind < n or not self.is_entry(self.pos + ind):
                return out
            self.pos += ind + 1
            while self.peek() in " \t":
                self.pos += 1
            if self.is_entry(self.pos):
                self.fail("a sequence inside a sequence entry's line is outside the subset this reader takes")
            out.append(self.value_after_indicator(n, 0))

    # ---- scalars and flow collections -----------------------------------
    def inline_value(self, n: int) -> Any:
        """A value that starts on its indicator's line; n: the indentation of
        the mapping or sequence it belongs to."""
        ch = self.peek()
        if ch in "[{":
            return self.flow_node()
        if ch in "'\"":
            return self.quoted()
        if ch in _REFUSED_START or ch in "]},#" or (ch in "?:-" and self.peek(1) in " \t\n\0"):
            self.fail(f"{ch!r} starting a value is outside the subset this reader takes")
        start = self.pos
        while True:
            c = self.peek()
            if c in (_BREAK, "\0") or (c == "#" and self.text[self.pos - 1] in " \t"):
                break
            if c == ":" and self.peek(1) in " \t\n\0":
                self.fail("'key: value' inside a value is outside the subset this reader takes")
            self.pos += 1
        pieces = [self.text[start:self.pos].rstrip(" \t")]
        while self.peek() == _BREAK:  # not after a comment, which ends the scalar
            folded = self.continuation(n)
            if folded is None:
                break
            pieces += folded
        return resolve_plain("".join(pieces), self.line(start))

    def continuation(self, n: int):
        """A plain scalar's next line, at `self.pos` (a line break): a line
        more indented than n that is not a comment continues the scalar,
        folded as YAML folds it (one break to a space, k empty lines to k
        newlines). Returns [fold, text] with `self.pos` after the text, or
        None with `self.pos` unmoved."""
        p, empty = self.pos + 1, 0
        while True:
            q = p
            while self.text[q] == " ":
                q += 1
            if self.text[q] != _BREAK:
                break
            p, empty = q + 1, empty + 1
        if q - p <= n or self.text[q] in "#\0\t":
            return None
        self.pos = start = q
        while True:
            c = self.peek()
            if c in (_BREAK, "\0") or (c == "#" and self.text[self.pos - 1] in " \t"):
                break
            if c == ":" and self.peek(1) in " \t\n\0":
                self.fail("'key: value' inside a value is outside the subset this reader takes")
            self.pos += 1
        return [_BREAK * empty if empty else " ", self.text[start:self.pos].rstrip(" \t")]

    def skip_flow_space(self) -> None:
        while True:
            c = self.peek()
            if c in " \t\n":
                self.pos += 1
            elif c == "#" and self.text[self.pos - 1] in " \t\n":
                while self.peek() not in (_BREAK, "\0"):
                    self.pos += 1
            else:
                return

    def flow_node(self) -> Any:
        ch = self.peek()
        if ch in "[{":
            self.flow_stack.append(ch)
            try:
                return self.flow_collection(ch)
            finally:
                self.flow_stack.pop()
        return self.flow_item()

    def flow_collection(self, ch: str) -> Any:
        self.pos += 1
        close = "]" if ch == "[" else "}"
        out = [] if ch == "[" else {}
        while True:
            self.skip_flow_space()
            if self.peek() == close:
                self.pos += 1
                return out
            item = self.flow_item()
            if ch == "{":
                if isinstance(item, (list, dict)):
                    self.fail("a collection as a mapping key")
                self.skip_flow_space()
                if self.peek() != ":":
                    self.fail("expected ':' in a flow mapping")
                self.pos += 1
                self.skip_flow_space()
                out[item] = None if self.peek() in ",}" else self.flow_item()
            else:
                out.append(item)
            self.skip_flow_space()
            if self.peek() == ",":
                self.pos += 1
            elif self.peek() == close:
                self.pos += 1
                return out
            else:
                self.fail(f"expected ',' or {close!r} in a flow collection, got {self.peek()!r}")

    def flow_item(self) -> Any:
        ch = self.peek()
        if ch in "[{":
            return self.flow_node()
        if ch in "'\"":
            value = self.quoted()
        elif ch in _REFUSED_START or ch in "]},#\0" or (ch in "?:-" and self.peek(1) in " \t\n\0,[]{}"):
            self.fail(f"{ch!r} starting a flow value is outside the subset this reader takes")
        else:
            start = self.pos
            while True:
                c = self.peek()
                if c in _FLOW_STOP or c in (_BREAK, "\0") or (c == "#" and self.text[self.pos - 1] in " \t"):
                    break
                if c == ":" and self.peek(1) in " \t\n\0" + _FLOW_STOP:
                    break
                self.pos += 1
            text = self.text[start:self.pos].rstrip(" \t")
            value = resolve_plain(text, self.line(start))
            p = self.pos
            while self.text[p] in " \t":
                p += 1
            if self.text[p] == _BREAK:  # a plain flow scalar going on to the next line
                q = p + 1
                while self.text[q] in " \t\n":
                    q += 1
                if self.text[q] not in _FLOW_STOP + ":#\0":
                    self.fail("a plain scalar over several lines is outside the subset this reader takes")
        self.skip_flow_space()
        if self.peek() == ":" and self.text[self.pos + 1] in " \t\n\0" + _FLOW_STOP and self.flow_stack[-1] == "[":
            self.fail("a 'key: value' pair inside a flow sequence is outside the subset this reader takes")
        return value

    def quoted(self) -> str:
        """A single- or double-quoted scalar, folded as PyYAML folds it."""
        quote = self.peek()
        double = quote == '"'
        start = self.pos
        self.pos += 1
        chunks: List[str] = []
        while True:
            self.non_spaces(chunks, double, start)
            if self.peek() == quote:
                self.pos += 1
                return "".join(chunks)
            self.spaces(chunks, start)

    def non_spaces(self, chunks: List[str], double: bool, start: int) -> None:
        while True:
            p = self.pos
            while self.text[p] not in "'\"\\\0 \t\n":
                p += 1
            if p > self.pos:
                chunks.append(self.text[self.pos:p])
                self.pos = p
            ch = self.peek()
            if not double and ch == "'" and self.peek(1) == "'":
                chunks.append("'")
                self.pos += 2
            elif (double and ch == "'") or (not double and ch in '"\\'):
                chunks.append(ch)
                self.pos += 1
            elif double and ch == "\\":
                self.pos += 1
                ch = self.peek()
                if ch in _ESCAPES:
                    chunks.append(_ESCAPES[ch])
                    self.pos += 1
                elif ch in _ESCAPE_CODES:
                    k = _ESCAPE_CODES[ch]
                    digits = self.text[self.pos + 1:self.pos + 1 + k]
                    if len(digits) != k or any(c not in "0123456789abcdefABCDEF" for c in digits):
                        self.fail(f"a \\{ch} escape needs {k} hex digits")
                    chunks.append(chr(int(digits, 16)))
                    self.pos += 1 + k
                elif ch == _BREAK:
                    self.pos += 1
                    chunks.extend(self.breaks(start))
                else:
                    self.fail(f"unknown escape \\{ch}")
            else:
                return

    def spaces(self, chunks: List[str], start: int) -> None:
        p = self.pos
        while self.text[p] in " \t":
            p += 1
        white = self.text[self.pos:p]
        self.pos = p
        ch = self.peek()
        if ch == "\0":
            self.fail("the end of the file inside a quoted scalar", start)
        if ch == _BREAK:
            self.pos += 1
            breaks = self.breaks(start)
            if not breaks:
                chunks.append(" ")
            chunks.extend(breaks)
        else:
            chunks.append(white)

    def breaks(self, start: int) -> List[str]:
        out = []
        while True:
            if (self.text.startswith(("---", "..."), self.pos) and self.text[self.pos + 3] in " \t\n\0"
                    and (self.pos == 0 or self.text[self.pos - 1] == _BREAK)):
                self.fail("a document marker inside a quoted scalar", start)
            while self.peek() in " \t":
                self.pos += 1
            if self.peek() == _BREAK:
                out.append(_BREAK)
                self.pos += 1
            else:
                return out


def safe_load(text: str) -> Any:
    """What `yaml.safe_load(text)` gives, for the subset above; ValueError
    with the line number for anything outside it."""
    return _Reader(text).document()


# ---- the writer ---------------------------------------------------------

_PLAIN_KEY = re.compile(r"^[A-Za-z_][A-Za-z0-9_.\-]*$")


def _quote(s: str) -> str:
    out = ['"']
    for ch in s:
        o = ord(ch)
        if ch == '"':
            out.append('\\"')
        elif ch == "\\":
            out.append("\\\\")
        elif 0x20 <= o < 0x7F:
            out.append(ch)
        elif ch == "\n":
            out.append("\\n")
        elif ch == "\t":
            out.append("\\t")
        elif o < 0xA0 or 0xD800 <= o < 0xE000 or o in (0x2028, 0x2029, 0xFEFF, 0xFFFE, 0xFFFF):
            out.append(f"\\x{o:02x}" if o < 0x100 else f"\\u{o:04x}")
        else:
            out.append(ch)
    out.append('"')
    return "".join(out)


def _scalar(v: Any) -> str:
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
        r = repr(v)
        if "e" in r:
            mant, exp = r.split("e")
            if "." not in mant:
                mant += ".0"
            return f"{mant}e{exp if exp[0] in '+-' else '+' + exp}"
        return r if "." in r else r + ".0"
    if isinstance(v, str):
        return _quote(v)
    raise TypeError(f"cannot write a {type(v).__name__} as yaml")


def _key(k: Any) -> str:
    if isinstance(k, str) and _PLAIN_KEY.match(k) and resolve_plain(k) == k:
        return k
    return _scalar(k)


def _flow(v: Any) -> str:
    if isinstance(v, dict):
        return "{" + ", ".join(f"{_key(k)}: {_flow(x)}" for k, x in v.items()) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_flow(x) for x in v) + "]"
    return _scalar(v)


def dump(data: dict, indent: int = 0) -> str:
    """A mapping as block yaml: nested mappings as blocks, sequences in flow
    style, strings double-quoted."""
    lines = []
    pad = " " * indent
    for k, v in data.items():
        if isinstance(v, dict) and v:
            lines.append(f"{pad}{_key(k)}:\n{dump(v, indent + 2)}")
        else:
            lines.append(f"{pad}{_key(k)}: {_flow(v)}\n")
    return "".join(lines)
