"""A reader for the YAML subset that config files use, without PyYAML.

``loads(text)`` returns what ``yaml.safe_load(text)`` returns for every
document in the subset: equal values of equal types.  ``load(path)``
reads a file.

The subset:

- block mappings and block sequences; a sequence may sit directly under
  its key at the key's indent, and a ``- `` item may hold a mapping, a
  sequence or a flow collection;
- flow sequences and flow mappings, nested, over several lines, with
  quoted or plain keys;
- plain, single-quoted (``''`` is a quote) and double-quoted (backslash
  escapes) scalars, folded over lines as YAML folds them;
- full-line comments and trailing comments, a ``#`` inside quotes kept;
- plain scalars resolved as PyYAML's YAML 1.1 ``SafeLoader`` resolves
  them: ``null``, ``~`` and the empty value to None; the
  ``yes/no/true/false/on/off`` family in its three casings to bools;
  decimal, ``0x``, ``0b``, leading-``0`` octal and base-60 (``1:30``)
  ints, ``_`` separators allowed; floats with a dot (so ``1e-4`` stays
  the string ``"1e-4"``, and an exponent needs its sign), ``.inf`` and
  ``.nan``; anything else a string.

Refused with a ``ValueError`` that names the line: anchors and aliases,
tags, block scalars (``|``, ``>``), ``<<`` merge keys, directives and
document markers (so a second document), complex keys (``? ``, a
collection as a key), a single-pair mapping inside a flow sequence,
timestamps (which PyYAML reads as dates), tabs outside quoted scalars,
line breaks other than ``\\n`` / ``\\r\\n`` / ``\\r``, and characters
that YAML does not print.  No ``eval`` is used.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Union

# PyYAML's implicit resolvers (resolver.py), tried on plain scalars only
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
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
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
                        re.X)
# what PyYAML's reader refuses as unprintable
_NON_PRINTABLE = re.compile("[^\x09\x0A\x0D\x20-\x7E\x85\xA0-\uD7FF"
                            "\uE000-\uFFFD\U00010000-\U0010ffff]")
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "\\": "\\", "/": "/", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}
_REFUSED_STARTS = {"&": "an anchor", "*": "an alias", "!": "a tag",
                   "|": "a block scalar", ">": "a block scalar",
                   "%": "a directive", "@": "a reserved indicator '@'",
                   "`": "a reserved indicator '`'"}
_BLANK = ("", "\n", " ")

Node = Union[None, bool, int, float, str, List[Any], Dict[Any, Any]]


def _sexagesimal(text: str, cast) -> Any:
    value, base = cast(0), 1
    for digit in reversed(text.split(":")):
        value += cast(digit) * base
        base *= 60
    return value


def _int(text: str) -> int:
    text = text.replace("_", "")
    sign = -1 if text[0] == "-" else 1
    if text[0] in "+-":
        text = text[1:]
    if text == "0":
        return 0
    if text.startswith("0b"):
        return sign * int(text[2:], 2)
    if text.startswith("0x"):
        return sign * int(text[2:], 16)
    if text[0] == "0":
        return sign * int(text, 8)
    if ":" in text:
        return sign * _sexagesimal(text, int)
    return sign * int(text)


def _float(text: str) -> float:
    text = text.replace("_", "").lower()
    sign = -1 if text[0] == "-" else 1
    if text[0] in "+-":
        text = text[1:]
    if text == ".inf":
        return sign * float("inf")
    if text == ".nan":
        return float("nan")
    if ":" in text:
        return sign * _sexagesimal(text, float)
    return sign * float(text)


class _Reader:
    """A recursive-descent reader over the whole text.  Block parsers
    return with ``pos`` at the first character of the next content line
    (or at the end); scalar and flow parsers return right after the
    value."""

    def __init__(self, text: str):
        text = text.replace("\r\n", "\n").replace("\r", "\n")
        if text.startswith("\ufeff"):
            text = text[1:]
        self.s, self.n, self.pos = text, len(text), 0
        bad = _NON_PRINTABLE.search(text)
        if bad:
            self.fail(f"unprintable character {bad.group()!r}", bad.start())
        for brk in ("\x85", "\u2028", "\u2029"):
            if brk in text:
                self.fail(f"line break {brk!r} (only \\n, \\r\\n and \\r "
                          f"are read)", text.index(brk))

    # -- positions ------------------------------------------------------
    def peek(self, k: int = 0) -> str:
        p = self.pos + k
        return self.s[p] if p < self.n else ""

    def col(self, pos: Optional[int] = None) -> int:
        p = self.pos if pos is None else pos
        return p - (self.s.rfind("\n", 0, p) + 1)

    def fail(self, msg: str, pos: Optional[int] = None):
        p = self.pos if pos is None else pos
        raise ValueError(f"YAML line {self.s.count(chr(10), 0, p) + 1}: "
                         f"{msg}")

    def marker_at(self, p: int) -> bool:
        """A document marker (``---`` or ``...``) at column 0 of ``p``."""
        return (self.s.startswith(("---", "..."), p)
                and (self.s[p + 3:p + 4] in _BLANK))

    def skip_spaces(self) -> None:
        while self.peek() == " ":
            self.pos += 1
        if self.peek() == "\t":
            self.fail("a tab outside a quoted scalar")

    def skip_comment(self) -> None:
        nl = self.s.find("\n", self.pos)
        self.pos = self.n if nl < 0 else nl

    def at_line_start(self) -> bool:
        p = self.pos - 1
        while p >= 0 and self.s[p] == " ":
            p -= 1
        return p < 0 or self.s[p] == "\n"

    def end_line(self) -> None:
        """Past the rest of this line: spaces and a comment, nothing else
        (a folded plain scalar may already stand on the next line)."""
        if self.at_line_start():
            return
        self.skip_spaces()
        ch = self.peek()
        if ch == "#":
            self.skip_comment()
        elif ch not in ("", "\n"):
            self.fail(f"unexpected {ch!r} after a value")

    def next_content(self) -> Optional[int]:
        """Past line ends, blank lines and comments to the next content;
        its column, or None at the end."""
        while True:
            self.skip_spaces()
            ch = self.peek()
            if ch == "":
                return None
            if ch == "#":
                self.skip_comment()
            elif ch == "\n":
                self.pos += 1
            else:
                col = self.col()
                if col == 0 and self.marker_at(self.pos):
                    self.fail("a document marker: one document a file")
                if col == 0 and ch == "%":
                    self.fail("a directive")
                return col

    # -- scalars ----------------------------------------------------------
    def plain_value(self, text: str, pos: int) -> Node:
        if _NULL.match(text):
            return None
        if _BOOL.match(text):
            return text.lower() in ("yes", "true", "on")
        if _FLOAT.match(text):
            return _float(text)
        if _INT.match(text):
            try:
                return _int(text)
            except ValueError:
                self.fail(f"int {text!r} without digits", pos)
        if _TIMESTAMP.match(text):
            self.fail(f"a timestamp {text!r} (quote it for a string)", pos)
        if text == "<<":
            self.fail("a merge key '<<'", pos)
        if text == "=":
            self.fail("a value key '='", pos)
        return text

    def check_plain_start(self, flow: bool) -> None:
        ch, nxt = self.peek(), self.peek(1)
        if ch in _REFUSED_STARTS:
            self.fail(f"{_REFUSED_STARTS[ch]} ({ch!r})")
        if ch == "?" and (nxt in _BLANK or flow):
            self.fail("a complex key ('?')")
        if ch in "-:" and (nxt in _BLANK or (flow and ch == ":")):
            self.fail(f"{ch!r} where a value was expected")
        if ch in ",[]{}#":
            self.fail(f"{ch!r} where a value was expected")
        if ch == "":
            self.fail("the text ends where a value was expected")

    def plain_line(self, flow: bool) -> str:
        """A plain scalar's text from ``pos`` to its end on this line;
        ``pos`` right after its last non-space character."""
        start = end = self.pos
        while True:
            ch = self.peek()
            if ch in ("", "\n"):
                break
            if ch == " ":
                while self.peek() == " ":
                    self.pos += 1
                if self.peek() in ("", "\n", "#"):
                    break
                continue
            if ch == "\t":
                self.fail("a tab outside a quoted scalar")
            if ch == ":" and (self.peek(1) in _BLANK
                              or (flow and self.peek(1) in ",[]{}")):
                break
            if flow and ch in ",?[]{}":
                break
            self.pos += 1
            end = self.pos
        self.pos = end
        return self.s[start:end]

    def plain(self, parent: int, flow: bool) -> str:
        """A plain scalar, folded over the lines that continue it (in block
        context, lines indented past ``parent``)."""
        text = self.plain_line(flow)
        while True:
            p = self.pos
            while p < self.n and self.s[p] == " ":
                p += 1
            if p >= self.n or self.s[p] != "\n":
                return text
            breaks = 0
            while p < self.n and self.s[p] == "\n":
                breaks += 1
                p += 1
                if self.marker_at(p):
                    self.pos = p
                    return text
                while p < self.n and self.s[p] == " ":
                    p += 1
            if p >= self.n or self.s[p] == "#" \
                    or (not flow and self.col(p) <= parent):
                self.pos = p
                return text
            self.pos = p
            chunk = self.plain_line(flow)
            if not chunk:
                return text
            text += (" " if breaks == 1 else "\n" * (breaks - 1)) + chunk

    def quoted(self) -> str:
        quote = self.peek()
        double = quote == '"'
        start = self.pos
        self.pos += 1
        chunks: List[str] = []
        while True:
            ch = self.peek()
            if ch == "":
                self.fail("an unterminated quoted scalar", start)
            if ch == quote:
                if not double and self.peek(1) == "'":
                    chunks.append("'")
                    self.pos += 2
                    continue
                self.pos += 1
                return "".join(chunks)
            if double and ch == "\\":
                self.pos += 1
                esc = self.peek()
                if esc in _ESCAPES:
                    chunks.append(_ESCAPES[esc])
                    self.pos += 1
                elif esc in _ESCAPE_CODES:
                    width = _ESCAPE_CODES[esc]
                    digits = self.s[self.pos + 1:self.pos + 1 + width]
                    if len(digits) != width or any(
                            d not in "0123456789ABCDEFabcdef"
                            for d in digits):
                        self.fail(f"escape \\{esc} needs {width} hex digits")
                    chunks.append(chr(int(digits, 16)))
                    self.pos += 1 + width
                elif esc == "\n":
                    self.pos += 1
                    chunks.extend(self.quoted_breaks())
                else:
                    self.fail(f"unknown escape \\{esc}")
            elif ch in " \t\n":
                ws_start = self.pos
                while self.peek() in (" ", "\t"):
                    self.pos += 1
                whitespace = self.s[ws_start:self.pos]
                if self.peek() == "\n":
                    self.pos += 1
                    breaks = self.quoted_breaks()
                    chunks.extend(breaks if breaks else [" "])
                else:
                    chunks.append(whitespace)
            else:
                chunks.append(ch)
                self.pos += 1

    def quoted_breaks(self) -> List[str]:
        """The blank lines after a line break inside a quoted scalar, each
        one newline; leading whitespace of the next line dropped."""
        breaks = []
        while True:
            if self.col() == 0 and self.marker_at(self.pos):
                self.fail("a document marker inside a quoted scalar")
            while self.peek() in (" ", "\t"):
                self.pos += 1
            if self.peek() != "\n":
                return breaks
            breaks.append("\n")
            self.pos += 1

    # -- flow collections ---------------------------------------------------
    def flow_ws(self) -> None:
        while True:
            ch = self.peek()
            if ch == " " or ch == "\n":
                self.pos += 1
                if ch == "\n" and self.marker_at(self.pos):
                    self.fail("a document marker inside a flow collection")
            elif ch == "#":
                self.skip_comment()
            elif ch == "\t":
                self.fail("a tab outside a quoted scalar")
            else:
                return

    def flow_scalar(self) -> Node:
        if self.peek() in "\"'":
            return self.quoted()
        self.check_plain_start(flow=True)
        pos = self.pos
        return self.plain_value(self.plain(-1, True), pos)

    def flow_node(self) -> Node:
        if self.peek() in "[{":
            return self.flow_collection()
        return self.flow_scalar()

    def flow_collection(self) -> Node:
        start = self.pos
        is_seq = self.peek() == "["
        close = "]" if is_seq else "}"
        out: Any = [] if is_seq else {}
        self.pos += 1
        while True:
            self.flow_ws()
            ch = self.peek()
            if ch == close:
                self.pos += 1
                return out
            if ch == "":
                self.fail("an unclosed flow collection", start)
            if is_seq:
                out.append(self.flow_node())
                self.flow_ws()
                if self.peek() == ":":
                    self.fail("a single-pair mapping inside a flow sequence")
            else:
                if ch in "[{":
                    self.fail("a collection as a mapping key (complex key)")
                key_start = self.pos
                key = self.flow_scalar()
                key_lines = "\n" in self.s[key_start:self.pos]
                self.flow_ws()
                value = None
                if self.peek() == ":":
                    if key_lines:
                        self.fail("a mapping key over more than one line",
                                  key_start)
                    self.pos += 1
                    self.flow_ws()
                    if self.peek() not in (",", "}"):
                        value = self.flow_node()
                out[key] = value
            self.flow_ws()
            ch = self.peek()
            if ch == ",":
                self.pos += 1
            elif ch == close:
                self.pos += 1
                return out
            else:
                self.fail(f"expected ',' or {close!r} in a flow collection, "
                          f"found {ch!r}")

    # -- block collections --------------------------------------------------
    def at_entry(self) -> bool:
        """A block sequence entry (``-`` and a blank) at ``pos``."""
        return self.peek() == "-" and self.peek(1) in _BLANK

    def is_key(self) -> bool:
        """Whether a simple mapping key (a scalar and ``: ``) starts at
        ``pos`` on this line; ``pos`` is kept."""
        save = self.pos
        try:
            ch = self.peek()
            if ch in "\"'":
                self.quoted()
                if "\n" in self.s[save:self.pos]:
                    return False
            elif ch in "[{":
                self.flow_collection()
                self.skip_spaces()
                if self.peek() == ":" and self.peek(1) in _BLANK:
                    self.fail("a collection as a mapping key (complex key)",
                              save)
                return False
            else:
                self.plain_line(False)
            self.skip_spaces()
            return self.peek() == ":" and self.peek(1) in _BLANK
        finally:
            self.pos = save

    def check_block_start(self) -> None:
        ch = self.peek()
        if ch in _REFUSED_STARTS:
            self.fail(f"{_REFUSED_STARTS[ch]} ({ch!r})")
        if ch in "?:" and self.peek(1) in _BLANK:
            self.fail("a complex key ('?') or a mapping entry without a key"
                      if ch == "?" else "a mapping entry without a key")

    def inline_value(self, parent: int) -> Node:
        ch = self.peek()
        if ch in "[{":
            return self.flow_collection()
        if ch in "\"'":
            return self.quoted()
        self.check_plain_start(flow=False)
        pos = self.pos
        return self.plain_value(self.plain(parent, False), pos)

    def block_node(self, parent: int) -> Node:
        """The node at ``pos`` (its column above ``parent``)."""
        if self.at_entry():
            return self.block_seq(self.col())
        self.check_block_start()
        if self.is_key():
            return self.block_map(self.col())
        value = self.inline_value(parent)
        self.end_line()
        self.next_content()
        return value

    def block_seq(self, col: int) -> List[Any]:
        out: List[Any] = []
        while True:
            self.pos += 1                           # past the '-'
            self.skip_spaces()
            if self.peek() in ("", "\n", "#"):
                self.end_line()
                below = self.next_content()
                out.append(self.block_node(col)
                           if below is not None and below > col else None)
            else:
                out.append(self.block_node(col))
            if self.peek() == "" or self.col() < col:
                return out
            if self.col() > col:
                self.fail("a line indented past its sequence's entries")
            if not self.at_entry():
                return out

    def block_map(self, col: int) -> Dict[Any, Any]:
        out: Dict[Any, Any] = {}
        while True:
            if self.peek() in "\"'":
                key = self.quoted()
            else:
                pos = self.pos
                key = self.plain_value(self.plain_line(False), pos)
            self.skip_spaces()
            self.pos += 1                           # past the ':'
            out[key] = self.map_value(col)
            if self.peek() == "" or self.col() < col:
                return out
            if self.col() > col:
                self.fail("a line indented past its mapping's keys")
            if self.at_entry():
                self.fail("a sequence entry where a mapping key belongs")
            self.check_block_start()
            if not self.is_key():
                self.fail("expected a mapping key ('key: value')")

    def map_value(self, col: int) -> Node:
        self.skip_spaces()
        if self.peek() in ("", "\n", "#"):
            self.end_line()
            below = self.next_content()
            if below is None:
                return None
            if below > col:
                return self.block_node(col)
            if below == col and self.at_entry():
                return self.block_seq(col)      # a sequence under its key
            return None
        if self.at_entry():
            self.fail("a block sequence on its key's line")
        self.check_block_start()
        if self.is_key():
            self.fail("a mapping on its key's line")
        value = self.inline_value(col)
        self.end_line()
        self.next_content()
        return value

    def document(self) -> Node:
        if self.next_content() is None:
            return None
        value = self.block_node(-1)
        if self.next_content() is not None:
            self.fail("content after the document's root node")
        return value


def loads(text: str) -> Node:
    """The YAML document ``text`` as ``yaml.safe_load`` reads it (see the
    module docstring for the subset); raises ``ValueError`` naming the
    line of anything outside it."""
    return _Reader(text).document()


def load(path: str) -> Node:
    """The YAML file at ``path`` (see :func:`loads`)."""
    with open(path, encoding="utf-8") as f:
        return loads(f.read())
