"""The YAML that test vectors use: a writer and a reader, without PyYAML.

The vectors' ``.yaml`` parts are what PyYAML's ``SafeDumper`` writes with
``default_flow_style=None``, ``sort_keys=False`` and no anchors (the
reference writer).  ``dump`` writes the same bytes for the values the
generators produce, and ``load`` reads them back as ``yaml.safe_load``
does; ``load(text, strings=True)`` keeps every scalar a string, as PyYAML's
``BaseLoader`` does, for the preset and config files (``config_util``).

The subset:

* values: dicts with string keys (1 to 127 characters), lists and tuples,
  ``int`` and ``bool`` (the exact types, as the safe representer wants),
  ``None``, and strings of printable ASCII.  A collection that holds only
  scalars, or nothing, is written in flow style (``[1, 2]``, ``{a: 1}``),
  wrapped after a comma once a line passes 80 columns; any other is
  written in block style.  A string that would read back as another type
  (``'0x00'``, ``'123'``, ``'true'``, ``''``) or that plain style cannot
  carry is single-quoted.  A top-level plain scalar ends its document with
  ``...``.
* reading: one document (an optional ``---`` and ``...``), comments, block
  mappings and sequences (a sequence may sit at its key's indentation),
  flow collections over several lines, plain, single- and double-quoted
  scalars over several lines; plain scalars resolve to null, booleans and
  integers as YAML 1.1 says (``0x``, ``0o``-style octal, ``0b``, base 60,
  underscores).

Anything outside it (other types, floats, anchors, tags, block scalars,
complex keys, directives, a second document) raises ``ValueError``.
"""
from __future__ import annotations

import re
from typing import Any, List, Optional

BEST_WIDTH = 80
BEST_INDENT = 2

# -- plain-scalar resolution (YAML 1.1, as the safe loader resolves) ---------

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
_MERGE = re.compile(r"^(?:<<)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_VALUE = re.compile(r"^(?:=)$")

# (tag, pattern) by the first character a plain scalar may start with, in
# the order the safe loader tries them
_RESOLVERS: dict = {}
for _tag, _pattern, _first in (
        ("bool", _BOOL, "yYnNtTfFoO"),
        ("float", _FLOAT, "-+0123456789."),
        ("int", _INT, "-+0123456789"),
        ("merge", _MERGE, "<"),
        ("null", _NULL, ["~", "n", "N", ""]),
        ("timestamp", _TIMESTAMP, "0123456789"),
        ("value", _VALUE, "=")):
    for _ch in _first:
        _RESOLVERS.setdefault(_ch, []).append((_tag, _pattern))


def _plain_tag(text: str) -> str:
    """The type a plain scalar ``text`` reads back as ("str" if none)."""
    for tag, pattern in _RESOLVERS.get(text[:1], ()):
        if pattern.match(text):
            return tag
    return "str"


# -- the writer --------------------------------------------------------------

_PRINTABLE = re.compile(r"^[\x20-\x7e]*$")
_WHITESPACE = "\0 \t\r\n\x85\u2028\u2029"


def _plain_allowed(text: str) -> tuple:
    """(flow plain allowed, block plain allowed) for a printable ASCII
    string, as the emitter's scalar analysis decides."""
    if not text:
        return False, True
    flow_ind = block_ind = False
    if text.startswith("---") or text.startswith("..."):
        flow_ind = block_ind = True
    n = len(text)
    preceded = True
    followed = n == 1 or text[1] in _WHITESPACE
    for index, ch in enumerate(text):
        if index == 0:
            if ch in "#,[]{}&*!|>'\"%@`":
                flow_ind = block_ind = True
            if ch in "?:":
                flow_ind = True
                if followed:
                    block_ind = True
            if ch == "-" and followed:
                flow_ind = block_ind = True
        else:
            if ch in ",?[]{}":
                flow_ind = True
            if ch == ":":
                flow_ind = True
                if followed:
                    block_ind = True
            if ch == "#" and preceded:
                flow_ind = block_ind = True
        preceded = ch in _WHITESPACE
        followed = index + 2 >= n or text[index + 2] in _WHITESPACE
    edge_space = text[0] == " " or text[-1] == " "
    return (not (edge_space or flow_ind), not (edge_space or block_ind))


def _is_scalar(value) -> bool:
    return value is None or type(value) in (bool, int, str)


def _flow(items) -> bool:
    return all(_is_scalar(v) for v in items)


class _Writer:
    """PyYAML's emitter, reduced to the subset: the same column, indent and
    whitespace bookkeeping, so that the same bytes come out."""

    def __init__(self):
        self.out: List[str] = []
        self.column = 0
        self.whitespace = True
        self.indention = True
        self.indent: Optional[int] = None
        self.indents: List[Optional[int]] = []
        self.flow_level = 0
        self.open_ended = False

    # primitives
    def increase_indent(self, flow=False, indentless=False):
        self.indents.append(self.indent)
        if self.indent is None:
            self.indent = BEST_INDENT if flow else 0
        elif not indentless:
            self.indent += BEST_INDENT

    def indicator(self, text, need_whitespace, whitespace=False,
                  indention=False):
        if not self.whitespace and need_whitespace:
            text = " " + text
        self.whitespace = whitespace
        self.indention = self.indention and indention
        self.column += len(text)
        self.open_ended = False
        self.out.append(text)

    def write_indent(self):
        indent = self.indent or 0
        if (not self.indention or self.column > indent
                or (self.column == indent and not self.whitespace)):
            self.line_break()
        if self.column < indent:
            self.whitespace = True
            self.out.append(" " * (indent - self.column))
            self.column = indent

    def line_break(self):
        self.whitespace = True
        self.indention = True
        self.column = 0
        self.out.append("\n")

    def write_plain(self, text, split, root):
        if root:
            self.open_ended = True
        if not text:
            return
        if not self.whitespace:
            self.column += 1
            self.out.append(" ")
        self.whitespace = False
        self.indention = False
        if " " not in text:
            self.column += len(text)
            self.out.append(text)
            return
        spaces = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch != " ":
                    if start + 1 == end and self.column > BEST_WIDTH and split:
                        self.write_indent()
                        self.whitespace = False
                        self.indention = False
                    else:
                        self.column += end - start
                        self.out.append(text[start:end])
                    start = end
            elif ch is None or ch == " ":
                self.column += end - start
                self.out.append(text[start:end])
                start = end
            if ch is not None:
                spaces = ch == " "
            end += 1

    def write_single_quoted(self, text, split):
        self.indicator("'", True)
        spaces = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch is None or ch != " ":
                    if (start + 1 == end and self.column > BEST_WIDTH and split
                            and start != 0 and end != len(text)):
                        self.write_indent()
                    else:
                        self.column += end - start
                        self.out.append(text[start:end])
                    start = end
            elif ch is None or ch == " " or ch == "'":
                if start < end:
                    self.column += end - start
                    self.out.append(text[start:end])
                    start = end
            if ch == "'":
                self.column += 2
                self.out.append("''")
                start = end + 1
            if ch is not None:
                spaces = ch == " "
            end += 1
        self.indicator("'", False)

    # nodes
    def node(self, value, root=False, mapping=False, simple_key=False):
        if type(value) is dict:
            if self.flow_level or not value or _flow(value.values()):
                self.flow_mapping(value)
            else:
                self.block_mapping(value)
        elif type(value) in (list, tuple):
            if self.flow_level or not value or _flow(value):
                self.flow_sequence(value)
            else:
                self.block_sequence(value, mapping)
        else:
            self.scalar(value, root, simple_key)

    def scalar(self, value, root, simple_key):
        if value is None:
            text, plain_ok = "null", True
        elif type(value) is bool:
            text, plain_ok = ("true" if value else "false"), True
        elif type(value) is int:
            text, plain_ok = str(value), True
        elif type(value) is str:
            if not _PRINTABLE.match(value):
                raise ValueError(f"string outside the vector YAML subset: {value!r}")
            text, plain_ok = value, _plain_tag(value) == "str"
        else:
            raise ValueError(
                f"{type(value).__name__} is outside the vector YAML subset")
        self.increase_indent(flow=True)
        flow_plain, block_plain = (True, True) if type(value) is not str \
            else _plain_allowed(text)
        if plain_ok and not (simple_key and not text) and (
                flow_plain if self.flow_level else block_plain):
            self.write_plain(text, not simple_key, root)
        else:
            self.write_single_quoted(text, not simple_key)
        self.indent = self.indents.pop()

    def key(self, k):
        if type(k) is not str or not 0 < len(k) < 128:
            raise ValueError(f"mapping key outside the vector YAML subset: {k!r}")
        self.node(k, mapping=True, simple_key=True)

    def flow_sequence(self, items):
        self.indicator("[", True, whitespace=True)
        self.flow_level += 1
        self.increase_indent(flow=True)
        for i, item in enumerate(items):
            if i:
                self.indicator(",", False)
            if self.column > BEST_WIDTH:
                self.write_indent()
            self.node(item)
        self.indent = self.indents.pop()
        self.flow_level -= 1
        self.indicator("]", False)

    def flow_mapping(self, mapping):
        self.indicator("{", True, whitespace=True)
        self.flow_level += 1
        self.increase_indent(flow=True)
        for i, (k, v) in enumerate(mapping.items()):
            if i:
                self.indicator(",", False)
            if self.column > BEST_WIDTH:
                self.write_indent()
            self.key(k)
            self.indicator(":", False)
            self.node(v, mapping=True)
        self.indent = self.indents.pop()
        self.flow_level -= 1
        self.indicator("}", False)

    def block_sequence(self, items, mapping_context):
        self.increase_indent(indentless=mapping_context and not self.indention)
        for item in items:
            self.write_indent()
            self.indicator("-", True, indention=True)
            self.node(item)
        self.indent = self.indents.pop()

    def block_mapping(self, mapping):
        self.increase_indent()
        for k, v in mapping.items():
            self.write_indent()
            self.key(k)
            self.indicator(":", False)
            self.node(v, mapping=True)
        self.indent = self.indents.pop()


def dump(data: Any) -> str:
    """``data`` as the reference writer's YAML document (see the module
    docstring for the subset; anything else raises ``ValueError``)."""
    writer = _Writer()
    writer.node(data, root=True)
    writer.write_indent()
    if writer.open_ended:
        writer.indicator("...", True)
        writer.write_indent()
    return "".join(writer.out)


# -- the reader --------------------------------------------------------------

_END = "\0 \t\r\n"
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}


def _int(text: str) -> int:
    value = text.replace("_", "")
    sign = 1
    if value[0] == "-":
        sign = -1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        digits = [int(part) for part in value.split(":")]
        digits.reverse()
        base, total = 1, 0
        for digit in digits:
            total += digit * base
            base *= 60
        return sign * total
    return sign * int(value)


class _Reader:
    def __init__(self, text: str, strings: bool):
        if re.search(r"^ *\t", text, re.M):
            raise ValueError("tabs in indentation are outside the subset")
        self.s = text.replace("\r\n", "\n") + "\0"
        self.i = 0
        self.strings = strings

    # position helpers
    def peek(self, k=0) -> str:
        return self.s[self.i + k]

    def column(self) -> int:
        return self.i - (self.s.rfind("\n", 0, self.i) + 1)

    def error(self, what: str):
        line = self.s.count("\n", 0, self.i) + 1
        raise ValueError(
            f"vector YAML line {line}, column {self.column() + 1}: {what}")

    def at_document_marker(self) -> bool:
        return (self.column() == 0 and self.s[self.i:self.i + 3] in ("---", "...")
                and self.s[self.i + 3] in _END)

    def skip_line_rest(self):
        """Spaces and a comment up to and through the line break."""
        while self.peek() == " ":
            self.i += 1
        if self.peek() == "#":
            while self.peek() not in "\n\0":
                self.i += 1
        if self.peek() == "\n":
            self.i += 1
        elif self.peek() != "\0":
            self.error(f"unexpected {self.peek()!r}")

    def next_content(self) -> Optional[int]:
        """Skip blank and comment lines; the next content line's indent
        (``i`` left at its start), or None at the end."""
        while True:
            start = self.i
            while self.peek() == " ":
                self.i += 1
            ch = self.peek()
            if ch == "\0":
                return None
            if ch in "#\n":
                self.i = start
                self.skip_line_rest()
                continue
            indent = self.i - start
            self.i = start
            return indent

    # scalars
    def resolve(self, text: str, plain: bool):
        if self.strings or not plain:
            return text
        tag = _plain_tag(text)
        if tag == "str":
            return text
        if tag == "null":
            return None
        if tag == "bool":
            return text.lower() in ("yes", "true", "on")
        if tag == "int":
            return _int(text)
        self.error(f"a {tag} scalar is outside the subset: {text!r}")

    def plain(self, flow: bool, indent: int) -> str:
        """A plain scalar (possibly over several lines) whose lines after
        the first need a column above ``indent`` in block context; ``i``
        is left just after its last character."""
        chunks: List[str] = []
        spaces: List[str] = []
        end = self.i
        while True:
            if self.peek() == "#":
                break
            n = 0
            ends = _END + ",[]{}" if flow else _END
            while True:
                ch = self.peek(n)
                if (ch in _END or (ch == ":" and self.peek(n + 1) in ends)
                        or (flow and ch in ",?[]{}")):
                    break
                n += 1
            if n == 0:
                break
            chunks.extend(spaces)
            chunks.append(self.s[self.i:self.i + n])
            self.i += n
            end = self.i
            spaces = self.plain_spaces()
            if (spaces is None or self.peek() == "#"
                    or (not flow and self.column() <= indent)):
                break
        self.i = end
        if not chunks:
            self.error("expected a scalar")
        return "".join(chunks)

    def plain_spaces(self) -> Optional[List[str]]:
        start = self.i
        while self.peek() == " ":
            self.i += 1
        whitespace = self.s[start:self.i]
        if self.peek() != "\n":
            return [whitespace] if whitespace else []
        self.i += 1
        if self.at_document_marker():
            return None
        breaks = []
        while self.peek() in " \n":
            if self.peek() == " ":
                self.i += 1
            else:
                self.i += 1
                breaks.append("\n")
                if self.at_document_marker():
                    return None
        return breaks if breaks else [" "]

    def quoted(self) -> str:
        quote = self.peek()
        double = quote == '"'
        self.i += 1
        chunks: List[str] = []
        while True:
            # non-space characters
            while True:
                ch = self.peek()
                if not double and ch == "'" and self.peek(1) == "'":
                    chunks.append("'")
                    self.i += 2
                elif (double and ch == "'") or (not double and ch in '"\\'):
                    chunks.append(ch)
                    self.i += 1
                elif double and ch == "\\":
                    self.i += 1
                    ch = self.peek()
                    if ch in _ESCAPES:
                        chunks.append(_ESCAPES[ch])
                        self.i += 1
                    elif ch in _ESCAPE_CODES:
                        n = _ESCAPE_CODES[ch]
                        code = self.s[self.i + 1:self.i + 1 + n]
                        if not re.fullmatch(r"[0-9A-Fa-f]{%d}" % n, code):
                            self.error(f"bad escape \\{ch}{code}")
                        chunks.append(chr(int(code, 16)))
                        self.i += 1 + n
                    elif ch == "\n":
                        self.i += 1
                        chunks.extend(self.quoted_breaks())
                    else:
                        self.error(f"unknown escape \\{ch}")
                elif ch in "'\"\\\0 \t\n":
                    break
                else:
                    start = self.i
                    while self.peek() not in "'\"\\\0 \t\n":
                        self.i += 1
                    chunks.append(self.s[start:self.i])
            if self.peek() == quote:
                self.i += 1
                return "".join(chunks)
            # spaces and line breaks
            start = self.i
            while self.peek() in " \t":
                self.i += 1
            ch = self.peek()
            if ch == "\0":
                self.error("unterminated quoted scalar")
            if ch == "\n":
                self.i += 1
                breaks = self.quoted_breaks()
                chunks.extend(breaks if breaks else [" "])
            else:
                chunks.append(self.s[start:self.i])

    def quoted_breaks(self) -> List[str]:
        breaks = []
        while True:
            if self.at_document_marker():
                self.error("document marker inside a quoted scalar")
            while self.peek() in " \t":
                self.i += 1
            if self.peek() == "\n":
                self.i += 1
                breaks.append("\n")
            else:
                return breaks

    def scalar(self, flow: bool, indent: int):
        ch = self.peek()
        if ch in "'\"":
            return self.quoted()
        if ch in _END + "-?:,[]{}#&*!|>%@`" and not (
                self.peek(1) not in _END
                and (ch == "-" or (not flow and ch in "?:"))):
            self.error(f"{ch!r} is outside the subset")
        return self.resolve(self.plain(flow, indent), True)

    # flow collections
    def flow_space(self):
        while True:
            ch = self.peek()
            if ch in " \t\n":
                self.i += 1
            elif ch == "#":
                while self.peek() not in "\n\0":
                    self.i += 1
            else:
                return

    def flow_node(self):
        self.flow_space()
        ch = self.peek()
        if ch == "[":
            self.i += 1
            out = []
            self.flow_space()
            while self.peek() != "]":
                out.append(self.flow_node())
                self.flow_space()
                if self.peek() == ",":
                    self.i += 1
                    self.flow_space()
                elif self.peek() != "]":
                    self.error("expected ',' or ']'")
            self.i += 1
            return out
        if ch == "{":
            self.i += 1
            out = {}
            self.flow_space()
            while self.peek() != "}":
                key = self.flow_node()
                self.flow_space()
                if self.peek() != ":":
                    self.error("expected ':' in a flow mapping")
                self.i += 1
                self.flow_space()
                out[key] = (self.resolve("", True) if self.peek() in ",}"
                            else self.flow_node())
                self.flow_space()
                if self.peek() == ",":
                    self.i += 1
                    self.flow_space()
                elif self.peek() != "}":
                    self.error("expected ',' or '}'")
            self.i += 1
            return out
        if ch in "]}," or ch == "\0":
            self.error(f"unexpected {ch!r}")
        if ch in "'\"":
            return self.quoted()
        return self.scalar(True, -1)

    # block collections
    def key_ahead(self) -> bool:
        """Whether the line from ``i`` is ``key:`` followed by a space or its end."""
        j = self.i
        s = self.s
        if s[j] in "'\"":
            quote = s[j]
            j += 1
            while s[j] not in "\n\0":
                if s[j] == quote:
                    if quote == "'" and s[j + 1] == "'":
                        j += 2
                        continue
                    break
                j += 2 if (quote == '"' and s[j] == "\\") else 1
            if s[j] != quote:
                return False
            j += 1
            while s[j] == " ":
                j += 1
            return s[j] == ":" and s[j + 1] in _END
        if s[j] in "[{#":
            return False
        while s[j] not in "\n\0":
            if s[j] == ":" and s[j + 1] in _END:
                return True
            if s[j] == "#" and s[j - 1] == " ":
                return False
            j += 1
        return False

    def inline_value(self, indent: int):
        """A node starting at ``i`` on its line; ``i`` is left at the start
        of the next line."""
        ch = self.peek()
        if ch in "[{":
            value = self.flow_node()
        else:
            value = self.scalar(False, indent)
        self.skip_line_rest()
        return value

    def block_node_at(self, column: int, parent: int):
        """The block node whose first character is at ``i`` (column
        ``column``) inside a collection at indent ``parent``."""
        if self.peek() == "-" and self.peek(1) in _END:
            return self.block_sequence(column)
        if self.key_ahead():
            return self.block_mapping(column)
        return self.inline_value(parent)

    def block_sequence(self, column: int):
        out = []
        while True:
            self.i += 1  # the '-'
            while self.peek() == " ":
                self.i += 1
            if self.peek() in "#\n\0":
                self.skip_line_rest()
                out.append(self.nested(column))
            else:
                out.append(self.block_node_at(self.column(), column))
            indent = self.next_content()
            if indent is None or indent < column:
                return out
            if indent > column:
                self.error("bad indentation of a sequence entry")
            self.i += indent
            if not (self.peek() == "-" and self.peek(1) in _END):
                self.i -= indent
                return out

    def block_mapping(self, column: int):
        out = {}
        while True:
            if self.peek() in "'\"":
                key = self.quoted()
            else:
                key = self.resolve(self.plain(False, column), True)
            while self.peek() == " ":
                self.i += 1
            if self.peek() != ":":
                self.error("expected ':'")
            self.i += 1
            while self.peek() == " ":
                self.i += 1
            if self.peek() in "#\n\0":
                self.skip_line_rest()
                value = self.nested(column, mapping_value=True)
            else:
                value = self.inline_value(column)
            out[key] = value
            indent = self.next_content()
            if indent is None or indent < column:
                return out
            if indent > column:
                self.error("bad indentation of a mapping entry")
            self.i += indent
            if self.at_document_marker():
                self.i -= indent
                return out
            if not self.key_ahead():
                self.error("expected a mapping key")

    def nested(self, parent: int, mapping_value: bool = False):
        """The node on the lines after a ``key:`` or ``-`` with nothing
        after it: more indented than ``parent``, or (a mapping's value) a
        sequence at ``parent``'s own indent; else an empty node."""
        start = self.i
        indent = self.next_content()
        if indent is not None:
            self.i += indent
            if self.at_document_marker():
                pass
            elif indent > parent:
                return self.block_node_at(indent, parent)
            elif (mapping_value and indent == parent and self.peek() == "-"
                  and self.peek(1) in _END):
                return self.block_sequence(indent)
        self.i = start
        return self.resolve("", True)

    def document(self):
        indent = self.next_content()
        if indent is None:
            return None
        if indent == 0 and self.peek() == "%":
            self.error("directives are outside the subset")
        value = None
        if self.at_document_marker() and self.s.startswith("---", self.i):
            self.i += 3
            while self.peek() == " ":
                self.i += 1
            if self.peek() in "#\n\0":
                self.skip_line_rest()
                value = self.nested(-1)
            else:
                value = self.block_node_at(self.column(), -1)
        elif not self.at_document_marker():
            self.i += indent
            value = self.block_node_at(indent, -1)
        indent = self.next_content()
        if (indent == 0 and self.s.startswith("...", self.i)
                and self.at_document_marker()):
            self.i += 3
            self.skip_line_rest()
            indent = self.next_content()
        if indent is not None:
            self.error("content after the document")
        return value


def load(text: str, strings: bool = False):
    """The value of one YAML document of the subset, as ``yaml.safe_load``
    gives it; with ``strings`` every scalar stays a string, as
    ``yaml.BaseLoader`` leaves it."""
    return _Reader(text, strings).document()
