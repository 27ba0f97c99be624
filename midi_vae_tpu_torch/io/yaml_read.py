"""A YAML reader that returns what PyYAML's ``yaml.safe_load`` returns, in
plain Python (the JAX package reads ``--config`` with ``yaml.safe_load``;
the machine the port runs on has no PyYAML).

It reads YAML 1.1 as PyYAML's pure-Python ``SafeLoader`` does, stage for
stage: a scanner (characters → tokens: indentation, simple keys, plain,
quoted and block scalars, flow collections, anchors, tags, directives), a
parser that builds the node graph (aliases share their anchor's node),
and a constructor with the ``SafeLoader`` resolvers and types: null, bool
(``yes/no/on/off``), int (``0b``, ``0x``, leading-0 octal, ``_``, base 60),
float (``.inf``, ``.nan``, ``1.``, base 60; ``1e-3`` without a dot stays a
string), timestamps (``datetime.date``/``datetime.datetime``), ``!!binary``,
``!!set``, ``!!omap``, ``!!pairs``, the ``<<`` merge key and the ``=`` key.

Where ``safe_load`` raises, :func:`read_yaml` raises ``ValueError`` naming
the file and line: a character no token starts with (a tab in
indentation), bad indentation, an undefined or duplicate anchor, a second
document, a tag ``SafeLoader`` has no constructor for (``!!python/...``,
local tags), an unhashable key.
"""

from __future__ import annotations

import base64
import binascii
import datetime
import re
from typing import Any, Dict, List, Optional, Tuple

_BREAK = "\r\n\x85\u2028\u2029"
_BREAK_OR_END = "\0" + _BREAK
_SPACE_OR_END = "\0 " + _BREAK
_BLANK_OR_END = "\0 \t" + _BREAK
_WORD = re.compile(r"[0-9A-Za-z_-]*")  # anchor, directive and tag-handle characters
_URI_CHARS = frozenset("0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz-;/?:@&=+$,_.!~*'()[]%")
_HEX = "0123456789ABCDEFabcdef"
_NON_PRINTABLE = re.compile("[^\x09\x0A\x0D\x20-\x7E\x85\xA0-\uD7FF\uE000-\uFFFD\U00010000-\U0010ffff]")
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\x09", "\t": "\x09", "n": "\x0A", "v": "\x0B", "f": "\x0C",
            "r": "\x0D", "e": "\x1B", " ": " ", '"': '"', "\\": "\\", "/": "/", "N": "\x85", "_": "\xA0",
            "L": "\u2028", "P": "\u2029"}
_ESCAPE_DIGITS = {"x": 2, "u": 4, "U": 8}

_TAG = "tag:yaml.org,2002:"
_DEFAULT_HANDLES = {"!": "!", "!!": _TAG}


class _YAMLError(Exception):
    """A document ``safe_load`` refuses, at a 0-based line."""

    def __init__(self, message: str, line: int):
        super().__init__(message)
        self.line = line


class _Token:
    __slots__ = ("kind", "value", "line", "plain")

    def __init__(self, kind: str, line: int, value: Any = None, plain: bool = False):
        self.kind, self.line, self.value, self.plain = kind, line, value, plain


class _SimpleKey:
    __slots__ = ("token_number", "required", "index", "line", "column")

    def __init__(self, token_number: int, required: bool, index: int, line: int, column: int):
        self.token_number, self.required, self.index, self.line, self.column = (token_number, required, index, line,
                                                                                 column)


# ------------------------------------------------------------------ scanner


class _Scanner:
    """Characters → tokens, the whole stream at once."""

    def __init__(self, text: str):
        bad = _NON_PRINTABLE.search(text)
        if bad:
            raise _YAMLError(f"special character {bad.group()!r} is not allowed",
                            len(re.findall("\n|\r(?!\n)|[\x85\u2028\u2029]", text[: bad.start()])))
        self.s = text + "\0"
        self.i = self.line = self.column = 0
        self.flow_level = 0
        self.indent = -1
        self.indents: List[int] = []
        self.allow_simple_key = True
        self.simple_keys: Dict[int, _SimpleKey] = {}
        self.tokens = [_Token("stream-start", 0)]
        self.done = False
        while not self.done:
            self.fetch()

    # characters

    def peek(self, k: int = 0) -> str:
        j = self.i + k
        return self.s[j] if j < len(self.s) else "\0"

    def prefix(self, n: int) -> str:
        return self.s[self.i : self.i + n]

    def forward(self, n: int = 1) -> None:
        for _ in range(n):
            ch = self.s[self.i]
            self.i += 1
            if ch in "\n\x85\u2028\u2029" or (ch == "\r" and self.peek() != "\n"):
                self.line += 1
                self.column = 0
            elif ch != "\ufeff":
                self.column += 1

    def error(self, message: str) -> _YAMLError:
        return _YAMLError(message, self.line)

    def line_break(self) -> str:
        ch = self.peek()
        if ch in "\r\n\x85":
            self.forward(2 if self.prefix(2) == "\r\n" else 1)
            return "\n"
        if ch in "\u2028\u2029":
            self.forward()
            return ch
        return ""

    def at_document_marker(self) -> bool:
        return self.prefix(3) in ("---", "...") and self.peek(3) in _BLANK_OR_END

    # simple keys and indentation

    def stale_simple_keys(self) -> None:
        for level, key in list(self.simple_keys.items()):
            if key.line != self.line or self.i - key.index > 1024:
                if key.required:
                    raise _YAMLError("could not find the expected ':' of a simple key", key.line)
                del self.simple_keys[level]

    def save_simple_key(self) -> None:
        if self.allow_simple_key:
            self.remove_simple_key()
            required = not self.flow_level and self.indent == self.column
            self.simple_keys[self.flow_level] = _SimpleKey(len(self.tokens), required, self.i, self.line,
                                                           self.column)

    def remove_simple_key(self) -> None:
        key = self.simple_keys.pop(self.flow_level, None)
        if key is not None and key.required:
            raise _YAMLError("could not find the expected ':' of a simple key", key.line)

    def unwind_indent(self, column: int) -> None:
        if self.flow_level:
            return
        while self.indent > column:
            self.indent = self.indents.pop()
            self.tokens.append(_Token("block-end", self.line))

    def add_indent(self, column: int) -> bool:
        if self.indent < column:
            self.indents.append(self.indent)
            self.indent = column
            return True
        return False

    # tokens

    def fetch(self) -> None:
        self.skip_to_next_token()
        self.stale_simple_keys()
        self.unwind_indent(self.column)
        ch, nxt = self.peek(), self.peek(1)
        if ch == "\0":
            self.unwind_indent(-1)
            self.remove_simple_key()
            self.allow_simple_key = False
            self.simple_keys = {}
            self.tokens.append(_Token("stream-end", self.line))
            self.done = True
        elif ch == "%" and self.column == 0:
            self.unwind_indent(-1)
            self.remove_simple_key()
            self.allow_simple_key = False
            self.tokens.append(self.scan_directive())
        elif ch in "-." and self.column == 0 and self.prefix(3) in ("---", "...") and self.peek(3) in _BLANK_OR_END:
            self.unwind_indent(-1)
            self.remove_simple_key()
            self.allow_simple_key = False
            line = self.line
            self.forward(3)
            self.tokens.append(_Token("document-start" if ch == "-" else "document-end", line))
        elif ch in "[{":
            self.save_simple_key()
            self.flow_level += 1
            self.allow_simple_key = True
            self.simple_token("flow-sequence-start" if ch == "[" else "flow-mapping-start")
        elif ch in "]}":
            self.remove_simple_key()
            self.flow_level -= 1
            self.allow_simple_key = False
            self.simple_token("flow-sequence-end" if ch == "]" else "flow-mapping-end")
        elif ch == ",":
            self.allow_simple_key = True
            self.remove_simple_key()
            self.simple_token("flow-entry")
        elif ch == "-" and nxt in _BLANK_OR_END:
            if not self.flow_level:
                if not self.allow_simple_key:
                    raise self.error("sequence entries are not allowed here")
                if self.add_indent(self.column):
                    self.tokens.append(_Token("block-sequence-start", self.line))
            self.allow_simple_key = True
            self.remove_simple_key()
            self.simple_token("block-entry")
        elif ch == "?" and (self.flow_level or nxt in _BLANK_OR_END):
            if not self.flow_level:
                if not self.allow_simple_key:
                    raise self.error("mapping keys are not allowed here")
                if self.add_indent(self.column):
                    self.tokens.append(_Token("block-mapping-start", self.line))
            self.allow_simple_key = not self.flow_level
            self.remove_simple_key()
            self.simple_token("key")
        elif ch == ":" and (self.flow_level or nxt in _BLANK_OR_END):
            self.fetch_value()
        elif ch in "*&":
            self.save_simple_key()
            self.allow_simple_key = False
            self.tokens.append(self.scan_anchor())
        elif ch == "!":
            self.save_simple_key()
            self.allow_simple_key = False
            self.tokens.append(self.scan_tag())
        elif ch in "|>" and not self.flow_level:
            self.allow_simple_key = True
            self.remove_simple_key()
            self.tokens.append(self.scan_block_scalar(folded=ch == ">"))
        elif ch in "'\"":
            self.save_simple_key()
            self.allow_simple_key = False
            self.tokens.append(self.scan_flow_scalar(double=ch == '"'))
        elif ch not in _BLANK_OR_END + "-?:,[]{}#&*!|>'\"%@`" or (
                nxt not in _BLANK_OR_END and (ch == "-" or (not self.flow_level and ch in "?:"))):
            self.save_simple_key()
            self.allow_simple_key = False
            self.tokens.append(self.scan_plain())
        else:
            raise self.error(f"found character {ch!r} that cannot start any token")

    def simple_token(self, kind: str) -> None:
        self.tokens.append(_Token(kind, self.line))
        self.forward()

    def fetch_value(self) -> None:
        key = self.simple_keys.pop(self.flow_level, None)
        if key is not None:
            self.tokens.insert(key.token_number, _Token("key", key.line))
            if not self.flow_level and self.add_indent(key.column):
                self.tokens.insert(key.token_number, _Token("block-mapping-start", key.line))
            self.allow_simple_key = False
        else:
            if not self.flow_level:
                if not self.allow_simple_key:
                    raise self.error("mapping values are not allowed here")
                if self.add_indent(self.column):
                    self.tokens.append(_Token("block-mapping-start", self.line))
            self.allow_simple_key = not self.flow_level
            self.remove_simple_key()
        self.simple_token("value")

    def skip_to_next_token(self) -> None:
        if self.i == 0 and self.peek() == "\ufeff":
            self.forward()
        while True:
            while self.peek() == " ":
                self.forward()
            if self.peek() == "#":
                while self.peek() not in _BREAK_OR_END:
                    self.forward()
            if not self.line_break():
                return
            if not self.flow_level:
                self.allow_simple_key = True

    def skip_comment_to_line_end(self, what: str) -> None:
        while self.peek() == " ":
            self.forward()
        if self.peek() == "#":
            while self.peek() not in _BREAK_OR_END:
                self.forward()
        if self.peek() not in _BREAK_OR_END:
            raise self.error(f"expected a comment or a line break after {what}, found {self.peek()!r}")
        self.line_break()

    def word(self) -> str:
        return _WORD.match(self.s, self.i).group()

    def scan_directive(self) -> _Token:
        line = self.line
        self.forward()
        name = self.word()
        if not name or self.peek(len(name)) not in _SPACE_OR_END:
            raise self.error("expected an alphanumeric directive name")
        self.forward(len(name))
        value = None
        if name == "YAML":
            while self.peek() == " ":
                self.forward()
            numbers = []
            for end in (".", _SPACE_OR_END):
                digits = re.match(r"[0-9]*", self.s[self.i :]).group()
                if not digits or self.peek(len(digits)) not in end:
                    raise self.error("malformed %YAML directive")
                numbers.append(int(digits))
                self.forward(len(digits) + (end == "."))
            value = tuple(numbers)
        elif name == "TAG":
            while self.peek() == " ":
                self.forward()
            handle = self.scan_tag_handle()
            if self.peek() != " ":
                raise self.error("expected ' ' after the %TAG handle")
            while self.peek() == " ":
                self.forward()
            prefix = self.scan_tag_uri()
            if self.peek() not in _SPACE_OR_END:
                raise self.error("expected ' ' after the %TAG prefix")
            value = (handle, prefix)
        else:
            while self.peek() not in _BREAK_OR_END:
                self.forward()
        self.skip_comment_to_line_end("a directive")
        return _Token("directive", line, (name, value))

    def scan_anchor(self) -> _Token:
        line, kind = self.line, "alias" if self.peek() == "*" else "anchor"
        self.forward()
        name = self.word()
        if not name or self.peek(len(name)) not in _BLANK_OR_END + "?:,]}%@`":
            raise self.error(f"expected an alphanumeric {kind} name")
        self.forward(len(name))
        return _Token(kind, line, name)

    def scan_tag(self) -> _Token:
        line, nxt = self.line, self.peek(1)
        if nxt == "<":
            handle = None
            self.forward(2)
            suffix = self.scan_tag_uri()
            if self.peek() != ">":
                raise self.error(f"expected '>' to close a verbatim tag, found {self.peek()!r}")
            self.forward()
        elif nxt in _BLANK_OR_END:
            handle, suffix = None, "!"
            self.forward()
        else:
            k = 1
            while self.peek(k) not in _SPACE_OR_END and self.peek(k) != "!":
                k += 1
            if self.peek(k) == "!":
                handle = self.scan_tag_handle()
            else:
                handle = "!"
                self.forward()
            suffix = self.scan_tag_uri()
        if self.peek() not in _SPACE_OR_END:
            raise self.error(f"expected ' ' after a tag, found {self.peek()!r}")
        return _Token("tag", line, (handle, suffix))

    def scan_tag_handle(self) -> str:
        if self.peek() != "!":
            raise self.error(f"expected '!', found {self.peek()!r}")
        k = 1
        if self.peek(1) != " ":
            k += len(_WORD.match(self.s, self.i + 1).group())
            if self.peek(k) != "!":
                self.forward(k)
                raise self.error(f"expected '!', found {self.peek()!r}")
            k += 1
        handle = self.prefix(k)
        self.forward(k)
        return handle

    def scan_tag_uri(self) -> str:
        chunks = []
        k = 0
        while self.peek(k) in _URI_CHARS:
            if self.peek(k) == "%":
                chunks.append(self.prefix(k))
                self.forward(k)
                k = 0
                codes = []
                while self.peek() == "%":
                    self.forward()
                    if self.peek(0) not in _HEX or self.peek(1) not in _HEX:
                        raise self.error("expected a URI escape of 2 hexadecimal digits")
                    codes.append(int(self.prefix(2), 16))
                    self.forward(2)
                try:
                    chunks.append(bytes(codes).decode("utf-8"))
                except UnicodeDecodeError as e:
                    raise self.error(str(e)) from None
            else:
                k += 1
        if k:
            chunks.append(self.prefix(k))
            self.forward(k)
        if not chunks:
            raise self.error(f"expected a URI, found {self.peek()!r}")
        return "".join(chunks)

    def scan_block_scalar(self, folded: bool) -> _Token:
        line = self.line
        self.forward()
        chomping, increment = None, None
        for _ in range(2):
            ch = self.peek()
            if ch in "+-" and chomping is None:
                chomping = ch == "+"
                self.forward()
            elif ch in "0123456789" and increment is None:
                if ch == "0":
                    raise self.error("expected an indentation indicator in 1-9, found 0")
                increment = int(ch)
                self.forward()
        if self.peek() not in _SPACE_OR_END:
            raise self.error(f"expected chomping or indentation indicators, found {self.peek()!r}")
        self.skip_comment_to_line_end("a block scalar's indicators")
        min_indent = max(self.indent + 1, 1)
        if increment is None:
            breaks, max_indent = [], 0
            while self.peek() in " " + _BREAK:
                if self.peek() != " ":
                    breaks.append(self.line_break())
                else:
                    self.forward()
                    max_indent = max(max_indent, self.column)
            indent = max(min_indent, max_indent)
        else:
            indent = min_indent + increment - 1
            breaks = self.block_scalar_breaks(indent)
        chunks: List[str] = []
        line_break = ""
        while self.column == indent and self.peek() != "\0":
            chunks.extend(breaks)
            leading_non_space = self.peek() not in " \t"
            k = 0
            while self.peek(k) not in _BREAK_OR_END:
                k += 1
            chunks.append(self.prefix(k))
            self.forward(k)
            line_break = self.line_break()
            breaks = self.block_scalar_breaks(indent)
            if self.column != indent or self.peek() == "\0":
                break
            if folded and line_break == "\n" and leading_non_space and self.peek() not in " \t":
                if not breaks:
                    chunks.append(" ")
            else:
                chunks.append(line_break)
        if chomping is not False:
            chunks.append(line_break)
        if chomping is True:
            chunks.extend(breaks)
        return _Token("scalar", line, "".join(chunks))

    def block_scalar_breaks(self, indent: int) -> List[str]:
        breaks = []
        while self.column < indent and self.peek() == " ":
            self.forward()
        while self.peek() in _BREAK:
            breaks.append(self.line_break())
            while self.column < indent and self.peek() == " ":
                self.forward()
        return breaks

    def scan_flow_scalar(self, double: bool) -> _Token:
        line, quote = self.line, self.peek()
        self.forward()
        chunks = self.quoted_non_spaces(double)
        while self.peek() != quote:
            chunks += self.quoted_spaces(double)
            chunks += self.quoted_non_spaces(double)
        self.forward()
        return _Token("scalar", line, "".join(chunks))

    def quoted_non_spaces(self, double: bool) -> List[str]:
        chunks = []
        while True:
            k = 0
            while self.peek(k) not in "'\"\\" + _BLANK_OR_END:
                k += 1
            if k:
                chunks.append(self.prefix(k))
                self.forward(k)
            ch = self.peek()
            if not double and ch == "'" and self.peek(1) == "'":
                chunks.append("'")
                self.forward(2)
            elif (double and ch == "'") or (not double and ch in '"\\'):
                chunks.append(ch)
                self.forward()
            elif double and ch == "\\":
                self.forward()
                ch = self.peek()
                if ch in _ESCAPES:
                    chunks.append(_ESCAPES[ch])
                    self.forward()
                elif ch in _ESCAPE_DIGITS:
                    n = _ESCAPE_DIGITS[ch]
                    self.forward()
                    if any(self.peek(j) not in _HEX for j in range(n)):
                        raise self.error(f"expected an escape of {n} hexadecimal digits")
                    chunks.append(chr(int(self.prefix(n), 16)))
                    self.forward(n)
                elif ch in _BREAK:
                    self.line_break()
                    chunks += self.quoted_breaks()
                else:
                    raise self.error(f"unknown escape character {ch!r} in a double-quoted scalar")
            else:
                return chunks

    def quoted_spaces(self, double: bool) -> List[str]:
        k = 0
        while self.peek(k) in " \t":
            k += 1
        spaces = self.prefix(k)
        self.forward(k)
        ch = self.peek()
        if ch == "\0":
            raise self.error("unexpected end of the stream in a quoted scalar")
        if ch not in _BREAK:
            return [spaces]
        line_break = self.line_break()
        breaks = self.quoted_breaks()
        if line_break != "\n":
            return [line_break] + breaks
        return breaks or [" "]

    def quoted_breaks(self) -> List[str]:
        breaks = []
        while True:
            if self.at_document_marker():
                raise self.error("unexpected document separator in a quoted scalar")
            while self.peek() in " \t":
                self.forward()
            if self.peek() not in _BREAK:
                return breaks
            breaks.append(self.line_break())

    def scan_plain(self) -> _Token:
        line = self.line
        chunks: List[str] = []
        indent = self.indent + 1
        spaces: List[str] = []
        stops = _BLANK_OR_END + (",[]{}" if self.flow_level else "")
        while self.peek() != "#":
            k = 0
            while True:
                ch = self.peek(k)
                if ch in _BLANK_OR_END or (ch == ":" and self.peek(k + 1) in stops) or (
                        self.flow_level and ch in ",?[]{}"):
                    break
                k += 1
            if not k:
                break
            self.allow_simple_key = False
            chunks += spaces
            chunks.append(self.prefix(k))
            self.forward(k)
            spaces = self.plain_spaces()
            if not spaces or self.peek() == "#" or (not self.flow_level and self.column < indent):
                break
        return _Token("scalar", line, "".join(chunks), plain=True)

    def plain_spaces(self) -> List[str]:
        k = 0
        while self.peek(k) == " ":
            k += 1
        spaces = self.prefix(k)
        self.forward(k)
        if self.peek() not in _BREAK:
            return [spaces] if spaces else []
        line_break = self.line_break()
        self.allow_simple_key = True
        if self.at_document_marker():
            return []
        breaks = []
        while self.peek() in " " + _BREAK:
            if self.peek() == " ":
                self.forward()
            else:
                breaks.append(self.line_break())
                if self.at_document_marker():
                    return []
        if line_break != "\n":
            return [line_break] + breaks
        return breaks or [" "]


# ------------------------------------------------------------ parser (→ nodes)


class _Node:
    __slots__ = ("kind", "tag", "value", "line")

    def __init__(self, kind: str, tag: str, value: Any, line: int):
        self.kind, self.tag, self.value, self.line = kind, tag, value, line


class _Parser:
    """Tokens → the document's node graph (an alias is its anchor's node)."""

    def __init__(self, tokens: List[_Token]):
        self.tokens = tokens
        self.pos = 0
        self.handles = dict(_DEFAULT_HANDLES)
        self.anchors: Dict[str, _Node] = {}

    def peek(self) -> _Token:
        return self.tokens[self.pos]

    def at(self, *kinds: str) -> bool:
        return self.tokens[self.pos].kind in kinds

    def take(self) -> _Token:
        tok = self.tokens[self.pos]
        self.pos += 1
        return tok

    def error(self, message: str) -> _YAMLError:
        tok = self.peek()
        return _YAMLError(f"{message}, found {tok.kind}", tok.line)

    def single_document(self) -> Optional[_Node]:
        self.take()  # stream-start
        root = None
        documents = 0
        if not self.at("directive", "document-start", "stream-end"):
            root = self.node(block=True)
            documents = 1
            if self.at("document-end"):
                self.take()
        while True:
            while self.at("document-end"):
                self.take()
            if self.at("stream-end"):
                return root
            self.directives()
            if not self.at("document-start"):
                raise self.error("expected '<document start>'")
            line = self.take().line
            if documents:
                raise _YAMLError("expected a single document in the stream, but found another document", line)
            documents = 1
            if self.at("directive", "document-start", "document-end", "stream-end"):
                root = self.empty(line)
            else:
                root = self.node(block=True)
            if self.at("document-end"):
                self.take()

    def directives(self) -> None:
        version = None
        handles: Dict[str, str] = {}
        while self.at("directive"):
            tok = self.take()
            name, value = tok.value
            if name == "YAML":
                if version is not None:
                    raise _YAMLError("found a duplicate %YAML directive", tok.line)
                if value[0] != 1:
                    raise _YAMLError("found an incompatible YAML document (version 1.* is required)", tok.line)
                version = value
            elif name == "TAG":
                if value[0] in handles:
                    raise _YAMLError(f"duplicate tag handle {value[0]!r}", tok.line)
                handles[value[0]] = value[1]
        self.handles = {**_DEFAULT_HANDLES, **handles}

    def empty(self, line: int) -> _Node:
        return _Node("scalar", _resolve(""), "", line)

    def node(self, block: bool = False, indentless: bool = False) -> _Node:
        tok = self.peek()
        if tok.kind == "alias":
            self.take()
            if tok.value not in self.anchors:
                raise _YAMLError(f"found undefined alias {tok.value!r}", tok.line)
            return self.anchors[tok.value]
        anchor = tag = None
        for _ in range(2):
            if self.at("anchor") and anchor is None:
                anchor = self.take().value
            elif self.at("tag") and tag is None:
                t = self.take()
                handle, suffix = t.value
                if handle is not None:
                    if handle not in self.handles:
                        raise _YAMLError(f"found undefined tag handle {handle!r}", t.line)
                    tag = self.handles[handle] + suffix
                else:
                    tag = suffix
        if anchor is not None and anchor in self.anchors:
            raise _YAMLError(f"found duplicate anchor {anchor!r}", tok.line)
        nonspecific = tag is None or tag == "!"
        cur = self.peek()
        if indentless and cur.kind == "block-entry":
            node = self.register(anchor, _Node("seq", _TAG + "seq" if nonspecific else tag, [], cur.line))
            self.indentless_sequence(node)
        elif cur.kind == "scalar":
            self.take()
            if (cur.plain and tag is None) or tag == "!":
                tag = _resolve(cur.value)
            elif tag is None:
                tag = _TAG + "str"
            node = self.register(anchor, _Node("scalar", tag, cur.value, cur.line))
        elif cur.kind in ("flow-sequence-start", "flow-mapping-start") or (
                block and cur.kind in ("block-sequence-start", "block-mapping-start")):
            kind = "seq" if "sequence" in cur.kind else "map"
            node = self.register(anchor, _Node(kind, _TAG + kind if nonspecific else tag, [], cur.line))
            getattr(self, cur.kind.replace("-start", "").replace("-", "_"))(node)
        elif anchor is not None or tag is not None:
            node = self.register(anchor, _Node("scalar", _resolve("") if nonspecific else tag, "", tok.line))
        else:
            raise self.error(f"expected the content of a {'block' if block else 'flow'} node")
        return node

    def register(self, anchor: Optional[str], node: _Node) -> _Node:
        if anchor is not None:
            self.anchors[anchor] = node
        return node

    def value_or_empty(self, line: int, *ends: str, block: bool = False, indentless: bool = False) -> _Node:
        if self.at(*ends):
            return self.empty(line)
        return self.node(block=block, indentless=indentless)

    def block_sequence(self, node: _Node) -> None:
        start = self.take()
        while self.at("block-entry"):
            line = self.take().line
            node.value.append(self.value_or_empty(line, "block-entry", "block-end", block=True))
        if not self.at("block-end"):
            raise _YAMLError(f"expected <block end> of the block collection from line {start.line + 1}, found "
                            f"{self.peek().kind}", self.peek().line)
        self.take()

    def indentless_sequence(self, node: _Node) -> None:
        while self.at("block-entry"):
            line = self.take().line
            node.value.append(self.value_or_empty(line, "block-entry", "key", "value", "block-end", block=True))

    def block_mapping(self, node: _Node) -> None:
        start = self.take()
        while True:
            if self.at("key"):
                line = self.take().line
                key = self.value_or_empty(line, "key", "value", "block-end", block=True, indentless=True)
            elif self.at("block-end"):
                self.take()
                return
            else:
                raise _YAMLError(f"expected <block end> of the block mapping from line {start.line + 1}, found "
                                f"{self.peek().kind}", self.peek().line)
            if self.at("value"):
                line = self.take().line
                value = self.value_or_empty(line, "key", "value", "block-end", block=True, indentless=True)
            else:
                value = self.empty(self.peek().line)
            node.value.append((key, value))

    def flow_sequence(self, node: _Node) -> None:
        self.take()
        first = True
        while not self.at("flow-sequence-end"):
            if not first:
                if not self.at("flow-entry"):
                    raise self.error("expected ',' or ']' in a flow sequence")
                self.take()
            first = False
            if self.at("key"):  # a single-pair mapping
                line = self.take().line
                pair = _Node("map", _TAG + "map", [], line)
                key = self.value_or_empty(line, "value", "flow-entry", "flow-sequence-end")
                pair.value.append((key, self.flow_value("flow-sequence-end")))
                node.value.append(pair)
            elif not self.at("flow-sequence-end"):
                node.value.append(self.node())
        self.take()

    def flow_mapping(self, node: _Node) -> None:
        self.take()
        first = True
        while not self.at("flow-mapping-end"):
            if not first:
                if not self.at("flow-entry"):
                    raise self.error("expected ',' or '}' in a flow mapping")
                self.take()
            first = False
            if self.at("key"):
                line = self.take().line
                key = self.value_or_empty(line, "value", "flow-entry", "flow-mapping-end")
                node.value.append((key, self.flow_value("flow-mapping-end")))
            elif not self.at("flow-mapping-end"):
                node.value.append((self.node(), self.empty(self.peek().line)))
        self.take()

    def flow_value(self, end: str) -> _Node:
        if self.at("value"):
            line = self.take().line
            return self.value_or_empty(line, "flow-entry", end)
        return self.empty(self.peek().line)


# --------------------------------------------------- resolver and constructor

# SafeLoader's implicit resolvers for plain scalars, tried in this order for
# the scalar's first character (YAML 1.1 types, yaml.org/type/)
_RESOLVERS = [
    ("bool", re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$"),
     "yYnNtTfFoO"),
    ("float", re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                              |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                              |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                              |[-+]?\.(?:inf|Inf|INF)
                              |\.(?:nan|NaN|NAN))$""", re.X), "-+0123456789."),
    ("int", re.compile(r"""^(?:[-+]?0b[0-1_]+
                            |[-+]?0[0-7_]+
                            |[-+]?(?:0|[1-9][0-9_]*)
                            |[-+]?0x[0-9a-fA-F_]+
                            |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X), "-+0123456789"),
    ("merge", re.compile(r"^(?:<<)$"), "<"),
    ("null", re.compile(r"^(?:~|null|Null|NULL|)$"), "~nN"),
    ("timestamp", re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                                  |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                                   (?:[Tt]|[ \t]+)[0-9][0-9]?
                                   :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
                                   (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X), "0123456789"),
    ("value", re.compile(r"^(?:=)$"), "="),
    ("yaml", re.compile(r"^(?:!|&|\*)$"), "!&*"),
]
_TIMESTAMP = re.compile(r"""^(?P<year>[0-9][0-9][0-9][0-9])-(?P<month>[0-9][0-9]?)-(?P<day>[0-9][0-9]?)
                            (?:(?:[Tt]|[ \t]+)(?P<hour>[0-9][0-9]?):(?P<minute>[0-9][0-9]):(?P<second>[0-9][0-9])
                            (?:\.(?P<fraction>[0-9]*))?
                            (?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)
                                           (?::(?P<tz_minute>[0-9][0-9]))?))?
                            )?$""", re.X)
_BOOLS = {"yes": True, "no": False, "true": True, "false": False, "on": True, "off": False}


def _resolve(value: str) -> str:
    """The tag of a plain scalar (or of one tagged ``!``)."""
    for name, pattern, first in _RESOLVERS:
        if (value[:1] in first if value else name == "null") and pattern.match(value):
            return _TAG + name
    return _TAG + "str"


def _sexagesimal(digits: List[Any]) -> Any:
    return sum(digit * 60**k for k, digit in enumerate(reversed(digits)))


def _signed(text: str) -> Tuple[int, str]:
    return (-1 if text[0] == "-" else 1), (text[1:] if text[0] in "+-" else text)


def _int(text: str) -> int:
    sign, text = _signed(text.replace("_", ""))
    if text == "0":
        return 0
    if text.startswith("0b"):
        return sign * int(text[2:], 2)
    if text.startswith("0x"):
        return sign * int(text[2:], 16)
    if text[0] == "0":
        return sign * int(text, 8)
    if ":" in text:
        return sign * _sexagesimal([int(part) for part in text.split(":")])
    return sign * int(text)


def _float(text: str) -> float:
    sign, text = _signed(text.replace("_", "").lower())
    if text == ".inf":
        return sign * float("inf")
    if text == ".nan":
        return float("nan")
    if ":" in text:
        return sign * _sexagesimal([float(part) for part in text.split(":")])
    return sign * float(text)


def _timestamp(text: str) -> Any:
    v = _TIMESTAMP.match(text).groupdict()
    year, month, day = int(v["year"]), int(v["month"]), int(v["day"])
    if not v["hour"]:
        return datetime.date(year, month, day)
    fraction = int(v["fraction"][:6].ljust(6, "0")) if v["fraction"] else 0
    tzinfo = None
    if v["tz_sign"]:
        delta = datetime.timedelta(hours=int(v["tz_hour"]), minutes=int(v["tz_minute"] or 0))
        tzinfo = datetime.timezone(-delta if v["tz_sign"] == "-" else delta)
    elif v["tz"]:
        tzinfo = datetime.timezone.utc
    return datetime.datetime(year, month, day, int(v["hour"]), int(v["minute"]), int(v["second"]), fraction,
                             tzinfo=tzinfo)


def _binary(text: str) -> bytes:
    try:
        return base64.decodebytes(text.encode("ascii"))
    except (UnicodeEncodeError, binascii.Error) as e:
        raise ValueError(f"bad !!binary data: {e}") from None


_SCALARS = {"null": lambda s: None, "bool": lambda s: _BOOLS[s.lower()], "int": _int, "float": _float,
            "binary": _binary, "timestamp": _timestamp, "str": lambda s: s}


class _Constructor:
    """Nodes → Python objects, as ``SafeConstructor`` builds them."""

    def __init__(self):
        self.built: Dict[int, Any] = {}

    def build(self, node: _Node) -> Any:
        if id(node) in self.built:
            return self.built[id(node)]
        kind = node.tag[len(_TAG):] if node.tag.startswith(_TAG) else None
        if kind in _SCALARS:
            text = self.scalar(node)
            try:
                data = _SCALARS[kind](text)
            except (ValueError, KeyError, AttributeError, IndexError) as e:  # what safe_load's constructors raise
                raise _YAMLError(f"cannot construct {node.tag!r} from {text!r}: {e}", node.line) from None
        elif kind == "seq" and node.kind == "seq":
            data = self.built[id(node)] = []  # registered first: an alias inside may refer to it
            data.extend(self.build(item) for item in node.value)
        elif kind == "map" and node.kind == "map":
            data = self.built[id(node)] = {}
            data.update(self.mapping(node))
        elif kind == "set" and node.kind == "map":
            data = self.built[id(node)] = set()
            data.update(self.mapping(node))
        elif kind in ("omap", "pairs") and node.kind == "seq":
            data = self.built[id(node)] = []
            for item in node.value:
                if item.kind != "map" or len(item.value) != 1:
                    raise _YAMLError(f"!!{kind} takes mappings of one item", item.line)
                data.append(tuple(self.build(n) for n in item.value[0]))
        else:
            raise _YAMLError(f"no constructor for the tag {node.tag!r} on a {node.kind}", node.line)
        self.built[id(node)] = data
        return data

    def scalar(self, node: _Node) -> str:
        if node.kind == "map":  # a mapping with a "=" key stands for that key's value
            for key, value in node.value:
                if key.tag == _TAG + "value":
                    return self.scalar(value)
        if node.kind != "scalar":
            raise _YAMLError(f"expected a scalar node, found a {node.kind}", node.line)
        return node.value

    def flatten(self, node: _Node) -> None:
        """Resolve ``<<`` keys in place: the merged pairs come first, so
        the mapping's own keys win and the first merged mapping wins."""
        merged = []
        own = []
        for key, value in node.value:
            if key.tag == _TAG + "merge":
                if value.kind == "map":
                    self.flatten(value)
                    merged.extend(value.value)
                elif value.kind == "seq":
                    for sub in value.value:
                        if sub.kind != "map":
                            raise _YAMLError(f"expected a mapping to merge, found a {sub.kind}", sub.line)
                        self.flatten(sub)
                    for sub in reversed(value.value):
                        merged.extend(sub.value)
                else:
                    raise _YAMLError("expected a mapping or a list of mappings to merge", value.line)
            else:
                if key.tag == _TAG + "value":
                    key.tag = _TAG + "str"
                own.append((key, value))
        node.value = merged + own

    def mapping(self, node: _Node) -> Dict[Any, Any]:
        self.flatten(node)
        out = {}
        for key_node, value_node in node.value:
            key = self.build(key_node)
            try:
                hash(key)
            except TypeError:
                raise _YAMLError("found an unhashable key", key_node.line) from None
            out[key] = self.build(value_node)
        return out


def _load(text: str) -> Any:
    """The object ``yaml.safe_load(text)`` returns; :class:`_YAMLError`
    where it raises."""
    try:
        root = _Parser(_Scanner(text).tokens).single_document()
        return None if root is None else _Constructor().build(root)
    except RecursionError:
        raise _YAMLError("the document nests or merges into itself without end", 0) from None


def read_yaml(path: str) -> Any:
    """The object ``yaml.safe_load`` returns for the file at ``path``
    (``None`` for an empty document); ``ValueError`` naming the file and
    line where it raises."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    try:
        return _load(text)
    except _YAMLError as e:
        raise ValueError(f"{path}, line {e.line + 1}: {e}") from None
