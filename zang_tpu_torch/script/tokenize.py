"""zangscript tokenizer (src/zangscript/tokenize.zig).

Tokens: names, f32 numbers, `.enum_value`s, symbols ``* : , = ( ) - + /``,
keywords ``begin defcurve defmodule deftrack delay end false feedback from
out true``; ``//`` line comments. Names start with a letter (no leading
underscore); numbers are digits/dots parsed as f32.
"""

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np

from .errors import ScriptError, Source, SourceLocation, SourceRange

SYMBOLS = [
    ("*", "sym_asterisk"),
    (":", "sym_colon"),
    (",", "sym_comma"),
    ("=", "sym_equals"),
    ("(", "sym_left_paren"),
    ("-", "sym_minus"),
    ("+", "sym_plus"),
    (")", "sym_right_paren"),
    ("/", "sym_slash"),
]
SYMBOL_STRINGS = {tt: s for s, tt in SYMBOLS}

KEYWORDS = [
    "begin", "defcurve", "defmodule", "deftrack", "delay",
    "end", "false", "feedback", "from", "out", "true",
]


@dataclass(frozen=True)
class Token:
    tt: str  # "name" | "number" | "enum_value" | "sym_*" | "kw_*" | "end_of_file" | "illegal"
    source_range: SourceRange
    number: float = 0.0  # for tt == "number"


def _is_name_head(ch: str) -> bool:
    return ch.isascii() and ch.isalpha()


def _is_name_tail(ch: str) -> bool:
    return (ch.isascii() and (ch.isalpha() or ch.isdigit())) or ch == "_"


class Tokenizer:
    def __init__(self, source: Source, color: bool = False):
        self.source = source
        self.line = 0
        self.index = 0
        self.color = color

    def _fail(self, sr: SourceRange, msg: str):
        raise ScriptError(self.source, sr, msg, self.color)

    def next(self) -> Token:
        src = self.source.contents
        while True:
            while self.index < len(src) and src[self.index] in " \t\r\n":
                if src[self.index] == "\n":
                    self.line += 1
                self.index += 1
            if src.startswith("//", self.index):
                while self.index < len(src) and src[self.index] not in "\r\n":
                    self.index += 1
                continue
            break

        start = SourceLocation(self.line, self.index)
        if self.index >= len(src):
            return Token("end_of_file", SourceRange(start, start))

        for sym, tt in SYMBOLS:
            if src.startswith(sym, self.index):
                self.index += len(sym)
                return Token(tt, SourceRange(start, SourceLocation(self.line, self.index)))

        ch = src[self.index]
        if ch == ".":
            self.index += 1
            start2 = SourceLocation(self.line, self.index)
            if self.index >= len(src) or not _is_name_head(src[self.index]):
                self._fail(SourceRange(start, start2), "dot must be followed by an identifier")
            self.index += 1
            while self.index < len(src) and _is_name_tail(src[self.index]):
                self.index += 1
            return Token("enum_value", SourceRange(start2, SourceLocation(self.line, self.index)))

        if ch.isdigit():
            self.index += 1
            while self.index < len(src) and (src[self.index].isdigit() or src[self.index] == "."):
                self.index += 1
            end = SourceLocation(self.line, self.index)
            text = src[start.index : self.index]
            try:
                value = float(np.float32(text))
            except ValueError:
                self._fail(SourceRange(start, end), "malformatted number")
            return Token("number", SourceRange(start, end), number=value)

        if _is_name_head(ch):
            self.index += 1
            while self.index < len(src) and _is_name_tail(src[self.index]):
                self.index += 1
            end = SourceLocation(self.line, self.index)
            text = src[start.index : self.index]
            if text in KEYWORDS:
                return Token("kw_" + text, SourceRange(start, end))
            return Token("name", SourceRange(start, end))

        self.index += 1
        return Token("illegal", SourceRange(start, SourceLocation(self.line, self.index)))

    def peek(self) -> Token:
        line, index = self.line, self.index
        tok = self.next()
        self.line, self.index = line, index
        return tok

    def fail_expected(self, desc: str, found: Token):
        if found.tt == "end_of_file":
            self._fail(found.source_range, f"expected {desc}, found end of file")
        found_str = self.source.get_string(found.source_range)
        self._fail(found.source_range, f"expected {desc}, found `{found_str}`")

    def expect_next(self, tt: str) -> Token:
        token = self.next()
        if token.tt == tt:
            return token
        if tt.startswith("sym_"):
            desc = f"`{SYMBOL_STRINGS[tt]}`"
        elif tt.startswith("kw_"):
            desc = f"`{tt[3:]}`"
        else:
            desc = tt
        self.fail_expected(desc, token)
