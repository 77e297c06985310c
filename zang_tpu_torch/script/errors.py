"""Compiler diagnostics: source-ranged errors with caret underlines.

Mirrors the reference's polished `fail` output (src/zangscript/fail.zig):
file:line:col, the message, the offending source line, and a ^^^ underline,
with optional ANSI color.
"""

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class SourceLocation:
    line: int  # 0-based
    index: int  # absolute byte offset


@dataclass(frozen=True)
class SourceRange:
    loc0: SourceLocation
    loc1: SourceLocation


class ScriptError(Exception):
    def __init__(self, source: "Source", sr: Optional[SourceRange], message: str,
                 color: bool = False):
        self.source = source
        self.source_range = sr
        self.message = message
        super().__init__(self.render(color))

    def render(self, color: bool = False) -> str:
        RED = "\x1b[31m" if color else ""
        BOLD = "\x1b[1m" if color else ""
        RESET = "\x1b[0m" if color else ""
        if self.source_range is None:
            return f"{BOLD}{self.source.filename}{RESET}: {RED}error:{RESET} {self.message}"
        sr = self.source_range
        contents = self.source.contents
        # find the line containing loc0
        line_start = contents.rfind("\n", 0, sr.loc0.index) + 1
        line_end = contents.find("\n", sr.loc0.index)
        if line_end < 0:
            line_end = len(contents)
        line = contents[line_start:line_end]
        col = sr.loc0.index - line_start
        width = max(1, min(sr.loc1.index, line_end) - sr.loc0.index)
        caret = " " * col + RED + "^" * width + RESET
        return (
            f"{BOLD}{self.source.filename}:{sr.loc0.line + 1}:{col + 1}:{RESET} "
            f"{RED}error:{RESET} {self.message}\n{line}\n{caret}"
        )


@dataclass
class Source:
    filename: str
    contents: str

    def get_string(self, sr: SourceRange) -> str:
        return self.contents[sr.loc0.index : sr.loc1.index]
