"""compile(): parse + codegen -> CompiledScript (src/zangscript/compile.zig)."""

from dataclasses import dataclass
from typing import List, Optional

from .builtins import BUILTIN_ENUMS, BUILTIN_MODULES
from .codegen import CodeGenResult, codegen
from .errors import Source
from .parse import CurveDef, Module, ParseResult, TrackDef, parse


def builtin_packages():
    """The default registry: the reference's `zang` package (PaintCurve only)
    plus the `mod` package (12 modules + 4 enums) — builtins.zig:152-185."""
    from .builtins import (
        DISTORTION_TYPE, FILTER_TYPE, INTERPOLATION_FUNCTION, NOISE_COLOR,
        PAINT_CURVE,
    )

    return [
        {"name": "zang", "builtins": [], "enums": [PAINT_CURVE]},
        {
            "name": "mod",
            "builtins": BUILTIN_MODULES,
            "enums": [INTERPOLATION_FUNCTION, DISTORTION_TYPE, FILTER_TYPE, NOISE_COLOR],
        },
    ]


@dataclass
class CompiledScript:
    source: Source
    parse_result: ParseResult
    codegen_result: CodeGenResult

    @property
    def curves(self) -> List[CurveDef]:
        return self.parse_result.curves

    @property
    def tracks(self) -> List[TrackDef]:
        return self.parse_result.tracks

    @property
    def modules(self) -> List[Module]:
        return self.parse_result.modules

    @property
    def exported_modules(self):
        return self.codegen_result.exported_modules

    def find_module(self, name: str) -> int:
        for em in self.exported_modules:
            if em.name == name:
                return em.module_index
        raise KeyError(
            f"exported module {name!r} not found "
            f"(available: {[em.name for em in self.exported_modules]})"
        )


def compile_script(
    contents: str,
    filename: str = "<script>",
    packages=None,
    color: bool = False,
) -> CompiledScript:
    source = Source(filename=filename, contents=contents)
    packages = packages if packages is not None else builtin_packages()
    parse_result = parse(source, packages, color)
    codegen_result = codegen(source, parse_result, packages, color)
    return CompiledScript(source, parse_result, codegen_result)
