"""zangscript parser: tokens -> AST (src/zangscript/parse.zig).

Grammar summary:
  file        := (Name `=` expr)*                       top-level globals only
  expr        := [`-`] term [callargs] (binop expr)*    priorities: +,- (1) *,/ (2)
  term        := `(` expr `)` | defmodule | defcurve | deftrack
               | `from` trackcall | name | builtin-fn | `pi`
               | true | false | number | .enum[(payload)] | delay | feedback
  defmodule   := `defmodule` (name `:` type `,`)* `begin` stmts `end`
  defcurve    := `defcurve` (number number)* `end`      strictly increasing t
  deftrack    := `deftrack` params `begin` (number callargs)* `end`
  delay       := `delay` int `begin` stmts `end`
  stmts       := (name `=` expr | `out` expr | `feedback` expr)* `end`

Types: boolean constant waveform cob curve + registered enum names. Every
module gets an implicit `sample_rate: constant` param (parse.zig:330-331).
Locals shadow (resolved innermost-scope, latest declaration first); call
args support the `val` shorthand for `val=val` (parse.zig:388-401).
"""

from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union

import numpy as np

from .builtins import (
    BOOLEAN, BUFFER, COB, CONSTANT, CURVE, BuiltinEnum, ModuleParam, ParamType,
    one_of,
)
from .errors import ScriptError, Source, SourceRange
from .tokenize import Token, Tokenizer

RESERVED_NAMES = ["abs", "cos", "max", "min", "pi", "pow", "sample_rate", "sin", "sqrt"]

UNARY_FNS = {"abs": "abs", "cos": "cos", "sin": "sin", "sqrt": "sqrt"}
BINARY_FNS = {"max": "max", "min": "min", "pow": "pow"}

BINARY_OPERATORS = [
    ("sym_plus", 1, "add"),
    ("sym_minus", 1, "sub"),
    ("sym_asterisk", 2, "mul"),
    ("sym_slash", 2, "div"),
]


# ---------------------------------------------------------------------------
# AST dataclasses


@dataclass
class NumberLiteral:
    value: float
    verbatim: str  # keep the source text so dumps don't mangle 0.7


@dataclass
class CurvePoint:
    t: NumberLiteral
    value: NumberLiteral


@dataclass
class CurveDef:
    points: List[CurvePoint]


@dataclass
class CallArg:
    param_name: str
    param_name_token: Token
    value: "Expression"


@dataclass
class TrackNote:
    t: NumberLiteral
    args_source_range: SourceRange
    args: List[CallArg]


@dataclass
class TrackDef:
    params: List[ModuleParam]
    notes: List[TrackNote]


@dataclass
class Scope:
    parent: Optional["Scope"]
    statements: List["Statement"] = field(default_factory=list)


@dataclass
class Local:
    name: str


@dataclass
class ParsedModuleInfo:
    scope: Scope
    locals: List[Local]


@dataclass
class Module:
    params: List[ModuleParam]
    builtin_name: Optional[str] = None
    info: Optional[ParsedModuleInfo] = None  # None for builtins
    builtin: Optional[object] = None  # the BuiltinModule record (builtins only)


@dataclass
class Call:
    field_expr: "Expression"
    args: List[CallArg]


@dataclass
class TrackCall:
    track_expr: "Expression"
    speed: "Expression"
    scope: Scope


@dataclass
class DelayExpr:
    num_samples: int
    scope: Scope


@dataclass
class UnArith:
    op: str  # abs cos neg sin sqrt
    a: "Expression"


@dataclass
class BinArith:
    op: str  # add div max min mul pow sub
    a: "Expression"
    b: "Expression"


@dataclass
class EnumLiteral:
    label: str
    payload: Optional["Expression"]


@dataclass
class Expression:
    source_range: SourceRange
    kind: str
    # payload fields by kind:
    call: Optional[Call] = None
    track_call: Optional[TrackCall] = None
    delay: Optional[DelayExpr] = None
    literal_boolean: Optional[bool] = None
    literal_number: Optional[NumberLiteral] = None
    literal_enum_value: Optional[EnumLiteral] = None
    literal_index: Optional[int] = None  # curve/track/module index
    un_arith: Optional[UnArith] = None
    bin_arith: Optional[BinArith] = None
    local_index: Optional[int] = None
    name_token: Optional[Token] = None


@dataclass
class Statement:
    kind: str  # "let_assignment" | "output" | "feedback"
    local_index: Optional[int] = None
    expression: Optional[Expression] = None


@dataclass
class Global:
    name: str
    value: Expression


@dataclass
class ParseResult:
    globals: List[Global]
    curves: List[CurveDef]
    tracks: List[TrackDef]
    modules: List[Module]


# ---------------------------------------------------------------------------


class _ModuleState:
    def __init__(self, params: List[ModuleParam]):
        self.params = params
        self.locals: List[Local] = []


class Parser:
    def __init__(self, source: Source, builtin_packages, color: bool = False):
        self.source = source
        self.tok = Tokenizer(source, color)
        self.color = color
        self.globals: List[Global] = []
        self.enums: List[BuiltinEnum] = []
        self.curves: List[CurveDef] = []
        self.tracks: List[TrackDef] = []
        self.modules: List[Module] = []
        for pkg in builtin_packages:
            self.enums.extend(pkg["enums"])
            for b in pkg["builtins"]:
                module_index = len(self.modules)
                self.modules.append(
                    Module(params=list(b.params), builtin_name=b.name,
                           info=None, builtin=b)
                )
                sr = SourceRange(_zero_loc(), _zero_loc())
                self.globals.append(
                    Global(b.name, Expression(sr, "literal_module", literal_index=module_index))
                )

    def _fail(self, sr: SourceRange, msg: str):
        raise ScriptError(self.source, sr, msg, self.color)

    # -- declarations ------------------------------------------------------

    def parse(self) -> ParseResult:
        while True:
            token = self.tok.next()
            if token.tt == "end_of_file":
                break
            if token.tt == "name":
                self._parse_global_decl(token)
            else:
                self.tok.fail_expected("declaration or end of file", token)
        return ParseResult(self.globals, self.curves, self.tracks, self.modules)

    def _parse_global_decl(self, name_token: Token):
        name = self.source.get_string(name_token.source_range)
        self.tok.expect_next("sym_equals")
        if name in RESERVED_NAMES:
            self._fail(name_token.source_range, f"`{name}` is a reserved name")
        for g in self.globals:
            if g.name == name:
                self._fail(name_token.source_range, f"redeclaration of global `{name}`")
        expr = self._expect_expression(None)
        self.globals.append(Global(name, expr))

    def _define_curve(self) -> int:
        points: List[CurvePoint] = []
        last_t = None
        while True:
            token = self.tok.next()
            if token.tt == "kw_end":
                break
            if token.tt == "number":
                t = token.number
                if last_t is not None and t <= last_t:
                    self._fail(token.source_range,
                               "time value must be greater than the previous time value")
                last_t = t
                value_token = self.tok.next()
                if value_token.tt != "number":
                    self.tok.fail_expected("number", value_token)
                points.append(CurvePoint(
                    NumberLiteral(t, self.source.get_string(token.source_range)),
                    NumberLiteral(value_token.number,
                                  self.source.get_string(value_token.source_range)),
                ))
            else:
                self.tok.fail_expected("number or `end`", token)
        self.curves.append(CurveDef(points))
        return len(self.curves) - 1

    def _expect_param_type(self, for_track: bool) -> ParamType:
        type_token = self.tok.next()
        if type_token.tt != "name":
            self.tok.fail_expected("param type", type_token)
        type_name = self.source.get_string(type_token.source_range)
        pt = {
            "boolean": BOOLEAN, "constant": CONSTANT, "waveform": BUFFER,
            "cob": COB, "curve": CURVE,
        }.get(type_name)
        if pt is None:
            for e in self.enums:
                if e.name == type_name:
                    pt = one_of(e)
                    break
        if pt is None:
            self.tok.fail_expected("param type", type_token)
        if for_track and pt.kind in ("buffer", "constant_or_buffer"):
            self._fail(type_token.source_range, "track param cannot be cob or waveform")
        return pt

    def _parse_param_declarations(self, params: List[ModuleParam], for_track: bool):
        while True:
            token = self.tok.next()
            if token.tt == "kw_begin":
                break
            if token.tt == "name":
                param_name = self.source.get_string(token.source_range)
                if param_name in RESERVED_NAMES:
                    self._fail(token.source_range, f"`{param_name}` is a reserved name")
                if any(p.name == param_name for p in params):
                    self._fail(token.source_range, f"redeclaration of param `{param_name}`")
                self.tok.expect_next("sym_colon")
                pt = self._expect_param_type(for_track)
                self.tok.expect_next("sym_comma")
                params.append(ModuleParam(param_name, pt))
            else:
                self.tok.fail_expected("param declaration or `begin`", token)

    def _define_track(self) -> int:
        params: List[ModuleParam] = []
        self._parse_param_declarations(params, for_track=True)
        notes: List[TrackNote] = []
        last_t = None
        while True:
            token = self.tok.next()
            if token.tt == "kw_end":
                break
            if token.tt == "number":
                t = token.number
                if last_t is not None and t <= last_t:
                    self._fail(token.source_range,
                               "time value must be greater than the previous time value")
                last_t = t
                loc0 = token.source_range.loc1
                args = self._parse_call_args(None)
                sr = SourceRange(loc0, _loc(self.tok))
                notes.append(TrackNote(
                    NumberLiteral(t, self.source.get_string(token.source_range)),
                    sr, args,
                ))
            else:
                self.tok.fail_expected("number or `end`", token)
        self.tracks.append(TrackDef(params, notes))
        return len(self.tracks) - 1

    def _define_module(self) -> int:
        # all modules have an implicit sample_rate param
        params: List[ModuleParam] = [ModuleParam("sample_rate", CONSTANT)]
        self._parse_param_declarations(params, for_track=False)
        ps_mod = _ModuleState(params)
        top_scope = self._parse_statements(ps_mod, None)
        self.modules.append(Module(
            params=params, builtin_name=None,
            info=ParsedModuleInfo(scope=top_scope, locals=ps_mod.locals),
        ))
        return len(self.modules) - 1

    # -- expressions -------------------------------------------------------

    def _parse_call_args(self, pc) -> List[CallArg]:
        """pc is (_ModuleState, Scope) inside a module, or None at global level."""
        self.tok.expect_next("sym_left_paren")
        args: List[CallArg] = []
        token = self.tok.next()
        while token.tt != "sym_right_paren":
            if args:
                if token.tt != "sym_comma":
                    self.tok.fail_expected("`,` or `)`", token)
                token = self.tok.next()
            if token.tt != "name":
                self.tok.fail_expected("callee param name", token)
            param_name = self.source.get_string(token.source_range)
            equals_token = self.tok.next()
            if equals_token.tt == "sym_equals":
                args.append(CallArg(param_name, token, self._expect_expression(pc)))
                token = self.tok.next()
            else:
                if pc is not None:
                    # shorthand: `val` expands to `val=val`
                    subexpr = Expression(
                        token.source_range, **self._resolve_name(pc, token)
                    )
                    args.append(CallArg(param_name, token, subexpr))
                    token = equals_token
                # at global level the reference silently continues (the next
                # loop iteration will fail on an unexpected token)
        return args

    def _resolve_name(self, pc, token: Token) -> dict:
        """-> Expression kwargs: local reference or unresolved name."""
        if pc is not None:
            ps_mod, scope = pc
            name = self.source.get_string(token.source_range)
            s = scope
            while s is not None:
                for stmt in reversed(s.statements):
                    if stmt.kind == "let_assignment":
                        if ps_mod.locals[stmt.local_index].name == name:
                            return {"kind": "local", "local_index": stmt.local_index}
                s = s.parent
        return {"kind": "name", "name_token": token}

    def _expect_expression(self, pc, priority: int = 0) -> Expression:
        negate = False
        if self.tok.peek().tt == "sym_minus":
            self.tok.next()
            negate = True

        a = self._expect_term(pc)
        loc0 = a.source_range.loc0

        if self.tok.peek().tt == "sym_left_paren":
            if pc is None:
                self._fail(a.source_range, "not a function")
            args = self._parse_call_args(pc)
            a = Expression(SourceRange(loc0, _loc(self.tok)), "call",
                           call=Call(a, args))

        if negate:
            a = Expression(SourceRange(loc0, _loc(self.tok)), "un_arith",
                           un_arith=UnArith("neg", a))

        while True:
            token = self.tok.peek()
            matched = False
            for symbol, prio, op in BINARY_OPERATORS:
                if token.tt == symbol and priority < prio:
                    self.tok.next()
                    b = self._expect_expression(pc, prio)
                    a = Expression(SourceRange(loc0, _loc(self.tok)), "bin_arith",
                                   bin_arith=BinArith(op, a, b))
                    matched = True
                    break
            if not matched:
                break
        return a

    def _parse_unary_fn(self, pc, loc0, op) -> Expression:
        self.tok.expect_next("sym_left_paren")
        a = self._expect_expression(pc)
        self.tok.expect_next("sym_right_paren")
        return Expression(SourceRange(loc0, _loc(self.tok)), "un_arith",
                          un_arith=UnArith(op, a))

    def _parse_binary_fn(self, pc, loc0, op) -> Expression:
        self.tok.expect_next("sym_left_paren")
        a = self._expect_expression(pc)
        self.tok.expect_next("sym_comma")
        b = self._expect_expression(pc)
        self.tok.expect_next("sym_right_paren")
        return Expression(SourceRange(loc0, _loc(self.tok)), "bin_arith",
                          bin_arith=BinArith(op, a, b))

    def _expect_term(self, pc) -> Expression:
        token = self.tok.next()
        loc0 = token.source_range.loc0

        if token.tt == "sym_left_paren":
            a = self._expect_expression(pc)
            self.tok.expect_next("sym_right_paren")
            return a
        if token.tt == "kw_defmodule":
            idx = self._define_module()
            return Expression(SourceRange(loc0, _loc(self.tok)), "literal_module",
                              literal_index=idx)
        if token.tt == "kw_defcurve":
            idx = self._define_curve()
            return Expression(SourceRange(loc0, _loc(self.tok)), "literal_curve",
                              literal_index=idx)
        if token.tt == "kw_deftrack":
            idx = self._define_track()
            return Expression(SourceRange(loc0, _loc(self.tok)), "literal_track",
                              literal_index=idx)
        if token.tt == "kw_from":
            if pc is None:
                self._fail(token.source_range, "cannot call track outside of module context")
            track_expr = self._expect_expression(pc)
            self.tok.expect_next("sym_comma")
            speed_expr = self._expect_expression(pc)
            self.tok.expect_next("kw_begin")
            ps_mod, scope = pc
            inner_scope = self._parse_statements(ps_mod, scope)
            return Expression(SourceRange(loc0, _loc(self.tok)), "track_call",
                              track_call=TrackCall(track_expr, speed_expr, inner_scope))
        if token.tt == "name":
            s = self.source.get_string(token.source_range)
            if s in UNARY_FNS:
                return self._parse_unary_fn(pc, loc0, UNARY_FNS[s])
            if s in BINARY_FNS:
                return self._parse_binary_fn(pc, loc0, BINARY_FNS[s])
            if s == "pi":
                return Expression(token.source_range, "literal_number",
                                  literal_number=NumberLiteral(float(np.float32(np.pi)), "pi"))
            return Expression(token.source_range, **self._resolve_name(pc, token))
        if token.tt == "kw_false":
            return Expression(token.source_range, "literal_boolean", literal_boolean=False)
        if token.tt == "kw_true":
            return Expression(token.source_range, "literal_boolean", literal_boolean=True)
        if token.tt == "number":
            return Expression(token.source_range, "literal_number",
                              literal_number=NumberLiteral(
                                  token.number, self.source.get_string(token.source_range)))
        if token.tt == "enum_value":
            s = self.source.get_string(token.source_range)
            if self.tok.peek().tt == "sym_left_paren":
                self.tok.next()
                payload = self._expect_expression(pc)
                self.tok.expect_next("sym_right_paren")
                return Expression(SourceRange(loc0, _loc(self.tok)), "literal_enum_value",
                                  literal_enum_value=EnumLiteral(s, payload))
            return Expression(token.source_range, "literal_enum_value",
                              literal_enum_value=EnumLiteral(s, None))
        if token.tt == "kw_delay":
            if pc is None:
                self._fail(token.source_range, "cannot use delay outside of module context")
            num_token = self.tok.next()
            if num_token.tt != "number":
                self.tok.fail_expected("number", num_token)
            text = self.source.get_string(num_token.source_range)
            try:
                num_samples = int(text)
            except ValueError:
                self._fail(num_token.source_range, "malformatted integer")
            self.tok.expect_next("kw_begin")
            ps_mod, scope = pc
            inner_scope = self._parse_statements(ps_mod, scope)
            return Expression(SourceRange(loc0, _loc(self.tok)), "delay",
                              delay=DelayExpr(num_samples, inner_scope))
        if token.tt == "kw_feedback":
            if pc is None:
                self._fail(token.source_range, "cannot use feedback outside of module context")
            return Expression(token.source_range, "feedback")
        self.tok.fail_expected("expression", token)

    # -- statements --------------------------------------------------------

    def _parse_statements(self, ps_mod: _ModuleState, parent_scope) -> Scope:
        scope = Scope(parent=parent_scope)
        pc = (ps_mod, scope)
        while True:
            token = self.tok.next()
            if token.tt == "kw_end":
                break
            if token.tt == "name":
                name = self.source.get_string(token.source_range)
                self.tok.expect_next("sym_equals")
                if name in RESERVED_NAMES:
                    self._fail(token.source_range, f"`{name}` is a reserved name")
                expr = self._expect_expression(pc)
                local_index = len(ps_mod.locals)
                ps_mod.locals.append(Local(name))
                scope.statements.append(Statement(
                    "let_assignment", local_index=local_index, expression=expr))
            elif token.tt == "kw_out":
                scope.statements.append(Statement(
                    "output", expression=self._expect_expression(pc)))
            elif token.tt == "kw_feedback":
                scope.statements.append(Statement(
                    "feedback", expression=self._expect_expression(pc)))
            else:
                self.tok.fail_expected(
                    "local declaration, `out`, `feedback` or `end`", token)
        return scope


def _zero_loc():
    from .errors import SourceLocation

    return SourceLocation(0, 0)


def _loc(tok: Tokenizer):
    from .errors import SourceLocation

    return SourceLocation(tok.line, tok.index)


def parse(source: Source, builtin_packages, color: bool = False) -> ParseResult:
    return Parser(source, builtin_packages, color).parse()
