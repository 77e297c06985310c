"""zangscript codegen: AST -> bytecode (src/zangscript/codegen.zig).

Flattens module expressions into an instruction list operating on virtual
temp buffers (ref-counted, reused) and temp floats (not reused). The
instruction set is the reference's dataflow IR: copy_buffer,
float_to_buffer, cob_to_buffer, arith_* (float/buffer combinations), call,
track_call, delay. Calls allocate the callee's temps from the caller's pool
and record a Field (the static instance tree); delay claims feedback
in/out temps and nests its instructions; globals resolve lazily with cycle
detection.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

from .builtins import BuiltinEnum, ModuleParam, ParamType
from .errors import ScriptError, Source, SourceRange
from . import parse as P


# ---------------------------------------------------------------------------
# results and instructions


@dataclass
class TempRef:
    index: int
    is_weak: bool  # weak = someone else owns the temp (don't release)


@dataclass
class ExprResult:
    kind: str
    # kinds: nothing, temp_buffer, temp_float, literal_boolean,
    # literal_number, literal_enum_value, literal_curve, literal_track,
    # literal_module, self_param, track_param
    temp: Optional[TempRef] = None
    literal_boolean: Optional[bool] = None
    literal_number: Optional[P.NumberLiteral] = None
    enum_label: Optional[str] = None
    enum_payload: Optional["ExprResult"] = None
    index: Optional[int] = None  # curve/track/module index or self_param index
    track_index: Optional[int] = None
    param_index: Optional[int] = None


def nothing() -> ExprResult:
    return ExprResult("nothing")


@dataclass
class BufferDest:
    kind: str  # "temp_buffer_index" | "output_index"
    index: int


@dataclass
class Instr:
    op: str
    # op-specific fields
    out: Optional[BufferDest] = None
    out_float: Optional[int] = None  # temp float index
    in_result: Optional[ExprResult] = None
    in_self_param: Optional[int] = None
    arith_op: Optional[str] = None
    a: Optional[ExprResult] = None
    b: Optional[ExprResult] = None
    field_index: Optional[int] = None
    temps: Optional[List[int]] = None
    args: Optional[List[ExprResult]] = None
    track_index: Optional[int] = None
    speed: Optional[ExprResult] = None
    trigger_index: Optional[int] = None
    note_tracker_index: Optional[int] = None
    delay_index: Optional[int] = None
    feedback_out_temp_buffer_index: Optional[int] = None
    feedback_temp_buffer_index: Optional[int] = None
    instructions: Optional[List["Instr"]] = None


@dataclass
class Field:
    module_index: int


@dataclass
class CodeGenModuleResult:
    num_outputs: int
    num_temps: int
    num_temp_floats: int
    is_builtin: bool
    fields: List[Field] = field(default_factory=list)
    delays: List[int] = field(default_factory=list)  # num_samples per delay
    note_trackers: List[int] = field(default_factory=list)  # track indices
    triggers: List[int] = field(default_factory=list)  # track indices
    instructions: List[Instr] = field(default_factory=list)


@dataclass
class CodeGenTrackResult:
    note_values: List[List[ExprResult]]


@dataclass
class ExportedModule:
    name: str
    module_index: int


@dataclass
class CodeGenResult:
    track_results: List[CodeGenTrackResult]
    module_results: List[CodeGenModuleResult]
    exported_modules: List[ExportedModule]


# ---------------------------------------------------------------------------


class TempManager:
    def __init__(self, reuse_slots: bool):
        self.reuse_slots = reuse_slots
        self.slot_claimed: List[bool] = []

    def claim(self) -> int:
        if self.reuse_slots:
            for i, in_use in enumerate(self.slot_claimed):
                if not in_use:
                    self.slot_claimed[i] = True
                    return i
        self.slot_claimed.append(True)
        return len(self.slot_claimed) - 1

    def release(self, index: int):
        assert self.slot_claimed[index]
        self.slot_claimed[index] = False

    def final_count(self) -> int:
        return len(self.slot_claimed)


class _ModuleCodegen:
    def __init__(self, module_index: int, locals_: List[P.Local]):
        self.module_index = module_index
        self.locals = locals_
        self.instructions: List[Instr] = []
        self.temp_buffers = TempManager(reuse_slots=True)
        self.temp_floats = TempManager(reuse_slots=False)
        self.local_results: List[Optional[ExprResult]] = [None] * len(locals_)
        self.fields: List[Field] = []
        self.delays: List[int] = []
        self.triggers: List[int] = []
        self.note_trackers: List[int] = []
        self.current_delay: Optional[dict] = None  # {feedback_temp_index, instructions}
        self.current_track_call: Optional[dict] = None  # {track_index, instructions}


class Codegen:
    def __init__(self, source: Source, parse_result: P.ParseResult, color=False):
        self.source = source
        self.pr = parse_result
        self.color = color
        self.global_results: List[Optional[ExprResult]] = [None] * len(parse_result.globals)
        self.global_visited = [False] * len(parse_result.globals)
        self.track_results: List[Optional[CodeGenTrackResult]] = [None] * len(parse_result.tracks)
        self.module_results: List[Optional[CodeGenModuleResult]] = [None] * len(parse_result.modules)

    def _fail(self, sr: SourceRange, msg: str):
        raise ScriptError(self.source, sr, msg, self.color)

    # -- type queries ------------------------------------------------------

    def _param_type(self, cms: Optional[_ModuleCodegen], r: ExprResult) -> Optional[ParamType]:
        if r.kind == "self_param":
            return self.pr.modules[cms.module_index].params[r.index].param_type
        if r.kind == "track_param":
            return self.pr.tracks[r.track_index].params[r.param_index].param_type
        return None

    def is_boolean(self, cms, r: ExprResult) -> bool:
        if r.kind == "literal_boolean":
            return True
        pt = self._param_type(cms, r)
        return pt is not None and pt.kind == "boolean"

    def is_float(self, cms, r: ExprResult) -> bool:
        if r.kind in ("temp_float", "literal_number"):
            return True
        pt = self._param_type(cms, r)
        return pt is not None and pt.kind == "constant"

    def is_buffer(self, cms, r: ExprResult) -> bool:
        if r.kind == "temp_buffer":
            return True
        pt = self._param_type(cms, r)
        return pt is not None and pt.kind == "buffer"

    def is_curve(self, cms, r: ExprResult) -> bool:
        if r.kind == "literal_curve":
            return True
        pt = self._param_type(cms, r)
        return pt is not None and pt.kind == "curve"

    def is_enum_value(self, cms, r: ExprResult, e: BuiltinEnum) -> bool:
        if r.kind == "literal_enum_value":
            has_payload = r.enum_payload is not None and self.is_float(cms, r.enum_payload)
            return e.allows(r.enum_label, has_payload)
        pt = self._param_type(cms, r)
        if pt is not None and pt.kind == "one_of":
            for pv in pt.enum.values:
                if not e.allows(pv.label, pv.payload == "f32"):
                    return False
            return True
        return False

    # -- temp bookkeeping --------------------------------------------------

    def release(self, cms: _ModuleCodegen, r: ExprResult):
        if r.kind == "temp_buffer" and not r.temp.is_weak:
            cms.temp_buffers.release(r.temp.index)
        elif r.kind == "temp_float" and not r.temp.is_weak:
            cms.temp_floats.release(r.temp.index)
        elif r.kind == "literal_enum_value" and r.enum_payload is not None:
            self.release(cms, r.enum_payload)

    def add_instruction(self, cms: _ModuleCodegen, instr: Instr):
        if cms.current_track_call is not None:
            cms.current_track_call["instructions"].append(instr)
        elif cms.current_delay is not None:
            cms.current_delay["instructions"].append(instr)
        else:
            cms.instructions.append(instr)

    def request_buffer_dest(self, cms, result_loc: Optional[BufferDest]) -> BufferDest:
        if result_loc is not None:
            return result_loc
        return BufferDest("temp_buffer_index", cms.temp_buffers.claim())

    def commit_buffer_dest(self, result_loc, dest: BufferDest) -> ExprResult:
        if result_loc is not None:
            return nothing()
        assert dest.kind == "temp_buffer_index"
        return ExprResult("temp_buffer", temp=TempRef(dest.index, False))

    # -- expression generation --------------------------------------------

    def gen_expression(self, cms: Optional[_ModuleCodegen], expr: P.Expression,
                       result_loc: Optional[BufferDest] = None) -> ExprResult:
        k = expr.kind
        if k == "literal_boolean":
            return ExprResult("literal_boolean", literal_boolean=expr.literal_boolean)
        if k == "literal_number":
            return ExprResult("literal_number", literal_number=expr.literal_number)
        if k == "literal_enum_value":
            v = expr.literal_enum_value
            payload = None
            if v.payload is not None:
                payload = self.gen_expression(cms, v.payload, None)
            return ExprResult("literal_enum_value", enum_label=v.label, enum_payload=payload)
        if k == "literal_curve":
            return ExprResult("literal_curve", index=expr.literal_index)
        if k == "literal_track":
            self.gen_track(expr.literal_index)
            return ExprResult("literal_track", index=expr.literal_index)
        if k == "literal_module":
            self.gen_module(expr.literal_index)
            return ExprResult("literal_module", index=expr.literal_index)
        if k == "name":
            return self._gen_name(cms, expr, result_loc)
        if k == "local":
            result = cms.local_results[expr.local_index]
            assert result is not None
            return self._weaken(result)
        if k == "un_arith":
            if cms is None:
                self._fail(expr.source_range, "constant arithmetic is not supported")
            return self._gen_un_arith(cms, expr.source_range, result_loc,
                                      expr.un_arith.op, expr.un_arith.a)
        if k == "bin_arith":
            if cms is None:
                self._fail(expr.source_range, "constant arithmetic is not supported")
            return self._gen_bin_arith(cms, expr.source_range, result_loc,
                                       expr.bin_arith.op, expr.bin_arith.a, expr.bin_arith.b)
        if k == "call":
            return self._gen_call(cms, expr.source_range, result_loc, expr.call)
        if k == "track_call":
            return self._gen_track_call(cms, expr.source_range, result_loc, expr.track_call)
        if k == "delay":
            return self._gen_delay(cms, expr.source_range, result_loc, expr.delay)
        if k == "feedback":
            if cms is None or cms.current_delay is None:
                self._fail(expr.source_range,
                           "`feedback` can only be used within a `delay` operation")
            return ExprResult("temp_buffer",
                              temp=TempRef(cms.current_delay["feedback_temp_index"], True))
        raise AssertionError(k)

    @staticmethod
    def _weaken(result: ExprResult) -> ExprResult:
        if result.kind in ("temp_buffer", "temp_float"):
            return ExprResult(result.kind, temp=TempRef(result.temp.index, True))
        return result

    def _gen_name(self, cms, expr: P.Expression, result_loc) -> ExprResult:
        token = expr.name_token
        name = self.source.get_string(token.source_range)
        if cms is not None:
            if cms.current_track_call is not None:
                track = self.pr.tracks[cms.current_track_call["track_index"]]
                for pi, param in enumerate(track.params):
                    if param.name == name:
                        return ExprResult(
                            "track_param",
                            track_index=cms.current_track_call["track_index"],
                            param_index=pi,
                        )
            for pi, param in enumerate(self.pr.modules[cms.module_index].params):
                if param.name == name:
                    if param.param_type.kind == "constant_or_buffer":
                        dest = self.request_buffer_dest(cms, result_loc)
                        self.add_instruction(cms, Instr(
                            "cob_to_buffer", out=dest, in_self_param=pi))
                        return self.commit_buffer_dest(result_loc, dest)
                    return ExprResult("self_param", index=pi)
        for gi, g in enumerate(self.pr.globals):
            if g.name == name:
                break
        else:
            self._fail(token.source_range, f"use of undeclared identifier `{name}`")
        if self.global_results[gi] is None:
            if self.global_visited[gi]:
                self._fail(token.source_range, "circular reference in global")
            self.global_visited[gi] = True
            self.global_results[gi] = self.gen_expression(None, self.pr.globals[gi].value)
        return self._weaken(self.global_results[gi])

    def _gen_un_arith(self, cms, sr, result_loc, op, ea) -> ExprResult:
        ra = self.gen_expression(cms, ea, None)
        try:
            if self.is_float(cms, ra):
                out_f = cms.temp_floats.claim()
                self.add_instruction(cms, Instr("arith_float", out_float=out_f,
                                                arith_op=op, a=ra))
                return ExprResult("temp_float", temp=TempRef(out_f, False))
            if self.is_buffer(cms, ra):
                dest = self.request_buffer_dest(cms, result_loc)
                self.add_instruction(cms, Instr("arith_buffer", out=dest,
                                                arith_op=op, a=ra))
                return self.commit_buffer_dest(result_loc, dest)
            self._fail(sr, "arithmetic can only be performed on numeric types")
        finally:
            self.release(cms, ra)

    def _gen_bin_arith(self, cms, sr, result_loc, op, ea, eb) -> ExprResult:
        ra = self.gen_expression(cms, ea, None)
        rb = self.gen_expression(cms, eb, None)
        try:
            a_f, b_f = self.is_float(cms, ra), self.is_float(cms, rb)
            a_b, b_b = self.is_buffer(cms, ra), self.is_buffer(cms, rb)
            if a_f and b_f:
                out_f = cms.temp_floats.claim()
                self.add_instruction(cms, Instr("arith_float_float", out_float=out_f,
                                                arith_op=op, a=ra, b=rb))
                return ExprResult("temp_float", temp=TempRef(out_f, False))
            if a_f and b_b:
                dest = self.request_buffer_dest(cms, result_loc)
                self.add_instruction(cms, Instr("arith_float_buffer", out=dest,
                                                arith_op=op, a=ra, b=rb))
                return self.commit_buffer_dest(result_loc, dest)
            if a_b and b_f:
                dest = self.request_buffer_dest(cms, result_loc)
                self.add_instruction(cms, Instr("arith_buffer_float", out=dest,
                                                arith_op=op, a=ra, b=rb))
                return self.commit_buffer_dest(result_loc, dest)
            if a_b and b_b:
                dest = self.request_buffer_dest(cms, result_loc)
                self.add_instruction(cms, Instr("arith_buffer_buffer", out=dest,
                                                arith_op=op, a=ra, b=rb))
                return self.commit_buffer_dest(result_loc, dest)
            self._fail(sr, "arithmetic can only be performed on numeric types")
        finally:
            self.release(cms, ra)
            self.release(cms, rb)

    def _commit_callee_param(self, cms, sr, result: ExprResult,
                             pt: ParamType) -> ExprResult:
        if pt.kind == "boolean":
            if self.is_boolean(cms, result):
                return result
            self._fail(sr, "expected boolean value")
        if pt.kind == "buffer":
            if self.is_buffer(cms, result):
                return result
            if self.is_float(cms, result):
                idx = cms.temp_buffers.claim()
                self.add_instruction(cms, Instr(
                    "float_to_buffer", out=BufferDest("temp_buffer_index", idx),
                    in_result=result))
                return ExprResult("temp_buffer", temp=TempRef(idx, False))
            self._fail(sr, "expected buffer value")
        if pt.kind == "constant_or_buffer":
            if self.is_buffer(cms, result) or self.is_float(cms, result):
                return result
            self._fail(sr, "expected float or buffer value")
        if pt.kind == "constant":
            if self.is_float(cms, result):
                return result
            self._fail(sr, "expected float value")
        if pt.kind == "curve":
            if self.is_curve(cms, result):
                return result
            self._fail(sr, "expected curve value")
        if pt.kind == "one_of":
            if self.is_enum_value(cms, result, pt.enum):
                return result
            labels = ", ".join(v.label for v in pt.enum.values)
            self._fail(sr, f"expected one of .{{{labels}}}")
        raise AssertionError(pt.kind)

    def _gen_args(self, cms, sr, params: List[ModuleParam],
                  args: List[P.CallArg]) -> List[ExprResult]:
        for a in args:
            if not any(a.param_name == p.name for p in params):
                self._fail(a.param_name_token.source_range,
                           f"call target has no param called `{a.param_name}`")
        results: List[ExprResult] = []
        for param in params:
            matching = [a for a in args if a.param_name == param.name]
            if len(matching) > 1:
                self._fail(matching[1].param_name_token.source_range,
                           f"param `{param.name}` provided more than once")
            if not matching and cms is not None and param.name == "sample_rate":
                # sample_rate is passed implicitly
                for j, sp in enumerate(self.pr.modules[cms.module_index].params):
                    if sp.name == "sample_rate":
                        results.append(ExprResult("self_param", index=j))
                        break
                else:
                    raise AssertionError("module without sample_rate param")
                continue
            if not matching:
                self._fail(sr, f"argument list is missing param `{param.name}`")
            arg = matching[0]
            result = self.gen_expression(cms, arg.value, None)
            results.append(self._commit_callee_param(
                cms, arg.value.source_range, result, param.param_type))
        return results

    def _gen_call(self, cms, sr, result_loc, call: P.Call) -> ExprResult:
        if cms is None:
            raise AssertionError("call at global scope")
        field_result = self.gen_expression(cms, call.field_expr, None)
        if field_result.kind != "literal_module":
            self._fail(call.field_expr.source_range, "not a module")
        callee_module_index = field_result.index

        field_index = len(cms.fields)
        cms.fields.append(Field(callee_module_index))

        callee = self.pr.modules[callee_module_index]
        arg_results = self._gen_args(cms, sr, callee.params, call.args)

        temps = [cms.temp_buffers.claim()
                 for _ in range(self.module_results[callee_module_index].num_temps)]

        dest = self.request_buffer_dest(cms, result_loc)
        self.add_instruction(cms, Instr(
            "call", out=dest, field_index=field_index, temps=temps,
            args=arg_results))
        for t in temps:
            cms.temp_buffers.release(t)
        for r in arg_results:
            self.release(cms, r)
        return self.commit_buffer_dest(result_loc, dest)

    def _gen_track_call(self, cms, sr, result_loc, tc: P.TrackCall) -> ExprResult:
        if cms.current_track_call is not None:
            self._fail(sr, "you cannot nest track calls")
        if cms.current_delay is not None:
            self._fail(sr, "you cannot use a track call inside a delay")
        track_result = self.gen_expression(cms, tc.track_expr, None)
        if track_result.kind != "literal_track":
            self._fail(tc.track_expr.source_range, "not a track")
        track_index = track_result.index
        speed_result = self.gen_expression(cms, tc.speed, None)
        if not self.is_float(cms, speed_result):
            self._fail(tc.speed.source_range, "speed must be a constant value")

        trigger_index = len(cms.triggers)
        cms.triggers.append(track_index)
        note_tracker_index = len(cms.note_trackers)
        cms.note_trackers.append(track_index)

        dest = self.request_buffer_dest(cms, result_loc)
        cms.current_track_call = {"track_index": track_index, "instructions": []}
        for stmt in tc.scope.statements:
            if stmt.kind == "let_assignment":
                cms.local_results[stmt.local_index] = self.gen_expression(
                    cms, stmt.expression, None)
            elif stmt.kind == "output":
                result = self.gen_expression(cms, stmt.expression, dest)
                self._commit_output(cms, stmt.expression.source_range, result, dest)
                self.release(cms, result)
            else:
                self._fail(stmt.expression.source_range,
                           "`feedback` can only be used within a `delay` operation")
        instructions = cms.current_track_call["instructions"]
        cms.current_track_call = None

        self.add_instruction(cms, Instr(
            "track_call", out=dest, track_index=track_index, speed=speed_result,
            trigger_index=trigger_index, note_tracker_index=note_tracker_index,
            instructions=instructions))
        self.release(cms, speed_result)
        return self.commit_buffer_dest(result_loc, dest)

    def _gen_delay(self, cms, sr, result_loc, delay: P.DelayExpr) -> ExprResult:
        if cms.current_delay is not None:
            self._fail(sr, "you cannot nest delay operations")
        if cms.current_track_call is not None:
            self._fail(sr, "you cannot use a delay inside a track call")
        delay_index = len(cms.delays)
        cms.delays.append(delay.num_samples)

        feedback_temp_index = cms.temp_buffers.claim()
        dest = self.request_buffer_dest(cms, result_loc)
        feedback_out_temp_index = cms.temp_buffers.claim()

        cms.current_delay = {
            "feedback_temp_index": feedback_temp_index,
            "instructions": [],
        }
        for stmt in delay.scope.statements:
            if stmt.kind == "let_assignment":
                cms.local_results[stmt.local_index] = self.gen_expression(
                    cms, stmt.expression, None)
            elif stmt.kind == "output":
                result = self.gen_expression(cms, stmt.expression, dest)
                self._commit_output(cms, stmt.expression.source_range, result, dest)
                self.release(cms, result)
            elif stmt.kind == "feedback":
                loc = BufferDest("temp_buffer_index", feedback_out_temp_index)
                result = self.gen_expression(cms, stmt.expression, loc)
                self._commit_output(cms, stmt.expression.source_range, result, loc)
                self.release(cms, result)
        instructions = cms.current_delay["instructions"]
        cms.current_delay = None

        self.add_instruction(cms, Instr(
            "delay", out=dest, delay_index=delay_index,
            feedback_out_temp_buffer_index=feedback_out_temp_index,
            feedback_temp_buffer_index=feedback_temp_index,
            instructions=instructions))
        cms.temp_buffers.release(feedback_temp_index)
        cms.temp_buffers.release(feedback_out_temp_index)
        return self.commit_buffer_dest(result_loc, dest)

    def _commit_output(self, cms, sr, result: ExprResult, dest: BufferDest):
        if result.kind == "nothing":
            return
        if result.kind == "temp_buffer":
            self.add_instruction(cms, Instr("copy_buffer", out=dest, in_result=result))
            return
        if result.kind in ("temp_float", "literal_number"):
            self.add_instruction(cms, Instr("float_to_buffer", out=dest, in_result=result))
            return
        if result.kind in ("self_param", "track_param"):
            pt = self._param_type(cms, result)
            if pt.kind in ("buffer", "constant_or_buffer"):
                self.add_instruction(cms, Instr("copy_buffer", out=dest, in_result=result))
                return
            if pt.kind == "constant":
                self.add_instruction(cms, Instr("float_to_buffer", out=dest, in_result=result))
                return
            self._fail(sr, f"expected buffer value, found {pt.kind}")
        kind_desc = {
            "literal_boolean": "boolean", "literal_enum_value": "enum value",
            "literal_curve": "curve", "literal_track": "track",
            "literal_module": "module",
        }[result.kind]
        self._fail(sr, f"expected buffer value, found {kind_desc}")

    # -- module / track / top level ---------------------------------------

    def gen_track(self, track_index: int):
        if self.track_results[track_index] is not None:
            return
        track = self.pr.tracks[track_index]
        notes = [
            self._gen_args(None, note.args_source_range, track.params, note.args)
            for note in track.notes
        ]
        self.track_results[track_index] = CodeGenTrackResult(notes)

    def gen_module(self, module_index: int):
        if self.module_results[module_index] is not None:
            return
        info = self.pr.modules[module_index].info
        assert info is not None, "builtin modules are pre-generated"
        cms = _ModuleCodegen(module_index, info.locals)
        for stmt in info.scope.statements:
            if stmt.kind == "let_assignment":
                cms.local_results[stmt.local_index] = self.gen_expression(
                    cms, stmt.expression, None)
            elif stmt.kind == "output":
                dest = BufferDest("output_index", 0)
                result = self.gen_expression(cms, stmt.expression, dest)
                self._commit_output(cms, stmt.expression.source_range, result, dest)
                self.release(cms, result)
            else:
                self._fail(stmt.expression.source_range,
                           "`feedback` can only be used within a `delay` operation")
        for r in cms.local_results:
            if r is not None:
                self.release(cms, r)
        self.module_results[module_index] = CodeGenModuleResult(
            num_outputs=1,
            num_temps=cms.temp_buffers.final_count(),
            num_temp_floats=cms.temp_floats.final_count(),
            is_builtin=False,
            fields=cms.fields,
            delays=cms.delays,
            note_trackers=cms.note_trackers,
            triggers=cms.triggers,
            instructions=cms.instructions,
        )

    def run(self, builtin_packages) -> CodeGenResult:
        # builtin module results first
        bi = 0
        for pkg in builtin_packages:
            for b in pkg["builtins"]:
                self.module_results[bi] = CodeGenModuleResult(
                    num_outputs=b.num_outputs, num_temps=b.num_temps,
                    num_temp_floats=0, is_builtin=True)
                bi += 1
        for gi, g in enumerate(self.pr.globals):
            if self.global_visited[gi]:
                continue
            self.global_visited[gi] = True
            self.global_results[gi] = self.gen_expression(None, g.value)
        exported = []
        for gi, g in enumerate(self.pr.globals):
            r = self.global_results[gi]
            if r is not None and r.kind == "literal_module":
                if self.pr.modules[r.index].info is None:
                    continue
                exported.append(ExportedModule(g.name, r.index))
        return CodeGenResult(
            track_results=[t for t in self.track_results],
            module_results=[m for m in self.module_results],
            exported_modules=exported,
        )


def codegen(source: Source, parse_result: P.ParseResult, builtin_packages,
            color: bool = False) -> CodeGenResult:
    return Codegen(source, parse_result, color).run(builtin_packages)
