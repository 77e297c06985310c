"""Debug printers: AST dump (--dump-parse) and bytecode dump (--dump-codegen).

Equivalents of src/zangscript/parse_print.zig and codegen_print.zig. These
are golden-snapshot targets: stable, human-readable text forms of the two
IRs (the reference's zangc grew these flags precisely for compiler golden
tests — SURVEY.md §4).
"""

from typing import List

from . import parse as P
from .codegen import CodeGenResult, ExprResult, Instr
from .compile import CompiledScript


def _expr(cs: CompiledScript, e: P.Expression, indent: int) -> List[str]:
    pad = "  " * indent
    k = e.kind
    out = []
    if k == "literal_number":
        out.append(f"{pad}number({e.literal_number.verbatim})")
    elif k == "literal_boolean":
        out.append(f"{pad}boolean({str(e.literal_boolean).lower()})")
    elif k == "literal_enum_value":
        v = e.literal_enum_value
        out.append(f"{pad}enum(.{v.label})")
        if v.payload is not None:
            out.extend(_expr(cs, v.payload, indent + 1))
    elif k == "literal_curve":
        out.append(f"{pad}curve#{e.literal_index}")
    elif k == "literal_track":
        out.append(f"{pad}track#{e.literal_index}")
    elif k == "literal_module":
        out.append(f"{pad}module#{e.literal_index}")
    elif k == "name":
        out.append(f"{pad}name({cs.source.get_string(e.name_token.source_range)})")
    elif k == "local":
        out.append(f"{pad}local#{e.local_index}")
    elif k == "un_arith":
        out.append(f"{pad}{e.un_arith.op}")
        out.extend(_expr(cs, e.un_arith.a, indent + 1))
    elif k == "bin_arith":
        out.append(f"{pad}{e.bin_arith.op}")
        out.extend(_expr(cs, e.bin_arith.a, indent + 1))
        out.extend(_expr(cs, e.bin_arith.b, indent + 1))
    elif k == "call":
        out.append(f"{pad}call")
        out.extend(_expr(cs, e.call.field_expr, indent + 1))
        for arg in e.call.args:
            out.append(f"{pad}  arg {arg.param_name}:")
            out.extend(_expr(cs, arg.value, indent + 2))
    elif k == "track_call":
        out.append(f"{pad}track_call")
        out.extend(_expr(cs, e.track_call.track_expr, indent + 1))
        out.append(f"{pad}  speed:")
        out.extend(_expr(cs, e.track_call.speed, indent + 2))
        out.extend(_scope(cs, e.track_call.scope, indent + 1))
    elif k == "delay":
        out.append(f"{pad}delay({e.delay.num_samples})")
        out.extend(_scope(cs, e.delay.scope, indent + 1))
    elif k == "feedback":
        out.append(f"{pad}feedback")
    else:
        out.append(f"{pad}<{k}>")
    return out


def _scope(cs: CompiledScript, scope: P.Scope, indent: int) -> List[str]:
    pad = "  " * indent
    out = []
    for stmt in scope.statements:
        if stmt.kind == "let_assignment":
            out.append(f"{pad}let local#{stmt.local_index} =")
        elif stmt.kind == "output":
            out.append(f"{pad}out")
        else:
            out.append(f"{pad}feedback")
        out.extend(_expr(cs, stmt.expression, indent + 1))
    return out


def dump_parse(cs: CompiledScript) -> str:
    lines = []
    for mi, module in enumerate(cs.modules):
        if module.info is None:
            continue
        name = next((em.name for em in cs.exported_modules if em.module_index == mi),
                    f"<anon#{mi}>")
        params = ", ".join(f"{p.name}: {p.param_type}" for p in module.params)
        lines.append(f"module#{mi} {name}({params})")
        lines.extend(_scope(cs, module.info.scope, 1))
    for ci, curve in enumerate(cs.curves):
        pts = " ".join(f"{p.t.verbatim}:{p.value.verbatim}" for p in curve.points)
        lines.append(f"curve#{ci} {pts}")
    for ti, track in enumerate(cs.tracks):
        params = ", ".join(f"{p.name}: {p.param_type}" for p in track.params)
        lines.append(f"track#{ti} ({params})")
        for note in track.notes:
            args = ", ".join(f"{a.param_name}=..." for a in note.args)
            lines.append(f"  {note.t.verbatim} ({args})")
    return "\n".join(lines) + "\n"


def _result(r: ExprResult) -> str:
    k = r.kind
    if k == "temp_buffer":
        return f"temp{r.temp.index}{'w' if r.temp.is_weak else ''}"
    if k == "temp_float":
        return f"tf{r.temp.index}{'w' if r.temp.is_weak else ''}"
    if k == "literal_number":
        return r.literal_number.verbatim
    if k == "literal_boolean":
        return str(r.literal_boolean).lower()
    if k == "literal_enum_value":
        s = f".{r.enum_label}"
        if r.enum_payload is not None:
            s += f"({_result(r.enum_payload)})"
        return s
    if k == "literal_curve":
        return f"curve#{r.index}"
    if k == "literal_track":
        return f"track#{r.index}"
    if k == "literal_module":
        return f"module#{r.index}"
    if k == "self_param":
        return f"param{r.index}"
    if k == "track_param":
        return f"trackparam({r.track_index},{r.param_index})"
    return k


def _dest(instr: Instr) -> str:
    if instr.out_float is not None:
        return f"tf{instr.out_float}"
    if instr.out.kind == "output_index":
        return f"out{instr.out.index}"
    return f"temp{instr.out.index}"


def _instrs(instrs: List[Instr], indent: int) -> List[str]:
    pad = "  " * indent
    out = []
    for i in instrs:
        if i.op in ("copy_buffer", "float_to_buffer"):
            out.append(f"{pad}{_dest(i)} := {i.op}({_result(i.in_result)})")
        elif i.op == "cob_to_buffer":
            out.append(f"{pad}{_dest(i)} := cob_to_buffer(param{i.in_self_param})")
        elif i.op.startswith("arith"):
            operands = _result(i.a) + (f", {_result(i.b)}" if i.b is not None else "")
            out.append(f"{pad}{_dest(i)} := {i.arith_op}({operands})")
        elif i.op == "call":
            args = ", ".join(_result(a) for a in i.args)
            temps = ",".join(str(t) for t in i.temps)
            out.append(f"{pad}{_dest(i)} := call field{i.field_index} "
                       f"temps=[{temps}] ({args})")
        elif i.op == "track_call":
            out.append(f"{pad}{_dest(i)} := track_call track#{i.track_index} "
                       f"speed={_result(i.speed)}")
            out.extend(_instrs(i.instructions, indent + 1))
        elif i.op == "delay":
            out.append(f"{pad}{_dest(i)} := delay#{i.delay_index} "
                       f"fb=temp{i.feedback_temp_buffer_index} "
                       f"fbout=temp{i.feedback_out_temp_buffer_index}")
            out.extend(_instrs(i.instructions, indent + 1))
        else:
            out.append(f"{pad}{i.op}")
    return out


def dump_codegen(cs: CompiledScript) -> str:
    lines = []
    for mi, mr in enumerate(cs.codegen_result.module_results):
        if mr is None or mr.is_builtin:
            continue
        name = next((em.name for em in cs.exported_modules if em.module_index == mi),
                    f"<anon#{mi}>")
        lines.append(f"module#{mi} {name}: num_temps={mr.num_temps} "
                     f"num_temp_floats={mr.num_temp_floats} "
                     f"fields={[f.module_index for f in mr.fields]} "
                     f"delays={mr.delays} trackers={mr.note_trackers}")
        lines.extend(_instrs(mr.instructions, 1))
    return "\n".join(lines) + "\n"


def dump_builtins(packages=None) -> str:
    lines = []
    if packages is None:
        from .compile import builtin_packages

        packages = builtin_packages()
    for pkg in packages:
        for e in pkg["enums"]:
            vals = ", ".join(
                v.label + ("(f32)" if v.payload == "f32" else "")
                for v in e.values)
            lines.append(f"enum {e.name}: {vals}")
    for pkg in packages:
        for b in pkg["builtins"]:
            params = ", ".join(f"{p.name}: {p.param_type}" for p in b.params)
            custom = " [user]" if getattr(b, "custom", None) is not None else ""
            lines.append(f"module {b.name}({params}){custom}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# lowered device-IR dump (the generated-source analog, codegen_zig.zig:461-577)


def _ref(v) -> str:
    if isinstance(v, tuple) and v:
        if v[0] == "temp":
            return f"t{v[1]}"
        if v[0] == "col":
            return f"{v[1]}.{v[2]}"
        if v[0] == "const":
            return f"const({v[1]:g})"
        return "(" + ", ".join(_ref(x) for x in v) + ")"
    return str(v)


def _lowered_op_lines(e: dict, indent: int):
    pad = "  " * indent
    dest = e.get("dest")
    dest_s = ""
    if dest is not None:
        kind, idx = dest
        dest_s = f" -> {'+' if kind == 'acc' else ''}t{idx}"
    skip = {"op", "dest", "inner", "sub", "inner_dest"}
    parts = [e["op"]]
    for k in sorted(set(e) - skip):
        parts.append(f"{k}={_ref(e[k])}")
    if "inner_dest" in e:
        parts.append(f"inner_dest=t{e['inner_dest']}")
    lines = [pad + " ".join(parts) + dest_s]
    for key in ("inner",):
        if key in e:
            for sub in e[key]:
                lines.extend(_lowered_op_lines(sub, indent + 1))
    if "sub" in e:
        for sub in e["sub"]["ops"]:
            lines.extend(_lowered_op_lines(sub, indent + 1))
        lines.append("  " * (indent + 1) + f"(inline out: t{e['sub']['out']})")
    return lines


def dump_lowered(cs: CompiledScript, module_name=None,
                 sample_rate: float = 44100.0) -> str:
    """Plan each exported module against a one-note canonical timeline and
    print the flat device IR: the diffable "generated source" artifact (the
    reference emits lowered Zig here, codegen_zig.zig:461-577; our lowered
    form is the op list the renderer executes, with SegProgram columns).

    The canonical timeline (one voice, one note at t=0, freq=440, booleans
    true, enums at their first label) only determines column VALUES; the op
    structure, temp/site numbering, state specs, and column names — what the
    dump shows — depend only on the script."""
    from ..core.notes import SongEvent
    from ..core.timeline import compile_timelines
    from .torch_backend import PlanError, ScriptInstrument

    lines = []
    for em in cs.exported_modules:
        if module_name is not None and em.name != module_name:
            continue
        module = cs.modules[em.module_index]
        params = {}
        for p in module.params:
            if p.name == "sample_rate":
                continue
            kind = p.param_type.kind
            if kind == "boolean":
                params[p.name] = True
            elif kind == "one_of":
                params[p.name] = p.param_type.enum.values[0].label
            else:
                params[p.name] = 440.0 if p.name == "freq" else 1.0
        lines.append(f"module {em.name}:")
        inst = ScriptInstrument(cs, em.name)
        tls = compile_timelines([SongEvent(params, t=0.0, note_id=1)],
                                1, sample_rate, 4096)
        try:
            prog = inst.plan(tls, sample_rate)
        except PlanError as e:
            lines.append(f"  (not lowerable from note params: {e})")
            continue
        for site, spec in sorted(inst._state_specs.items()):
            desc = spec[0] + (f"({spec[1]})" if len(spec) > 1 else "")
            lines.append(f"  state {site}: {desc}")
        for key in sorted(prog):
            if key.startswith("scale_"):
                cols = ", ".join(sorted(prog[key].values))
                lines.append(f"  scale {key[len('scale_'):]}: [{cols}]")
            elif key.startswith("prog_"):
                lines.append(f"  painter {key[len('prog_'):]}")
        lines.append("  ops:")
        for op in inst._ir["ops"]:
            lines.extend(_lowered_op_lines(op, 2))
        lines.append(f"  out: t{inst._ir['out']}")
    return "\n".join(lines) + "\n"
