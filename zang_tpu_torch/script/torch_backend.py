"""zangscript torch backend: bytecode -> render programs on the card (port
of zang_tpu/script/jax_backend.py).

Plan phase (host, per performance; numpy, the JAX package's planner copied
as it is, so site names, temp numbers and column order are its own):
- walks the compiled bytecode once, evaluating all float-typed ops per note
  segment (np.float32 [V, K] arrays — the reference computes these per paint
  call, i.e. per note span: identical values),
- compiles Envelope/Portamento/Gate/Curve call sites into painter programs,
  oscillator call sites with note-rate frequencies into exact u32 phase
  tables, track calls into inner timelines (tracker/trigger simulation per
  the generated-Zig protocol, codegen_zig.zig:363-394),
- emits a flat IR (custom module calls fully inlined; buffer temps renamed
  into one global space) whose leaves are chunk-sliceable SegPrograms.

Render phase (per chunk, torch on the render's device): evaluates the
note-rate columns of each scale, then executes the IR with the port's ops.
Multiple `out` statements add (the paint convention); temps overwrite; a
delay's feedback runs as a host loop over sub-chunks no longer than the
delay. A Filter with a plan-time-constant res and a fixed type reaches the
dense-cut SVF kernel (ops/filters.svf_filter) on a CUDA tensor; a "mix"
type (a type that changes by note) or a per-sample res takes the plain scan
there, as in the JAX package.
"""

import zlib
from dataclasses import dataclass, field as dfield
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.curves import PaintCurve
from ..core.notes import NoteTracker, SongEvent
from ..core.span import Span
from ..core.timeline import SubvoiceTimeline, active_from
from ..core.trigger import Trigger
from ..ops import control, effects, filters, noise as noise_ops, oscillators
from ..ops.scan import U32, exclusive_cumsum_u32, freq_to_ifreq, u32, utof23
from ..ops.segprog import SegProgram, eval_chunk
from .codegen import ExprResult, Instr
from .compile import CompiledScript

F32 = np.float32


class PlanError(Exception):
    """A script construct this backend cannot lower to the device IR.

    Raised with a human-readable message (instead of a bare
    NotImplementedError traceback) so zangc / host callers can surface it
    like a compile diagnostic."""


# ---------------------------------------------------------------------------
# plan-time values


@dataclass
class Val:
    kind: str  # float | buffer | bool | enum | curve | track | nothing
    col: Optional[str] = None  # float: column name in its scale's program
    arr: Optional[np.ndarray] = None  # float/bool: [V, K] host values;
    #   enum: [V, K] object array of labels when the value varies per note
    #   (track/exported enum params); None for a static literal label
    temp: Optional[int] = None  # buffer: global temp id
    enum_label: Optional[str] = None
    enum_payload: Optional["Val"] = None
    index: Optional[int] = None  # curve/track index
    scale: Optional[str] = None  # which note scale [V, K] refers to


@dataclass
class _NoteScale:
    """One timeline's note-rate table (the root module or a track call)."""

    name: str
    timelines: List[SubvoiceTimeline]
    K: int
    starts: np.ndarray  # [V, K] int64
    columns: Dict[str, np.ndarray] = dfield(default_factory=dict)

    def add_column(self, name: str, arr) -> str:
        self.columns[name] = np.asarray(arr)
        return name

    def seg_program(self) -> SegProgram:
        return SegProgram(starts=self.starts, values=dict(self.columns))


def _make_scale(name: str, timelines: List[SubvoiceTimeline]) -> _NoteScale:
    V = len(timelines)
    total = timelines[0].total
    K = max(1, max(len(tl.starts) for tl in timelines))
    starts = np.full((V, K), total, dtype=np.int64)
    for v, tl in enumerate(timelines):
        k = len(tl.starts)
        starts[v, :k] = tl.starts
    return _NoteScale(name=name, timelines=timelines, K=K, starts=starts)


def _pad_param(timelines, K, fn, dtype=np.float32, default=0):
    V = len(timelines)
    out = np.full((V, K), default, dtype=dtype)
    for v, tl in enumerate(timelines):
        k = len(tl.starts)
        if k:
            vals = np.array([fn(p) for p in tl.params], dtype=dtype)
            out[v, :k] = vals
            out[v, k:] = vals[-1]
    return out


def _enum_label_of(x):
    """Note-param enum values are a label or a (label, payload) tuple."""
    return x[0] if isinstance(x, tuple) else x


def _enum_payload_of(x) -> float:
    if isinstance(x, tuple) and x[1] is not None:
        return float(x[1])
    return 0.0


def _enum_param_vals(timelines, K, getter, enum, scale_name) -> Val:
    """Build a varying-enum Val ([V, K] labels + payload floats)."""
    default = enum.values[0].label if enum is not None and enum.values else ""
    labels = _pad_param(
        timelines, K, lambda pp: _enum_label_of(getter(pp, default)),
        dtype=object, default=default)
    payload = _pad_param(
        timelines, K, lambda pp: F32(_enum_payload_of(getter(pp, default))))
    return Val("enum", arr=labels, scale=scale_name,
               enum_payload=Val("float", arr=payload, scale=scale_name))


def track_note_events(track, note_values) -> List[SongEvent]:
    """Track note rows -> SongEvents (shared by the batch planner and the
    incremental live planner). Enum values become (label, payload) tuples.

    Note args are evaluated in the global scope (codegen gen_track /
    reference codegen.zig:764-774 + genArgs), so only literal kinds — and
    global names resolving to them — reach here; the reference rejects
    constant arithmetic at global scope (codegen.zig:925)."""
    song = []
    for ni, note in enumerate(track.notes):
        params: Dict[str, Any] = {"_active": 1.0}
        for pi, param in enumerate(track.params):
            r = note_values[ni][pi]
            if r.kind == "literal_number":
                params[param.name] = float(F32(r.literal_number.value))
            elif r.kind == "literal_boolean":
                params[param.name] = r.literal_boolean
            elif r.kind == "literal_enum_value":
                pay = None
                if r.enum_payload is not None:
                    if r.enum_payload.kind != "literal_number":
                        raise PlanError(
                            f"track note value for param {param.name!r}: enum "
                            "payload must be a literal number (or a global "
                            "resolving to one)")
                    pay = float(F32(r.enum_payload.literal_number.value))
                params[param.name] = (r.enum_label, pay)
            else:
                raise PlanError(
                    f"track note value for param {param.name!r} has kind "
                    f"{r.kind!r}; track notes accept literal numbers, "
                    "booleans, enum values, and globals resolving to them")
        song.append(SongEvent(params, t=float(F32(note.t.value)), note_id=ni + 1))
    return song


# ---------------------------------------------------------------------------


class ScriptInstrument:
    """A compiled zangscript module as a graph.render Instrument.

    Exported-module params are driven from note params (the host convention:
    freq/note_on from the keyboard or song, example.zig host). param_map
    maps script param name -> note-params key (default identity).
    """

    def __init__(self, compiled: CompiledScript, module_name: str,
                 param_map: Optional[Dict[str, str]] = None):
        self.compiled = compiled
        self.module_name = module_name
        self.module_index = compiled.find_module(module_name)
        self.param_map = param_map or {}

    def root_bindings(self, timelines: List[SubvoiceTimeline], K: int,
                      sample_rate: float) -> Dict[int, "Val"]:
        """Exported-module param bindings from note params (shared by the
        batch plan and the incremental live planner's walks)."""
        module = self.compiled.modules[self.module_index]
        bindings: Dict[int, Val] = {}
        for i, param in enumerate(module.params):
            if param.name == "sample_rate":
                arr = np.full((len(timelines), K), F32(sample_rate))
                bindings[i] = Val("float", arr=arr, scale="note")
                continue
            key = self.param_map.get(param.name, param.name)
            pt = param.param_type.kind
            if pt == "boolean":
                arr = _pad_param(timelines, K, lambda pp: bool(pp[key]), dtype=bool)
                bindings[i] = Val("bool", arr=arr, scale="note")
            elif pt in ("constant", "constant_or_buffer"):
                arr = _pad_param(timelines, K, lambda pp: F32(pp[key]))
                bindings[i] = Val("float", arr=arr, scale="note")
            elif pt == "one_of":
                # enum params note-drive as label strings (or
                # (label, payload) tuples) in the note params dict
                bindings[i] = _enum_param_vals(
                    timelines, K, lambda pp, d: pp.get(key, d),
                    param.param_type.enum, "note")
            else:
                raise PlanError(
                    f"exported param {param.name!r} of type {pt!r} cannot be "
                    "driven from note params; supported: boolean, constant, "
                    "constant_or_buffer, and enum params (pass the label, or "
                    "a (label, payload) tuple, in the note params)"
                )
        return bindings

    def plan(self, timelines: List[SubvoiceTimeline], sample_rate: float):
        p = _Planner(self.compiled, float(sample_rate), len(timelines))
        root = _make_scale("note", timelines)
        p.scales["note"] = root

        bindings = self.root_bindings(timelines, root.K, float(sample_rate))
        self._ir = p.inline_module(self.module_index, bindings, "note")
        self._planner = p
        self._state_specs = p.state_specs
        prog = {"active_from": active_from(timelines)}
        for name, scale in p.scales.items():
            prog[f"scale_{name}"] = scale.seg_program()
        prog.update(p.programs)
        return prog

    def live_planner(self, polyphony: int, sample_rate: float):
        """Incremental live planner (script/liveplan.py): O(events) host work
        a block instead of re-walking the whole session's plan."""
        from .liveplan import ScriptLivePlanner

        return ScriptLivePlanner(self, polyphony, float(sample_rate))

    def init_state(self, num_voices: int, device):
        """The state of every stateful site on `device`: filter (l, b),
        phase counters and the decimator's counter (u32 in int64, ops/scan.py),
        delay lines, and a user builtin's init_state(num_voices, device)."""
        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        state = {}
        for key, spec in self._state_specs.items():
            kind = spec[0]
            if kind == "filter":
                state[key] = {"l": z(num_voices), "b": z(num_voices)}
            elif kind == "phase":
                state[key] = z(num_voices, dtype=torch.int64)
            elif kind == "decimator":
                state[key] = {"cnt": torch.full((num_voices,), U32, dtype=torch.int64,
                                                device=device),
                              "val": z(num_voices)}
            elif kind == "delay":
                state[key] = z(num_voices, spec[1])
            elif kind == "user":
                init = getattr(spec[1], "init_state", None)
                state[key] = init(num_voices, device) if init is not None else {}
            else:
                raise AssertionError(kind)
        return state

    def render(self, state, prog, ctx):
        r = _Renderer(state, prog, ctx)
        # mask by the voice's active window: before a subvoice's first
        # impulse the reference host never paints the module at all, so
        # literal constants in the out expression must not leak into the
        # mix (module outputs are already gated; bare arithmetic is not)
        out = torch.where(r.active, r.run(self._ir), r.zero)
        return r.state, out


# ---------------------------------------------------------------------------
# planner


class _Planner:
    def __init__(self, compiled: CompiledScript, sample_rate: float, num_voices: int,
                 live=None):
        self.c = compiled
        self.sr = sample_rate
        self.V = num_voices
        self.scales: Dict[str, _NoteScale] = {}
        self.programs: Dict[str, SegProgram] = {}
        self.state_specs: Dict[str, tuple] = {}
        self.temp_counter = 0
        self.site_counter = 0
        self.col_counter = 0
        # live: script.liveplan backend — painter/osc/track sites route
        # through carried incremental state instead of full-timeline compiles
        self.live = live

    def fresh_temp(self) -> int:
        self.temp_counter += 1
        return self.temp_counter - 1

    def fresh_site(self, tag: str) -> str:
        self.site_counter += 1
        return f"{tag}{self.site_counter - 1}"

    def fresh_col(self, scale: _NoteScale, arr: np.ndarray) -> str:
        self.col_counter += 1
        name = f"c{self.col_counter - 1}"
        scale.add_column(name, arr.astype(np.float32))
        return name

    def coerce_scale(self, v: Val, target: str) -> np.ndarray:
        """Resample a float/bool Val's [V, K] array onto another scale."""
        if v.scale == target:
            return v.arr
        src = self.scales[v.scale]
        dst = self.scales[target]
        out = np.empty((self.V, dst.K), dtype=v.arr.dtype)
        for voice in range(self.V):
            idx = np.maximum(
                np.searchsorted(src.starts[voice], dst.starts[voice], side="right") - 1,
                0,
            )
            out[voice] = v.arr[voice, idx]
        return out

    def float_arith(self, op: str, a: np.ndarray, b=None) -> np.ndarray:
        f = lambda x: np.asarray(x, dtype=np.float32)
        a = f(a)
        if op == "neg":
            return -a
        if op == "abs":
            return np.abs(a)
        if op == "sin":
            return np.sin(a, dtype=np.float32)
        if op == "cos":
            return np.cos(a, dtype=np.float32)
        if op == "sqrt":
            return np.sqrt(a, dtype=np.float32)
        b = f(b)
        return {
            "add": lambda: a + b, "sub": lambda: a - b, "mul": lambda: a * b,
            "div": lambda: a / b, "min": lambda: np.minimum(a, b),
            "max": lambda: np.maximum(a, b),
            "pow": lambda: np.power(a, b, dtype=np.float32),
        }[op]()

    def inline_module(self, module_index: int, bindings: Dict[int, Val],
                      scale_name: str, track_ctx=None) -> dict:
        mr = self.c.codegen_result.module_results[module_index]
        assert not mr.is_builtin
        out_temp = self.fresh_temp()
        env = _InlineEnv(self, module_index, mr, bindings, scale_name,
                         out_temp, track_ctx)
        for instr in mr.instructions:
            env.gen(instr)
        return {"ops": env.ops, "out": out_temp}


class _InlineEnv:
    def __init__(self, p: _Planner, module_index, mr, bindings, scale_name,
                 out_temp, track_ctx=None):
        self.p = p
        self.module_index = module_index
        self.mr = mr
        self.bindings = bindings
        self.temp_map: Dict[int, int] = {}
        self.float_map: Dict[int, Val] = {}
        self.scale_name = scale_name
        self.ops: List[dict] = []
        self.out_temp = out_temp
        self.track_ctx = track_ctx
        self.dest_redirect: Dict[tuple, tuple] = {}

    @property
    def scale(self) -> _NoteScale:
        return self.p.scales[self.scale_name]

    def temp(self, local_index: int) -> int:
        if local_index not in self.temp_map:
            self.temp_map[local_index] = self.p.fresh_temp()
        return self.temp_map[local_index]

    def dest(self, out) -> tuple:
        if out.kind == "output_index":
            d = ("acc", self.out_temp)
        else:
            d = ("temp", self.temp(out.index))
        return self.dest_redirect.get(d, d)

    # -- values --------------------------------------------------------

    def const_float(self, value: float) -> Val:
        arr = np.full((self.p.V, self.scale.K), F32(value))
        return Val("float", arr=arr, scale=self.scale_name)

    def val(self, r: ExprResult) -> Val:
        k = r.kind
        if k == "temp_buffer":
            return Val("buffer", temp=self.temp(r.temp.index))
        if k == "temp_float":
            return self.float_map[r.temp.index]
        if k == "literal_number":
            return self.const_float(r.literal_number.value)
        if k == "literal_boolean":
            arr = np.full((self.p.V, self.scale.K), r.literal_boolean, dtype=bool)
            return Val("bool", arr=arr, scale=self.scale_name)
        if k == "literal_enum_value":
            payload = self.val(r.enum_payload) if r.enum_payload is not None else None
            return Val("enum", enum_label=r.enum_label, enum_payload=payload)
        if k == "literal_curve":
            return Val("curve", index=r.index)
        if k == "literal_track":
            return Val("track", index=r.index)
        if k == "self_param":
            return self.bindings[r.index]
        if k == "track_param":
            tc = self.track_ctx
            assert tc is not None and tc["track_index"] == r.track_index
            return tc["params"][r.param_index]
        raise AssertionError(k)

    def local_arr(self, v: Val) -> np.ndarray:
        """Float/bool Val's [V, K] on THIS env's scale."""
        return self.p.coerce_scale(v, self.scale_name)

    def float_col(self, v: Val) -> tuple:
        """('col', scale, name) device ref for a float Val (lazy column)."""
        assert v.kind == "float", v.kind
        if v.col is None:
            v.col = self.p.fresh_col(self.p.scales[v.scale], v.arr)
        return ("col", v.scale, v.col)

    def buf_ref(self, v: Val) -> tuple:
        if v.kind == "buffer":
            return ("temp", v.temp)
        if v.kind == "float":
            return self.float_col(v)
        raise AssertionError(v.kind)

    # -- instruction generation -----------------------------------------

    def gen(self, instr: Instr):
        op = instr.op
        if op in ("copy_buffer", "float_to_buffer", "cob_to_buffer"):
            if op == "cob_to_buffer":
                v = self.bindings[instr.in_self_param]
            else:
                v = self.val(instr.in_result)
            self.ops.append({"op": "copy", "dest": self.dest(instr.out),
                             "a": self.buf_ref(v)})
            return
        if op in ("arith_float", "arith_float_float"):
            a = self.val(instr.a)
            if instr.b is None:
                arr = self.p.float_arith(instr.arith_op, self.local_arr(a))
            else:
                b = self.val(instr.b)
                arr = self.p.float_arith(
                    instr.arith_op, self.local_arr(a), self.local_arr(b))
            self.float_map[instr.out_float] = Val(
                "float", arr=arr, scale=self.scale_name)
            return
        if op in ("arith_buffer", "arith_float_buffer", "arith_buffer_float",
                  "arith_buffer_buffer"):
            a = self.val(instr.a)
            entry = {"op": "arith", "arith": instr.arith_op,
                     "dest": self.dest(instr.out), "a": self.buf_ref(a)}
            if instr.b is not None:
                entry["b"] = self.buf_ref(self.val(instr.b))
            self.ops.append(entry)
            return
        if op == "call":
            self.gen_call(instr)
            return
        if op == "delay":
            self.gen_delay(instr)
            return
        if op == "track_call":
            self.gen_track_call(instr)
            return
        raise AssertionError(op)

    def gen_call(self, instr: Instr):
        callee_index = self.mr.fields[instr.field_index].module_index
        callee = self.p.c.modules[callee_index]
        args = [self.val(r) for r in instr.args]
        dest = self.dest(instr.out)
        if callee.builtin_name is not None:
            self.gen_builtin(callee.builtin_name, callee, args, dest)
            return
        bindings = dict(enumerate(args))
        sub = self.p.inline_module(callee_index, bindings, self.scale_name,
                                   self.track_ctx)
        self.ops.append({"op": "inline", "sub": sub, "dest": dest})

    # -- builtins --------------------------------------------------------

    def _paint_curve_fn(self, v: Val):
        durations = (self.local_arr(v.enum_payload)
                     if v.enum_payload is not None else None)
        if v.arr is not None:  # varying label (track/exported enum param)
            labels = self.local_arr(v)

            def fn(voice, k):
                label = labels[voice, k]
                if label == "instantaneous":
                    return PaintCurve.instantaneous()
                dur = float(durations[voice, k]) if durations is not None else 0.0
                return PaintCurve(label, dur)

            return fn

        label = v.enum_label

        def fn(voice, k):
            if label == "instantaneous":
                return PaintCurve.instantaneous()
            return PaintCurve(label, float(durations[voice, k]))

        return fn

    def _static_enum(self, v: Val, what: str) -> str:
        """The builtin param sites that require a plan-time-constant label."""
        if v.arr is not None:
            raise PlanError(
                f"{what} cannot vary per note; use a literal enum value "
                "(the Filter/Distortion/Noise type params CAN be note-driven)")
        return v.enum_label

    def _emit_painter(self, site: str, segs: List[list], dest):
        self.p.programs[f"prog_{site}"] = control.painter_program(
            segs, self.scale.timelines[0].total)
        self._painter_op(site, dest)

    def _painter_op(self, site: str, dest):
        self.ops.append({"op": "painter", "prog": f"prog_{site}", "dest": dest,
                         "ambient": self.scale_name})

    def gen_builtin(self, name: str, callee, args: List[Val], dest):
        named = {p.name: v for p, v in zip(callee.params, args)}
        site = self.p.fresh_site(name.lower())
        scale = self.scale
        sr = self.p.sr
        if name == "Envelope":
            attack = self._paint_curve_fn(named["attack"])
            decay = self._paint_curve_fn(named["decay"])
            release = self._paint_curve_fn(named["release"])
            sustain = self.local_arr(named["sustain_volume"])
            note_on = self.local_arr(named["note_on"])

            def env_resolver(v, k):
                return {
                    "attack": attack(v, k), "decay": decay(v, k),
                    "release": release(v, k),
                    "sustain_volume": float(sustain[v, k]),
                    "note_on": bool(note_on[v, k]),
                }

            if self.p.live is not None:
                self.p.live.painter_site(site, self.scale_name, "envelope",
                                         env_resolver)
                self._painter_op(site, dest)
                return
            self.p.programs[f"prog_{site}"] = control.envelope_program(
                scale.timelines, sr, lambda v, k, p: env_resolver(v, k))
            self._painter_op(site, dest)
            return
        if name == "Gate":
            note_on = self.local_arr(named["note_on"])
            if self.p.live is not None:
                self.p.live.painter_site(
                    site, self.scale_name, "gate",
                    lambda v, k: {"note_on": bool(note_on[v, k])})
                self._painter_op(site, dest)
                return
            segs = []
            for v, tl in enumerate(scale.timelines):
                s = [(0, 0.0, 0.0, 0.0, 0.0, control.SHAPE_CONST)]
                for k in range(len(tl.starts)):
                    val = 1.0 if note_on[v, k] else 0.0
                    if s[-1][1] != val:
                        s.append((int(tl.starts[k]), val, 0.0, 0.0, 0.0,
                                  control.SHAPE_CONST))
                segs.append(s)
            self._emit_painter(site, segs, dest)
            return
        if name == "Portamento":
            curve_fn = self._paint_curve_fn(named["curve"])
            goal = self.local_arr(named["goal"])
            note_on = self.local_arr(named["note_on"])
            prev_note_on = self.local_arr(named["prev_note_on"])

            def porta_resolver(v, k):
                return {
                    "curve": curve_fn(v, k), "goal": float(goal[v, k]),
                    "note_on": bool(note_on[v, k]),
                    "prev_note_on": bool(prev_note_on[v, k]),
                }

            if self.p.live is not None:
                self.p.live.painter_site(site, self.scale_name, "portamento",
                                         porta_resolver)
                self._painter_op(site, dest)
                return
            segs = [
                control.compile_portamento(
                    tl, sr, lambda k, p, v=v: porta_resolver(v, k))
                for v, tl in enumerate(scale.timelines)
            ]
            self._emit_painter(site, segs, dest)
            return
        if name == "Curve":
            fn_label = self._static_enum(
                named["function"], "the Curve `function` param")
            curve_def = self.p.c.curves[named["curve"].index]
            points = [(float(cp.t.value), float(cp.value.value))
                      for cp in curve_def.points]
            if self.p.live is not None:
                self.p.live.curve_site(site, self.scale_name, points, fn_label)
                self._painter_op(site, dest)
                return
            segs = [control.compile_curve(tl, points, fn_label, sr)
                    for tl in scale.timelines]
            self._emit_painter(site, segs, dest)
            return
        if name in ("SineOsc", "PulseOsc", "TriSawOsc", "Cycle"):
            freq_name = "speed" if name == "Cycle" else "freq"
            freq = named[freq_name]
            guard = name in ("PulseOsc", "TriSawOsc")
            entry = {"op": "osc", "kind": name, "dest": dest, "site": site,
                     "scale": self.scale_name}
            if name == "SineOsc":
                entry["phase"] = self.buf_ref(named["phase"])
            if name in ("PulseOsc", "TriSawOsc"):
                entry["color"] = self.buf_ref(named["color"])
            if freq.kind == "float":
                if self.p.live is not None:
                    self.p.live.osc_site(site, self.scale_name,
                                         self.local_arr(freq), guard)
                else:
                    plan = oscillators.plan_phase_segments(
                        scale.timelines, None, sr, guard_div8=guard,
                        freqs_override=self.local_arr(freq))
                    for cname, carr in plan.values.items():
                        scale.add_column(f"{site}_{cname}", carr)
                entry["mode"] = "seg"
            else:
                entry["mode"] = "cumsum"
                # buffer-frequency TriSawOsc is the reference's naive
                # controlled path, which has NO bad-frequency guard
                # (TriSawOsc.zig:127-131 TODO); PulseOsc's controlled loop
                # skips out-of-range samples (PulseOsc.zig:134-135)
                entry["guard"] = name == "PulseOsc"
                entry["freq"] = self.buf_ref(freq)
                self.p.state_specs[site] = ("phase",)
            self.ops.append(entry)
            return
        if name == "Filter":
            self.p.state_specs[site] = ("filter",)

            def scalar_or_ref(v):
                # plan-time-constant params become scalars: the dense-cut
                # SVF kernel requires a scalar res, so DSL filters with
                # literal or constant res take it instead of the affine
                # scan. (Batch plans only — the live walks see per-window
                # arrays, whose constancy is not stable across walks.)
                if (self.p.live is None and v.kind == "float"
                        and v.arr is not None and v.arr.size
                        and np.all(v.arr == v.arr.flat[0])):
                    return ("const", float(v.arr.flat[0]))
                return self.buf_ref(v)

            entry = {
                "op": "filter", "dest": dest, "site": site,
                "input": self.buf_ref(named["input"]),
                "cutoff": scalar_or_ref(named["cutoff"]),
                "res": scalar_or_ref(named["res"]),
                "ambient": self.scale_name,
            }
            tv = named["type"]
            if tv.arr is None:
                entry["type"] = tv.enum_label
            else:
                # note-driven filter type: the SVF recurrence is type-
                # independent (Filter.zig:120-147) — only the output mix of
                # (l, b, h) changes, so a varying type lowers to per-segment
                # mix-weight columns plus a bypass mask (bypass copies the
                # input and freezes state, matching the reference's switch).
                labels = self.local_arr(tv)
                mul = np.zeros(labels.shape + (3,), np.float32)
                byp = np.zeros(labels.shape, np.float32)
                known = set(filters.FILTER_MULS)
                bad = {x for x in labels.flat} - known
                if bad:
                    raise PlanError(f"unknown filter type label(s) {sorted(bad)}")
                for lab, muls in filters.FILTER_MULS.items():
                    m = labels == lab
                    if muls is None:  # bypass
                        byp[m] = 1.0
                    else:
                        mul[m] = muls
                sc = self.scale_name
                entry["type"] = "mix"
                entry["muls"] = tuple(
                    self.float_col(Val("float", arr=mul[..., j], scale=sc))
                    for j in range(3))
                entry["bypass"] = self.float_col(Val("float", arr=byp, scale=sc))
            self.ops.append(entry)
            return
        if name == "Noise":
            entry = {"op": "noise", "dest": dest, "site": site}
            cv = named["color"]
            if cv.arr is None:
                entry["color"] = cv.enum_label
            else:  # note-driven color: select white/pink per segment
                sel = (self.local_arr(cv) == "pink").astype(np.float32)
                entry["color"] = "dyn"
                entry["sel"] = self.float_col(
                    Val("float", arr=sel, scale=self.scale_name))
            self.ops.append(entry)
            return
        if name == "Decimator":
            self.p.state_specs[site] = ("decimator",)
            fake_val = named["fake_sample_rate"]
            # fake/sr divided HOST-side: XLA f32 division is 1 ulp off for
            # some rates, which would shift the u32 latch grid (see
            # ops/effects.decimator ratio doc)
            ratio_val = Val(
                "float",
                arr=np.asarray(fake_val.arr, np.float32)
                / np.float32(self.p.sr),
                scale=fake_val.scale)
            self.ops.append({
                "op": "decimator", "dest": dest, "site": site,
                "input": self.buf_ref(named["input"]),
                "fake": self.float_col(fake_val),
                "ratio": self.float_col(ratio_val),
                "ambient": self.scale_name,
            })
            return
        if name == "Distortion":
            entry = {
                "op": "distortion", "dest": dest,
                "input": self.buf_ref(named["input"]),
                "ingain": self.float_col(named["ingain"]),
                "outgain": self.float_col(named["outgain"]),
                "offset": self.float_col(named["offset"]),
            }
            tv = named["type"]
            if tv.arr is None:
                entry["type"] = tv.enum_label
            else:  # note-driven type: select overdrive/clip per segment
                sel = (self.local_arr(tv) == "clip").astype(np.float32)
                entry["type"] = "dyn"
                entry["sel"] = self.float_col(
                    Val("float", arr=sel, scale=self.scale_name))
            self.ops.append(entry)
            return
        bi = getattr(callee, "builtin", None)
        if bi is not None and getattr(bi, "custom", None) is not None:
            # reflection-registered user builtin (builtins.builtin_from_class)
            self.p.state_specs[site] = ("user", bi.custom)
            inputs = {}
            for p, v in zip(callee.params, args):
                kind = p.param_type.kind
                if kind in ("buffer", "constant_or_buffer"):
                    inputs[p.name] = self.buf_ref(v)
                elif kind == "constant":
                    inputs[p.name] = (self.buf_ref(v) if v.kind == "buffer"
                                      else self.float_col(v))
                elif kind == "boolean":
                    arr = self.local_arr(v).astype(np.float32)
                    inputs[p.name] = ("boolcol",) + self.float_col(
                        Val("float", arr=arr, scale=self.scale_name))[1:]
                elif kind == "one_of":
                    inputs[p.name] = ("label", self._static_enum(
                        v, f"user builtin {name} param {p.name!r}"))
                else:
                    raise PlanError(
                        f"user builtin {name}: param {p.name!r} of type "
                        f"{kind!r} is not supported (curve params cannot be "
                        "lowered generically)")
            self.ops.append({"op": "user", "dest": dest, "site": site,
                             "cls": bi.custom, "inputs": inputs,
                             "name": name, "ambient": self.scale_name})
            return
        raise NotImplementedError(f"builtin {name}")

    # -- delay -----------------------------------------------------------

    def gen_delay(self, instr: Instr):
        site = self.p.fresh_site("delay")
        D = self.mr.delays[instr.delay_index]
        self.p.state_specs[site] = ("delay", D)
        fb_temp = self.temp(instr.feedback_temp_buffer_index)
        fb_out = self.temp(instr.feedback_out_temp_buffer_index)
        dest = self.dest(instr.out)
        inner_dest = ("temp", self.p.fresh_temp())
        saved_ops, saved_redirect = self.ops, dict(self.dest_redirect)
        self.ops = []
        self.dest_redirect[dest] = inner_dest
        for sub in instr.instructions:
            self.gen(sub)
        inner_ops = self.ops
        self.ops, self.dest_redirect = saved_ops, saved_redirect
        self.ops.append({
            "op": "delay", "site": site, "D": D, "dest": dest,
            "inner_dest": inner_dest[1], "fb_temp": fb_temp,
            "fb_out_temp": fb_out, "inner": inner_ops,
        })

    # -- track call --------------------------------------------------------

    def gen_track_call(self, instr: Instr):
        site = self.p.fresh_site("track")
        track = self.p.c.tracks[instr.track_index]
        note_values = self.p.c.codegen_result.track_results[
            instr.track_index].note_values
        speed = self.val(instr.speed)
        speed_arr = self.local_arr(speed)

        # does the enclosing module have a note_on param? (the generated-Zig
        # reset hack, codegen_zig.zig:366-378)
        note_on_arr = None
        for i, p in enumerate(self.p.c.modules[self.module_index].params):
            if p.name == "note_on" and i in self.bindings:
                note_on_arr = self.local_arr(self.bindings[i])

        outer = self.scale
        total = outer.timelines[0].total
        if self.p.live is not None:
            inner_tls = self.p.live.track_site(
                site, self.scale_name, track, note_values, speed_arr,
                note_on_arr)
        else:
            inner_tls = [
                _simulate_track(self.p.sr, outer.timelines[v], track, note_values,
                                speed_arr[v],
                                note_on_arr[v] if note_on_arr is not None else None,
                                total)
                for v in range(self.p.V)
            ]
        self.p.scales[site] = _make_scale(site, inner_tls)
        inner_scale = self.p.scales[site]

        params: Dict[int, Val] = {}
        for pi, param in enumerate(track.params):
            pt = param.param_type.kind
            if pt == "boolean":
                arr = _pad_param(inner_tls, inner_scale.K,
                                 lambda pp: bool(pp.get(param.name, False)), dtype=bool)
                params[pi] = Val("bool", arr=arr, scale=site)
            elif pt == "constant":
                arr = _pad_param(inner_tls, inner_scale.K,
                                 lambda pp: F32(pp.get(param.name, 0.0)))
                params[pi] = Val("float", arr=arr, scale=site)
            elif pt == "one_of":
                params[pi] = _enum_param_vals(
                    inner_tls, inner_scale.K,
                    lambda pp, d, n=param.name: pp.get(n, d),
                    param.param_type.enum, site)
            else:
                raise PlanError(
                    f"track param {param.name!r} of type {pt!r} is not "
                    "supported; track params may be boolean, constant, or "
                    "enum typed")
        act = _pad_param(inner_tls, inner_scale.K,
                         lambda pp: F32(pp.get("_active", 0.0)))
        inner_scale.add_column("_track_active", act)

        dest = self.dest(instr.out)
        inner_dest = ("temp", self.p.fresh_temp())
        saved = (self.ops, self.scale_name, self.track_ctx, dict(self.dest_redirect))
        self.ops = []
        self.scale_name = site
        self.track_ctx = {"track_index": instr.track_index, "params": params}
        self.dest_redirect[dest] = inner_dest
        for sub in instr.instructions:
            self.gen(sub)
        inner_ops = self.ops
        self.ops, self.scale_name, self.track_ctx, self.dest_redirect = saved

        self.ops.append({
            "op": "track", "dest": dest, "scale": site,
            "inner_dest": inner_dest[1], "inner": inner_ops,
        })


def _simulate_track(sample_rate, outer_tl: SubvoiceTimeline, track, note_values,
                    speeds, note_on, total) -> SubvoiceTimeline:
    """The generated-Zig track_call protocol on the host
    (codegen_zig.zig:363-394): reset tracker/trigger on (note_on and)
    note_id_changed; per outer paint span (block∩segment), consume with
    sample_rate/speed; trigger splits; inner note_id_changed =
    (outer reset) or inner change. Gaps (no painted note) get _active=0."""
    song = track_note_events(track, note_values)
    tracker = NoteTracker(song)
    trigger = Trigger()
    block = 1024
    segs: List[tuple] = []  # (abs_start, reset_flag, params)

    def emit(abs_start, reset_flag, params):
        if segs and not reset_flag and segs[-1][2] == params:
            return
        segs.append((abs_start, reset_flag, params))

    K = len(outer_tl.starts)
    for k in range(K):
        s = int(outer_tl.starts[k])
        e = int(outer_tl.starts[k + 1]) if k + 1 < K else total
        outer_reset = bool(outer_tl.resets[k])
        if note_on is not None:
            outer_reset = outer_reset and bool(note_on[k])
        speed = float(speeds[k])
        eff_sr = float(F32(F32(sample_rate) / F32(speed)))
        first_span = True
        pos = s
        while pos < e:
            span_end = min(e, (pos // block + 1) * block)
            if first_span and outer_reset:
                tracker.reset()
                trigger.reset()
            n = span_end - pos
            iap = tracker.consume(eff_sr, Span(0, n))
            covered_to = pos
            for r in trigger.iterate(Span(0, n), iap):
                abs_start = pos + r.span.start
                if abs_start > covered_to:
                    emit(covered_to, False, {"_active": 0.0})
                new_note = (first_span and outer_reset) or r.note_id_changed
                emit(abs_start, new_note, dict(r.params))
                covered_to = pos + r.span.end
            if covered_to < span_end:
                emit(covered_to, False, {"_active": 0.0})
            first_span = False
            pos = span_end

    if not segs or segs[0][0] > 0:
        segs.insert(0, (0, False, {"_active": 0.0}))
    starts = np.array([x[0] for x in segs], dtype=np.int64)
    resets = np.array([x[1] for x in segs], dtype=bool)
    params = [x[2] for x in segs]
    return SubvoiceTimeline(starts=starts, resets=resets, params=params, total=total)


# ---------------------------------------------------------------------------
# renderer


class _Renderer:
    def __init__(self, state, prog, ctx, scale_vals=None, temps=None, active=None,
                 painters=None):
        self.state = dict(state)
        self.prog = prog
        self.ctx = ctx
        self.V = prog["active_from"].shape[0]
        self.n = ctx.n
        self.dev = ctx.t_idx.device
        self.zero = torch.zeros((), dtype=torch.float32, device=self.dev)
        if scale_vals is None:
            self.scale_vals = {
                key[len("scale_"):]: eval_chunk(sub, ctx.t_idx)
                for key, sub in prog.items() if key.startswith("scale_")
            }
        else:
            self.scale_vals = scale_vals
        # painter name -> its values [V, n] over this renderer's frames. A
        # chunk's renderer evaluates a painter over the whole chunk, once; a
        # delay's sub-chunk renderer slices its parent's, as it does the
        # scale columns: the tiled program's tiles are the chunk's, so
        # evaluating it at a sub-chunk's frames would read them as tiles of
        # s / nt frames (the JAX package's renderer does that; the oracle
        # does not)
        self.painters = painters if painters is not None else self._chunk_painter
        self._painter_cache: Dict[str, torch.Tensor] = {}
        self.temps: Dict[int, torch.Tensor] = temps if temps is not None else {}
        if active is None:
            self.active = ctx.t_idx[None, :] >= prog["active_from"][:, None]
        else:
            self.active = active

    def _chunk_painter(self, name: str) -> torch.Tensor:
        if name not in self._painter_cache:
            vals = eval_chunk(self.prog[name], self.ctx.t_idx)
            self._painter_cache[name] = control.eval_painter(vals, self.ctx.t_idx)
        return self._painter_cache[name]

    def resolve(self, ref):
        if ref[0] == "const":
            return float(ref[1])
        if ref[0] == "temp":
            return self.temps[ref[1]]
        return self.scale_vals[ref[1]][ref[2]]

    def full(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            return torch.full((self.V, self.n), float(x), dtype=torch.float32,
                              device=self.dev)
        return x.broadcast_to((self.V, self.n))

    def ambient_mask(self, name: str) -> torch.Tensor:
        if name == "note":
            return self.active
        return self.scale_vals[name]["_track_active"] > 0.5

    def where_active(self, mask, value) -> torch.Tensor:
        return torch.where(mask, self.full(value), self.zero)

    def write(self, dest, value):
        kind, idx = dest
        if kind == "temp":
            self.temps[idx] = self.full(value)
        else:
            self.temps[idx] = self.full(self.temps.get(idx, 0.0) + value)

    def run(self, ir) -> torch.Tensor:
        self.exec_ops(ir["ops"])
        return self.full(self.temps.get(ir["out"], 0.0))

    def exec_ops(self, ops):
        for e in ops:
            self.exec_op(e)

    def exec_op(self, e):
        op = e["op"]
        ctx = self.ctx
        if op == "copy":
            self.write(e["dest"], self.resolve(e["a"]))
            return
        if op == "arith":
            a = self.resolve(e["a"])
            if "b" in e:
                b = self.resolve(e["b"])
                value = {
                    "add": lambda: a + b, "sub": lambda: a - b,
                    "mul": lambda: a * b, "div": lambda: a / b,
                    "min": lambda: torch.minimum(a, b),
                    "max": lambda: torch.maximum(a, b),
                    "pow": lambda: torch.pow(a, b),
                }[e["arith"]]()
            else:
                value = {
                    "neg": lambda: -a, "abs": lambda: torch.abs(a),
                    "sin": lambda: torch.sin(a), "cos": lambda: torch.cos(a),
                    "sqrt": lambda: torch.sqrt(a),
                }[e["arith"]]()
            self.write(e["dest"], value)
            return
        if op == "inline":
            self.exec_ops(e["sub"]["ops"])
            self.write(e["dest"], self.temps.get(e["sub"]["out"], 0.0))
            return
        if op == "painter":
            out = self.painters(e["prog"])
            if e["ambient"] != "note":
                out = self.where_active(self.ambient_mask(e["ambient"]), out)
            self.write(e["dest"], out)
            return
        if op == "osc":
            self.exec_osc(e)
            return
        if op == "filter":
            st = self.state[e["site"]]
            # the dense-cut kernel reads x [V, n] contiguous; a sub-chunk of
            # a delay is a strided slice
            x = self.full(self.resolve(e["input"])).contiguous()
            amb = self.ambient_mask(e["ambient"])
            if e["type"] == "mix":
                # note-driven filter type: per-sample (l, b, h) mix weights;
                # bypass samples copy the input and freeze state (the
                # reference's bypass case paints input without touching l/b)
                byp = self.full(self.resolve(e["bypass"])) > 0.5
                muls = tuple(self.full(self.resolve(r)) for r in e["muls"])
                l, b, out = filters.svf_filter(
                    st["l"], st["b"], x, "mix",
                    self.resolve(e["cutoff"]), self.resolve(e["res"]),
                    amb & ~byp, muls=muls)
                out = torch.where(byp & amb, x, out)
            else:
                l, b, out = filters.svf_filter(
                    st["l"], st["b"], x, e["type"],
                    self.resolve(e["cutoff"]), self.resolve(e["res"]), amb)
            self.state[e["site"]] = {"l": l, "b": b}
            self.write(e["dest"], out)
            return
        if op == "noise":
            # the key folds in the first frame of this (sub-)chunk, a host int
            seed = zlib.crc32(e["site"].encode()) & 0x7FFFFFFF
            key = noise_ops.fold_in(noise_ops.prng_key(seed), ctx.t0)
            color = e["color"]
            shape = (self.V, self.n)
            white = pink = None
            if color in ("white", "dyn"):
                white, _ = noise_ops.white_noise(key, shape, self.dev)
            if color in ("pink", "dyn"):
                tape = noise_ops.uniform(key, shape, self.dev)
                reset = (ctx.t_idx % 1024) == 0
                pink, _ = noise_ops.pink_from_tape(
                    tape, reset_mask=reset[None, :].broadcast_to(shape))
            if color == "dyn":  # note-driven color
                sel = self.full(self.resolve(e["sel"])) > 0.5
                out = torch.where(sel, pink, white)
            else:
                out = white if color == "white" else pink
            self.write(e["dest"], out)
            return
        if op == "decimator":
            st = self.state[e["site"]]
            x = self.full(self.resolve(e["input"]))
            cnt, val, out = effects.decimator(
                st["cnt"], st["val"], x, self.resolve(e["fake"]), ctx.sample_rate,
                active=self.ambient_mask(e["ambient"]),
                ratio=self.full(self.resolve(e["ratio"])))
            self.state[e["site"]] = {"cnt": cnt, "val": val}
            self.write(e["dest"], out)
            return
        if op == "distortion":
            x = self.full(self.resolve(e["input"]))
            ig, og, off = (self.resolve(e["ingain"]),
                           self.resolve(e["outgain"]), self.resolve(e["offset"]))
            if e["type"] == "dyn":  # note-driven type
                od = effects.distortion(x, "overdrive", ig, og, off)
                cl = effects.distortion(x, "clip", ig, og, off)
                sel = self.full(self.resolve(e["sel"])) > 0.5
                out = torch.where(sel, cl, od)
            else:
                out = effects.distortion(x, e["type"], ig, og, off)
            self.write(e["dest"], out)
            return
        if op == "user":
            ins = {}
            for k, r in e["inputs"].items():
                if r[0] == "label":
                    ins[k] = r[1]
                elif r[0] == "boolcol":
                    ins[k] = self.full(self.resolve(("col",) + r[1:])) > 0.5
                else:
                    ins[k] = self.full(self.resolve(r))
            st = self.state.get(e["site"], {})
            st2, out = e["cls"].render(st, ins, ctx)
            if e["site"] in self.state:
                self.state[e["site"]] = st2
            self.write(e["dest"], self.where_active(self.ambient_mask(e["ambient"]), out))
            return
        if op == "delay":
            self.exec_delay(e)
            return
        if op == "track":
            self.exec_ops(e["inner"])
            out = self.temps.get(e["inner_dest"], 0.0)
            self.write(e["dest"], self.where_active(self.ambient_mask(e["scale"]), out))
            return
        raise AssertionError(op)

    def exec_osc(self, e):
        ctx = self.ctx
        kind = e["kind"]
        if e["mode"] == "seg":
            vals = self.scale_vals[e["scale"]]
            site = e["site"]
            sub = {"ifreq": vals[f"{site}_ifreq"], "A": vals[f"{site}_A"],
                   "valid": vals[f"{site}_valid"]}
            cnt, ifreq, valid = oscillators.phase_from_chunk(sub, ctx.t_idx)
            valid = valid & self.ambient_mask(e["scale"])
        else:
            freq = self.full(self.resolve(e["freq"]))
            amb = self.ambient_mask(e["scale"])
            if e.get("guard"):
                top = np.float32(ctx.sample_rate) / np.float32(8.0)
                valid = (freq >= 0) & (freq <= float(top)) & amb
            else:
                valid = amb
            ifreq = freq_to_ifreq(freq, ctx.sample_rate)
            ifreq = torch.where(valid, ifreq, torch.zeros_like(ifreq))
            cnt = u32(self.state[e["site"]][..., None] + exclusive_cumsum_u32(ifreq))
            self.state[e["site"]] = u32(cnt[..., -1] + ifreq[..., -1])
        if kind == "SineOsc":
            out = self.where_active(valid, oscillators.sine_wave(
                cnt, self.full(self.resolve(e["phase"]))))
        elif kind == "PulseOsc":
            out = oscillators.pulse_wave(cnt, ifreq, self.resolve(e["color"]), valid)
        elif kind == "TriSawOsc":
            if e["mode"] == "seg":
                # constant frequency: the antialiased farbrausch waveform
                # (TriSawOsc.zig:77-118)
                out = oscillators.trisaw_wave(cnt, ifreq, self.resolve(e["color"]), valid)
            else:
                # buffer frequency: scripts reach TriSawOsc only through
                # cob_to_buffer (codegen.zig:879-884), so the reference
                # always runs the naive controlled path here
                # (TriSawOsc.zig:120-156)
                out = oscillators.trisaw_naive_wave(cnt, self.resolve(e["color"]), valid)
        else:  # Cycle
            out = self.where_active(valid, utof23(cnt))
        self.write(e["dest"], out)

    def exec_delay(self, e):
        """The delay's feedback loop: sub-chunks of s <= D frames in order,
        carrying (the delay line, the inner sites' states), as the JAX
        package's lax.scan over the same sub-chunks does."""
        from ..graph.render import RenderCtx

        D = e["D"]
        n = self.n
        s = n
        while s > D:
            if s % 2:
                raise ValueError(f"chunk {n} not divisible into sub-chunks <= delay {D}")
            s //= 2
        env_temps = {k: v for k, v in self.temps.items() if k != e["inner_dest"]}
        states = {k: self.state[k] for k in _collect_state_sites(e["inner"])
                  if k in self.state}
        buf = self.state[e["site"]]
        pieces = []
        for i in range(n // s):
            sl = slice(i * s, (i + 1) * s)
            act_sl = self.active[:, sl]
            sub_ctx = RenderCtx(self.ctx.sample_rate, self.ctx.t_idx[sl],
                                self.ctx.t0 + i * s, s)
            r = _Renderer(
                states, self.prog, sub_ctx,
                scale_vals={name: {k: v[:, sl] for k, v in cols.items()}
                            for name, cols in self.scale_vals.items()},
                temps={k: v[:, sl] for k, v in env_temps.items()}, active=act_sl,
                painters=lambda name, sl=sl: self.painters(name)[:, sl])
            r.temps[e["fb_temp"]] = buf[..., :s]
            r.temps[e["fb_out_temp"]] = torch.zeros((self.V, s), dtype=torch.float32,
                                                    device=self.dev)
            r.exec_ops(e["inner"])
            # Mask the feedback write AND the body output by the active
            # window: the reference paints nothing before a voice's first
            # impulse (player.zig paintFromImpulses spans start at the
            # first event), so body CONSTANTS must not reach the delay
            # line early (the JAX package's tier-2 fuzz seed 675). Shifting
            # zeros is equivalent to the reference's frozen-before-start
            # line, so windowed writes keep sample parity.
            written = r.where_active(act_sl, r.temps[e["fb_out_temp"]])
            buf = torch.cat([buf[..., s:], written], dim=-1)
            pieces.append(r.where_active(act_sl, r.temps.get(e["inner_dest"], 0.0)))
            states = {k: r.state[k] for k in states}
        self.state[e["site"]] = buf
        self.state.update(states)
        self.write(e["dest"], torch.cat(pieces, dim=-1))


def _collect_state_sites(ops) -> List[str]:
    sites = []
    for e in ops:
        if e["op"] in ("filter", "decimator", "user"):
            sites.append(e["site"])
        if e["op"] == "osc" and e.get("mode") == "cumsum":
            sites.append(e["site"])
        if e["op"] == "delay":
            sites.append(e["site"])
            sites.extend(_collect_state_sites(e["inner"]))
        if e["op"] == "inline":
            sites.extend(_collect_state_sites(e["sub"]["ops"]))
        if e["op"] == "track":
            sites.extend(_collect_state_sites(e["inner"]))
    return sites
