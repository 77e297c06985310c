"""Builtin module/enum registry for zangscript.

The reference builds this via comptime reflection over the Zig module
structs (src/zangscript/builtins.zig); here the same information is
declared explicitly. Param order matches the Zig Params struct field order
(it matters for call-arg positional binding of `sample_rate` threading and
for dump output). Sampler is intentionally absent (builtins.zig:175): its
param types aren't representable in the DSL.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class BuiltinEnumValue:
    label: str
    payload: Optional[str] = None  # None or "f32"


@dataclass(frozen=True)
class BuiltinEnum:
    name: str
    values: Tuple[BuiltinEnumValue, ...]

    def allows(self, label: str, has_float_payload: bool) -> bool:
        for v in self.values:
            if v.label == label:
                return (v.payload == "f32") == has_float_payload
        return False


PAINT_CURVE = BuiltinEnum("PaintCurve", (
    BuiltinEnumValue("instantaneous"),
    BuiltinEnumValue("linear", "f32"),
    BuiltinEnumValue("squared", "f32"),
    BuiltinEnumValue("cubed", "f32"),
))

INTERPOLATION_FUNCTION = BuiltinEnum("InterpolationFunction", (
    BuiltinEnumValue("linear"),
    BuiltinEnumValue("smoothstep"),
))

DISTORTION_TYPE = BuiltinEnum("DistortionType", (
    BuiltinEnumValue("overdrive"),
    BuiltinEnumValue("clip"),
))

FILTER_TYPE = BuiltinEnum("FilterType", (
    BuiltinEnumValue("bypass"),
    BuiltinEnumValue("low_pass"),
    BuiltinEnumValue("band_pass"),
    BuiltinEnumValue("high_pass"),
    BuiltinEnumValue("notch"),
    BuiltinEnumValue("all_pass"),
))

NOISE_COLOR = BuiltinEnum("NoiseColor", (
    BuiltinEnumValue("white"),
    BuiltinEnumValue("pink"),
))


@dataclass(frozen=True)
class ParamType:
    """kind: boolean | buffer | constant | constant_or_buffer | curve | one_of"""

    kind: str
    enum: Optional[BuiltinEnum] = None

    def __str__(self) -> str:
        return self.enum.name if self.kind == "one_of" else self.kind


BOOLEAN = ParamType("boolean")
BUFFER = ParamType("buffer")
CONSTANT = ParamType("constant")
COB = ParamType("constant_or_buffer")
CURVE = ParamType("curve")


def one_of(e: BuiltinEnum) -> ParamType:
    return ParamType("one_of", e)


@dataclass(frozen=True)
class ModuleParam:
    name: str
    param_type: ParamType


@dataclass(frozen=True)
class BuiltinModule:
    name: str
    params: Tuple[ModuleParam, ...]
    num_temps: int = 0
    num_outputs: int = 1
    # reflection-registered user module (tools/zangc/parse_builtins.zig
    # analog): an object with render(state, inputs, ctx) -> (state, out)
    custom: object = None


class Buffer:
    """Annotation marker: a sample-rate f32 signal ([]const f32 analog)."""


class Cob:
    """Annotation marker: zang.ConstantOrBuffer analog."""


_PARAM_TYPE_NAMES = {
    "boolean": BOOLEAN, "buffer": BUFFER, "constant": CONSTANT,
    "cob": COB, "constant_or_buffer": COB, "curve": CURVE,
}


def resolve_param_type(pt) -> ParamType:
    """Python annotation/spec -> ParamType, mirroring the reference's
    comptime Zig-type mapping (builtins.zig:102-114): f32 -> constant,
    bool -> boolean, []const f32 -> buffer, ConstantOrBuffer -> cob."""
    if isinstance(pt, ParamType):
        return pt
    if isinstance(pt, BuiltinEnum):
        return one_of(pt)
    if isinstance(pt, str):
        if pt in _PARAM_TYPE_NAMES:
            return _PARAM_TYPE_NAMES[pt]
        raise TypeError(f"unknown param type name {pt!r} "
                        f"(expected one of {sorted(_PARAM_TYPE_NAMES)})")
    if pt is float:
        return CONSTANT
    if pt is bool:
        return BOOLEAN
    if pt is Buffer:
        return BUFFER
    if pt is Cob:
        return COB
    raise TypeError(f"cannot map {pt!r} to a DSL param type")


def builtin_from_class(cls_or_obj, name: Optional[str] = None) -> BuiltinModule:
    """Register a user Python module as a DSL builtin by reflection — the
    working analog of the reference's (bit-rotted, disabled) parse_builtins
    tool (tools/zangc/parse_builtins.zig; zangc.zig:3,99-100).

    The class/instance must provide:
      PARAMS: [(name, type)] with type a ParamType, BuiltinEnum, python
              float/bool, Buffer/Cob marker, or a type-name string — OR a
              nested `Params` class whose annotations are reflected
              (the comptime-reflection analog). Include a
              ("sample_rate", float) entry to receive the auto-threaded
              sample rate.
      render(state, inputs, ctx) -> (state, out [V, n]):
              inputs maps param name -> [V, n] torch tensor on the
              render's device (f32 for constant/cob/buffer, bool for
              boolean) or a static label string for enum params.
      init_state(num_voices, device) -> dict of tensors (optional;
              default {})
    """
    obj = cls_or_obj() if isinstance(cls_or_obj, type) else cls_or_obj
    cls = type(obj)
    name = name or getattr(cls, "NAME", cls.__name__)
    spec = getattr(cls, "PARAMS", None)
    if spec is None:
        pcls = getattr(cls, "Params", None)
        if pcls is None:
            raise TypeError(
                f"{cls.__name__} must declare PARAMS or a Params class")
        spec = list(getattr(pcls, "__annotations__", {}).items())
    if not callable(getattr(obj, "render", None)):
        raise TypeError(f"{cls.__name__} must define render(state, inputs, ctx)")
    params = tuple(ModuleParam(n, resolve_param_type(t)) for n, t in spec)
    return BuiltinModule(name, params, custom=obj)


def user_package(*modules, name: str = "user", enums=()) -> dict:
    """Build a builtin package from user classes/instances (pass alongside
    compile.builtin_packages() to compile_script(packages=...))."""
    return {
        "name": name,
        "builtins": [
            m if isinstance(m, BuiltinModule) else builtin_from_class(m)
            for m in modules
        ],
        "enums": list(enums),
    }


def _p(name, pt) -> ModuleParam:
    return ModuleParam(name, pt)


BUILTIN_MODULES: List[BuiltinModule] = [
    BuiltinModule("Curve", (
        _p("sample_rate", CONSTANT),
        _p("function", one_of(INTERPOLATION_FUNCTION)),
        _p("curve", CURVE),
    )),
    BuiltinModule("Cycle", (
        _p("sample_rate", CONSTANT),
        _p("speed", COB),
    )),
    BuiltinModule("Decimator", (
        _p("sample_rate", CONSTANT),
        _p("input", BUFFER),
        _p("fake_sample_rate", CONSTANT),
    )),
    BuiltinModule("Distortion", (
        _p("input", BUFFER),
        _p("type", one_of(DISTORTION_TYPE)),
        _p("ingain", CONSTANT),
        _p("outgain", CONSTANT),
        _p("offset", CONSTANT),
    )),
    BuiltinModule("Envelope", (
        _p("sample_rate", CONSTANT),
        _p("attack", one_of(PAINT_CURVE)),
        _p("decay", one_of(PAINT_CURVE)),
        _p("release", one_of(PAINT_CURVE)),
        _p("sustain_volume", CONSTANT),
        _p("note_on", BOOLEAN),
    )),
    BuiltinModule("Filter", (
        _p("input", BUFFER),
        _p("type", one_of(FILTER_TYPE)),
        _p("cutoff", COB),
        _p("res", COB),
    )),
    BuiltinModule("Gate", (
        _p("note_on", BOOLEAN),
    )),
    BuiltinModule("Noise", (
        _p("color", one_of(NOISE_COLOR)),
    )),
    BuiltinModule("Portamento", (
        _p("sample_rate", CONSTANT),
        _p("curve", one_of(PAINT_CURVE)),
        _p("goal", CONSTANT),
        _p("note_on", BOOLEAN),
        _p("prev_note_on", BOOLEAN),
    )),
    BuiltinModule("PulseOsc", (
        _p("sample_rate", CONSTANT),
        _p("freq", COB),
        _p("color", CONSTANT),
    )),
    BuiltinModule("SineOsc", (
        _p("sample_rate", CONSTANT),
        _p("freq", COB),
        _p("phase", COB),
    )),
    BuiltinModule("TriSawOsc", (
        _p("sample_rate", CONSTANT),
        _p("freq", COB),
        _p("color", CONSTANT),
    )),
]

BUILTIN_ENUMS: List[BuiltinEnum] = [
    PAINT_CURVE,
    INTERPOLATION_FUNCTION,
    DISTORTION_TYPE,
    FILTER_TYPE,
    NOISE_COLOR,
]
