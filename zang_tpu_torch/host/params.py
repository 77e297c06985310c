"""Live parameter protocol: reference-style integer parameters that a
running session can change without recompiling the device step.

The reference host edits `Parameter{desc, num_values, current_value,
favor_low_values}` live with arrow keys and Backspace-randomize
(examples/common.zig:9-14, examples/example.zig:324-392) and rebuilds the
module Params struct from `current_value` on every paint call — so a
change takes effect on the next 1024-sample block. Here the same semantics
split two ways, both without re-jit:

- kind="device": the instrument maps the integer values to a flat f32
  vector on host (`device_params`), which the live session uploads with
  every block's program window (`prog["__params__"]`); render() reads the
  traced vector instead of baked constants. Effect: the next block,
  exactly like the reference.
- kind="plan": values feed host-side planning (envelope durations,
  sustain levels). `apply_plan_params` updates the instrument's mutable
  plan config, which the incremental planners re-read when they paint the
  open segment — so the change also lands on the next block (the open
  envelope segment is recomputed from its start with the new durations;
  the reference instead re-slopes from the current sample — both respond
  within one block, documented deviation).

Instruments opt in by implementing:

    param_specs() -> [ParamSpec]            # all 22 fmsynth params, etc.
    device_params(values) -> np.float32[P]  # if any kind="device" specs
    apply_plan_params(values) -> None       # if any kind="plan" specs

A copy of zang_tpu/host/params.py (the port imports nothing of zang_tpu).
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

__all__ = ["ParamSpec", "ParamStore"]


@dataclass(frozen=True)
class ParamSpec:
    """One live parameter: integer-valued in [0, num_values), mirroring the
    reference Parameter (common.zig:9-14). kind routes the value: "device"
    params ride the per-block program upload; "plan" params feed host-side
    planning (see module docstring)."""

    name: str
    num_values: int
    default: int = 0
    desc: str = ""
    favor_low_values: bool = False
    kind: str = "device"  # "device" | "plan" | "both" (rides the vector
    # AND re-plans — e.g. a mode that gates both a traced select and a
    # host-side goal mapping, MousePMInstrument)

    def clamp(self, value: int) -> int:
        return max(0, min(self.num_values - 1, int(value)))


class ParamStore:
    """Current integer values for one part's ParamSpecs, with the reference
    UI's stepping and randomization rules."""

    def __init__(self, specs: List[ParamSpec]) -> None:
        self.specs = list(specs)
        self.by_name: Dict[str, ParamSpec] = {s.name: s for s in self.specs}
        if len(self.by_name) != len(self.specs):
            raise ValueError("duplicate parameter names")
        self.values: Dict[str, int] = {s.name: s.clamp(s.default)
                                       for s in self.specs}

    def spec(self, name: str) -> ParamSpec:
        try:
            return self.by_name[name]
        except KeyError:
            raise KeyError(
                f"unknown parameter {name!r}; available: "
                f"{[s.name for s in self.specs]}") from None

    def set(self, name: str, value: int) -> int:
        s = self.spec(name)
        self.values[name] = s.clamp(value)
        return self.values[name]

    def step(self, name: str, delta: int) -> int:
        """Arrow-key stepping, clamped (example.zig:324-372)."""
        return self.set(name, self.values[name] + int(delta))

    def randomize(self, rng) -> Dict[str, int]:
        """Backspace-randomize every parameter (example.zig:373-391):
        uniform draw per parameter, squared when favor_low_values."""
        for s in self.specs:
            u = rng.random()
            if s.favor_low_values:
                u = u * u
            self.values[s.name] = min(s.num_values - 1,
                                      int(u * s.num_values))
        return dict(self.values)

    def kinds(self) -> set:
        return {s.kind for s in self.specs}
