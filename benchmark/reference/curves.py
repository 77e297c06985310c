"""Curve/paint-curve value types shared by modules and the script language.

Reference: src/zang/curve.zig:3-6 (CurveNode), src/zang/painter.zig:28-34
(PaintCurve). These are host-side descriptions; the device consumes tables
compiled from them (see ops/control.py).

A copy of zang_tpu/core/curves.py: the port keeps its own host core and imports
nothing of zang_tpu.

Frozen for the benchmark from zang_tpu_torch/core/curves.py: only the imports differ,
so the reference imports nothing of the port.
"""

from dataclasses import dataclass
from typing import Literal


@dataclass(frozen=True)
class CurveNode:
    """A point on a curve: value reached at time t (seconds)."""

    value: float
    t: float


@dataclass(frozen=True)
class PaintCurve:
    """How a Painter approaches a goal value.

    kind 'instantaneous' jumps; 'linear'/'squared'/'cubed' ease over
    `duration` seconds with shape t, 1-(1-t)^2, 1-(1-t)^3 respectively
    (reference: src/zang/painter.zig:96-116).
    """

    kind: Literal["instantaneous", "linear", "squared", "cubed"]
    duration: float = 0.0

    def __post_init__(self):
        if self.kind != "instantaneous" and not self.duration > 0.0:
            raise ValueError(f"PaintCurve {self.kind} needs duration > 0")

    @staticmethod
    def instantaneous() -> "PaintCurve":
        return PaintCurve("instantaneous")

    @staticmethod
    def linear(duration: float) -> "PaintCurve":
        return PaintCurve("linear", duration)

    @staticmethod
    def squared(duration: float) -> "PaintCurve":
        return PaintCurve("squared", duration)

    @staticmethod
    def cubed(duration: float) -> "PaintCurve":
        return PaintCurve("cubed", duration)
