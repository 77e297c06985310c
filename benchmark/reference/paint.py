"""Painter stage tables (painter.zig:67-120), frozen for the benchmark from
zang_tpu_torch/ops/control.py's paint_table: the oracle's Envelope reads
them in parity mode.
"""

from functools import lru_cache

import numpy as np

F32 = np.float32

# cap on a single paint table (samples), against absurd durations
MAX_TABLE = 1 << 24


def paint_table(kind: str, duration: float, sample_rate: float, t0: float = 0.0):
    """(t sequence, tp sequence, t_step) for one painter stage."""
    return _paint_table_cached(
        kind,
        int(F32(duration).view(np.uint32)),
        int(F32(sample_rate).view(np.uint32)),
        int(F32(t0).view(np.uint32)),
    )


@lru_cache(maxsize=None)
def _paint_table_cached(kind: str, dur_bits: int, sr_bits: int, t0_bits: int):
    duration = np.uint32(dur_bits).view(np.float32)
    sr = np.uint32(sr_bits).view(np.float32)
    t0 = np.uint32(t0_bits).view(np.float32)
    t_step = F32(F32(1.0) / F32(duration * sr))
    # f32-exact sequential accumulation: t_k = fl(t_{k-1} + t_step) from t0,
    # painted while t < 1 (the crossing sample paints with t = 1). f32
    # accumulation can run slow of the exact count, so the estimate has a
    # margin.
    est = int(np.ceil((1.0 - float(t0)) / max(float(t_step), 1e-30)) * 1.02) + 16
    if est > MAX_TABLE:
        raise ValueError(f"paint table too long ({est} samples)")
    steps = np.full(est + 1, t_step, dtype=np.float32)
    steps[0] = t0
    t = np.cumsum(steps, dtype=np.float32)[1:]  # t after each += t_step
    crossing = int(np.argmax(t >= 1.0))
    if not t[crossing] >= 1.0:
        raise ValueError("paint table estimate too short")
    t = t[: crossing + 1].copy()
    t[-1] = 1.0  # clamp (painter.zig:102-105)
    it = F32(1.0) - t
    if kind == "linear":
        tp = t
    elif kind == "squared":
        tp = F32(1.0) - it * it
    elif kind == "cubed":
        tp = F32(1.0) - it * it * it
    else:
        raise ValueError(kind)
    return np.asarray(t, dtype=np.float32), np.asarray(tp, dtype=np.float32), t_step
