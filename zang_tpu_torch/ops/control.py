"""Painter envelopes as segment programs (port of zang_tpu/ops/control.py,
the envelope path the song uses).

Per segment, value[t] = a + b * shape(min(t0 + (dt + 1) * t_step, 1)),
dt = t - start. The segments come from the C++ envelope compiler in
core/native.py; painter_program is the numpy twin of the
JAX package's packer.
"""

import numpy as np
import torch

from ..core import native
from .segprog import SegProgram

SHAPE_CONST, SHAPE_LINEAR, SHAPE_SQUARED, SHAPE_CUBED, SHAPE_SMOOTHSTEP = 0, 1, 2, 3, 4


def compile_envelope(tl, sample_rate: float, env_params_fn) -> dict:
    """One subvoice's envelope segments, from the native compiler.

    env_params_fn(segment_index, note_params) -> dict with attack, decay,
    release (PaintCurve), sustain_volume, note_on. Raises if the native
    compiler cannot be built."""
    return native.compile_envelope_native(tl, sample_rate, env_params_fn)


def painter_program(segs_per_voice, total: int) -> SegProgram:
    """Pack per-voice painter segments (dicts of arrays {"start", "a", "b",
    "t_step", "t0", "shape"}) into a padded SegProgram."""
    S = max(1, max(len(sv["start"]) for sv in segs_per_voice))
    V = len(segs_per_voice)
    starts = np.full((V, S), total, dtype=np.int64)
    a = np.zeros((V, S), dtype=np.float32)
    b = np.zeros((V, S), dtype=np.float32)
    t_step = np.zeros((V, S), dtype=np.float32)
    t0 = np.zeros((V, S), dtype=np.float32)
    shape = np.zeros((V, S), dtype=np.int32)
    for v, segs in enumerate(segs_per_voice):
        k = len(segs["start"])
        starts[v, :k] = segs["start"]
        a[v, :k] = segs["a"]
        b[v, :k] = segs["b"]
        t_step[v, :k] = segs["t_step"]
        t0[v, :k] = segs["t0"]
        shape[v, :k] = segs["shape"]
        # repeat the last segment's values into padding (zero deltas)
        if k:
            a[v, k:] = a[v, k - 1]
            b[v, k:] = b[v, k - 1]
            t_step[v, k:] = t_step[v, k - 1]
            t0[v, k:] = t0[v, k - 1]
            shape[v, k:] = shape[v, k - 1]
    return SegProgram(
        starts=starts,
        values={
            "a": a, "b": b, "t_step": t_step, "t0": t0,
            "shape": shape, "seg_start": starts.astype(np.int32),
        },
    )


def eval_painter(vals: dict, t_idx: torch.Tensor) -> torch.Tensor:
    """Device: evaluated painter program values (a, b, t_step, t0, shape,
    seg_start, each [V, n]) -> [V, n]."""
    dt = (t_idx[None, :] - vals["seg_start"]).to(torch.float32)
    t = torch.clamp(vals["t0"] + (dt + 1.0) * vals["t_step"], max=1.0)
    it = 1.0 - t
    shape = vals["shape"]
    one = torch.ones((), dtype=torch.float32, device=t.device)
    tp = torch.where(
        shape == SHAPE_LINEAR,
        t,
        torch.where(
            shape == SHAPE_SQUARED,
            1.0 - it * it,
            torch.where(
                shape == SHAPE_CUBED,
                1.0 - it * it * it,
                torch.where(shape == SHAPE_SMOOTHSTEP, t * t * (3.0 - 2.0 * t), one),
            ),
        ),
    )
    return vals["a"] + vals["b"] * tp
