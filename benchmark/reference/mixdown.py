"""Mixdown to s16 (numpy), frozen for the benchmark from
zang_tpu_torch/core/mixdown.py's mixdown_s16_np (reference
src/zang/mixdown.zig:3-86): v = x * vol * 32767; NaN -> 0; truncate toward
zero; clamp to [-32767, 32766].
"""

import numpy as np


def mixdown_s16_np(mix: np.ndarray, vol: float) -> np.ndarray:
    """f32 [..., n] -> int16 [..., n]."""
    mul = np.float32(vol) * np.float32(32767.0)
    v = mix.astype(np.float32) * mul
    out = np.trunc(v)
    out = np.where(np.isnan(v), np.float32(0.0), out)
    out = np.clip(out, -32767.0, 32766.0)
    return out.astype(np.int16)
