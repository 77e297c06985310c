"""Fidelity metric: deviation between two renders in dBFS (numpy twin of
zang_tpu/graph/fidelity.py, whose package imports jax).

  rms_dbfs:  20*log10(rms(a - b))   — the headline metric (< -90 target)
  peak_dbfs: 20*log10(max|a - b|)   — worst single sample
"""

import numpy as np


def _to_float(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x)
    if x.dtype == np.int16:
        return x.astype(np.float64) / 32767.0
    if x.dtype == np.int8:
        return x.astype(np.float64) / 127.0
    return x.astype(np.float64)


def deviation_dbfs(a: np.ndarray, b: np.ndarray):
    """Returns (rms_dbfs, peak_dbfs) of a - b, relative to full scale."""
    fa, fb = _to_float(a), _to_float(b)
    if fa.shape != fb.shape:
        raise ValueError(f"shapes differ: {fa.shape} vs {fb.shape}")
    d = fa - fb
    rms = np.sqrt(np.mean(d * d))
    peak = np.max(np.abs(d)) if d.size else 0.0
    floor = 1e-12
    return (
        20.0 * np.log10(max(rms, floor)),
        20.0 * np.log10(max(peak, floor)),
    )
