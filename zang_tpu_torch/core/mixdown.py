"""Mixdown: f32 mix -> integer PCM with volume, clamping, NaN -> 0
(port of zang_tpu/core/mixdown.py; reference src/zang/mixdown.zig:3-86).

  signed16: v = x * vol * 32767; NaN -> 0; truncate toward zero; clamp to
            [-32767, 32766].
  signed8:  v = x * vol * 127; NaN -> 0; truncate; clamp to [-127, 126].

mixdown_s16 and mixdown_s8 run on the tensor's device; mixdown_s16_np and
mixdown_s8_np are the numpy twins (the JAX module that holds the originals
imports jax). Each pair is bit-identical for f32 inputs.
"""

import numpy as np
import torch


def mixdown_s16_np(mix: np.ndarray, vol: float) -> np.ndarray:
    """f32 [..., n] -> int16 [..., n]."""
    mul = np.float32(vol) * np.float32(32767.0)
    v = mix.astype(np.float32) * mul
    out = np.trunc(v)
    out = np.where(np.isnan(v), np.float32(0.0), out)
    out = np.clip(out, -32767.0, 32766.0)
    return out.astype(np.int16)


def mixdown_s16(mix: torch.Tensor, vol: float) -> torch.Tensor:
    """f32 [..., n] -> int16 [..., n] on mix's device."""
    mul = float(np.float32(vol) * np.float32(32767.0))
    v = mix.to(torch.float32) * mul
    out = torch.trunc(v)
    out = torch.where(torch.isnan(v), torch.zeros_like(out), out)
    out = torch.clamp(out, -32767.0, 32766.0)
    return out.to(torch.int16)


def mixdown_s8_np(mix: np.ndarray, vol: float) -> np.ndarray:
    """f32 [..., n] -> int8 [..., n]."""
    mul = np.float32(vol) * np.float32(127.0)
    v = mix.astype(np.float32) * mul
    out = np.trunc(v)
    out = np.where(np.isnan(v), np.float32(0.0), out)
    out = np.clip(out, -127.0, 126.0)
    return out.astype(np.int8)


def mixdown_s8(mix: torch.Tensor, vol: float) -> torch.Tensor:
    """f32 [..., n] -> int8 [..., n] on mix's device."""
    mul = float(np.float32(vol) * np.float32(127.0))
    v = mix.to(torch.float32) * mul
    out = torch.trunc(v)
    out = torch.where(torch.isnan(v), torch.zeros_like(out), out)
    out = torch.clamp(out, -127.0, 126.0)
    return out.to(torch.int8)
