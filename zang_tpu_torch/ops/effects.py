"""Distortion and Decimator (port of zang_tpu/ops/effects.py, the parts
the sampler config uses).

Distortion (Distortion.zig), the overdrive: a stateless waveshaper in the
reference's expression order (gain1 = 2^(ingain*8-2); out = outgain /
atan(gain1) * atan(x*gain1 + gain1*offset)).

Decimator (Decimator.zig): sample-and-hold at a fake sample rate. The
fractional accumulator is a u32 counter (int64 masked to 32 bits, see
ops/scan.py) whose wrap is the trigger, and the hold is the latch
v_i = trig ? x_i : v_{i-1}, a first-order affine scan.
"""

from typing import Tuple

import numpy as np
import torch

from .scan import U32, affine1_scan, as_f32, exclusive_cumsum_u32, u32

Tensor = torch.Tensor


def distortion(x: Tensor, ingain, outgain, offset) -> Tensor:
    """The overdrive. Parameters are numbers or tensors broadcastable to x;
    all arithmetic is f32."""
    ingain, outgain, offset = (as_f32(v, x) for v in (ingain, outgain, offset))
    gain1 = torch.exp2(ingain * 8.0 - 2.0)
    gain2 = outgain / torch.atan(gain1)
    return gain2 * torch.atan(x * gain1 + gain1 * offset)


def decimator(
    cnt0: Tensor,
    dval0: Tensor,
    x: Tensor,
    fake_sample_rate: float,
    sample_rate: float,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Sample-and-hold rate reduction over x [..., n].

    cnt0: u32 accumulator state [...] (int64; 0xFFFFFFFF at the start, so
    the first sample triggers); dval0: the held value. fake >= sr passes
    through and resets the state; fake <= 0 holds forever (output 0, state
    untouched). The ratio fake/sr is divided on the host in numpy f32
    (correctly rounded), as the JAX package does. Returns (cnt_end,
    dval_end, out)."""
    fake, sr = np.float32(fake_sample_rate), np.float32(sample_rate)
    if fake >= sr:
        return torch.full_like(cnt0, U32), torch.zeros_like(dval0), x
    if fake <= 0.0:
        return cnt0, dval0, torch.zeros_like(x)
    # *2^32 is an exact exponent shift; only the division rounds
    icount = int(np.float32(fake / sr) * np.float32(4294967296.0))
    icount_b = torch.full(x.shape, icount, dtype=torch.int64, device=x.device)
    cnt = u32(cnt0[..., None] + exclusive_cumsum_u32(icount_b) + icount_b)
    trig = cnt < icount_b  # the u32 counter wrapped on this sample
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    held = affine1_scan(torch.where(trig, zero, torch.ones_like(zero)),
                        torch.where(trig, x, zero), dval0)
    return cnt[..., -1], held[..., -1], held
