"""Distortion and Decimator (port of zang_tpu/ops/effects.py).

Distortion (Distortion.zig): a stateless waveshaper in the reference's
expression order (gain1 = 2^(ingain*8-2); overdrive = outgain / atan(gain1)
* atan(x*gain1 + gain1*offset); clip = outgain * clamp(x*gain1 + offs)).
2^v is taken as JAX lowers jnp.exp2, exp(ln2 * v) in f32: torch.exp2 is one
ulp off XLA's in about half of the arguments, this form in about a tenth
(torch's exp against XLA's), so clip is the JAX package's bits wherever the
two gains agree.

Decimator (Decimator.zig): sample-and-hold at a fake sample rate. The
fractional accumulator is a u32 counter (int64 masked to 32 bits, see
ops/scan.py) whose wrap is the trigger, and the hold is the latch
v_i = trig ? x_i : v_{i-1}, a first-order affine scan.
"""

import numbers
from typing import Optional, Tuple, Union

import numpy as np
import torch

from .scan import U32, affine1_scan, as_f32, exclusive_cumsum_u32, u32

Tensor = torch.Tensor
LN2 = float(np.float32(np.log(2.0)))  # jnp.exp2's f32 constant


def distortion(x: Tensor, kind: str, ingain, outgain, offset) -> Tensor:
    """kind: "overdrive" or "clip". Parameters are numbers or tensors
    broadcastable to x; all arithmetic is f32."""
    ingain, outgain, offset = (as_f32(v, x) for v in (ingain, outgain, offset))
    gain1 = torch.exp((ingain * 8.0 - 2.0) * LN2)
    offs = gain1 * offset
    if kind == "overdrive":
        gain2 = outgain / torch.atan(gain1)
        return gain2 * torch.atan(x * gain1 + offs)
    if kind == "clip":
        return outgain * torch.clamp(x * gain1 + offs, -1.0, 1.0)
    raise ValueError(kind)


def decimator(
    cnt0: Tensor,
    dval0: Tensor,
    x: Tensor,
    fake_sample_rate: Union[Tensor, float],
    sample_rate: float,
    active: Optional[Tensor] = None,
    ratio: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Sample-and-hold rate reduction over x [..., n].

    cnt0: u32 accumulator state [...] (int64; 0xFFFFFFFF at the start, so
    the first sample triggers); dval0: the held value. fake >= sr passes
    through and resets the state; fake <= 0 holds forever (output 0, state
    untouched). fake may be a number or a tensor broadcastable to x (the
    script backend's per-sample table); the carry then takes the regime of
    the chunk's last sample, as the JAX package's does.

    active: bool, broadcastable to x: elsewhere the counter freezes and the
    output is 0. ratio: the f32 fake/sr, broadcastable to x, divided on the
    host by the caller; without it a number fake is divided on the host in
    numpy f32 and a tensor fake on the device (both correctly rounded).
    fake/sr * 2^32 (an exact exponent shift) converts to u32 saturating, as
    XLA's conversion does. Returns (cnt_end, dval_end, out)."""
    sr = np.float32(sample_rate)
    fake = as_f32(fake_sample_rate, x)
    if ratio is None:
        ratio = (np.float32(np.float32(fake_sample_rate) / sr)
                 if isinstance(fake_sample_rate, numbers.Real) else fake / float(sr))
    scaled = as_f32(ratio, x) * 4294967296.0
    icount = torch.clamp(scaled, 0.0, 4294967296.0).to(torch.int64).clamp(max=U32)
    icount = icount.broadcast_to(x.shape)
    if active is not None:
        icount = torch.where(active, icount, torch.zeros_like(icount))
    cnt = u32(cnt0[..., None] + exclusive_cumsum_u32(icount) + icount)
    trig = cnt < icount  # the u32 counter wrapped on this sample
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    held = affine1_scan(torch.where(trig, zero, torch.ones_like(zero)),
                        torch.where(trig, x, zero), dval0)
    passthrough, silent = fake >= float(sr), fake <= 0.0
    out = torch.where(passthrough, x, torch.where(silent, zero, held))
    if active is not None:
        out = torch.where(active, out, zero)
    # the carry takes the regime of the chunk's last sample
    pt_end = passthrough.broadcast_to(x.shape)[..., -1]
    sil_end = silent.broadcast_to(x.shape)[..., -1]
    cnt_end = torch.where(pt_end, torch.full_like(cnt0, U32),
                          torch.where(sil_end, cnt0, cnt[..., -1]))
    dval_end = torch.where(pt_end, torch.zeros_like(dval0),
                           torch.where(sil_end, dval0, held[..., -1]))
    return cnt_end, dval_end, out
