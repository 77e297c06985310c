"""OPL-style FM oscillator with output feedback (port of zang_tpu/ops/fm.py,
examples/example_fmsynth.zig:26-88).

The oscillator is shape(sin((t + phase) * 2pi + (prev1 + prev2) * feedback))
with four waveform shapes. With feedback the output feeds back through sin:
a nonlinear per-sample recurrence, so no scan applies.

- feedback a number equal to 0: fully parallel, the phase prefix sum and
  elementwise shaping. No kernel.
- any other feedback, a tensor always (its value lives on the card and is
  not read back; the JAX package takes its parallel path only for a Python
  number, zang_tpu/ops/fm.py:77): fm_feedback. For a CUDA base [V, n] it
  launches the hand-written kernel csrc/fm_feedback.cu (a chain lane a voice walking
  time in order, fed from shared memory by a copy warp; the counterpart of
  zang_tpu/ops/pallas_fm.py), built at first use (ops/_build.py), with no
  fallback; the counter "launch.fm_feedback" (trace.counters()) counts the
  launches. For a CPU tensor, or a base of any other rank, it is
  fm_feedback_ref, the plain sequential loop of zang_tpu/ops/fm.py:99-107.

feedback is a number or an f32 tensor broadcastable to the voices, and
waveform an int or an int32 tensor broadcastable to the voices, as the TPU
kernel takes them, a value a lane (pallas_fm.py:47,93-97): the kernel
reads tensors in device memory, so operator settings that live on the card
are never read back, and a fleet of sessions folded into one voice axis,
each lane with its own waveform, runs in one launch.
"""

import ctypes
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..trace import count
from . import _build
from .oscillators import _advance
from .scan import F32, as_f32, freq_to_ifreq, utof23

Tensor = torch.Tensor
PI = 3.14159265358979323846  # rounded to f32 where used

_C = ctypes.c_void_p


Number = Union[int, float]


def _shape_wave(p: Tensor, waveform: Union[int, Tensor]) -> Tensor:
    """waveform 0: sin, 1: half-rectified, 2: |sin|, 3 (and any other
    value): |sin| where sin(2p) >= 0, else 0 (example_fmsynth.zig:74-79).
    A tensor waveform (any dtype, broadcastable to p) selects per element
    through the where chain of zang_tpu/ops/fm.py:29-44, the same bits."""
    s = torch.sin(p)
    zero = torch.zeros((), dtype=F32, device=p.device)
    if isinstance(waveform, torch.Tensor):
        w = waveform
        return torch.where(
            w == 0, s, torch.where(
                w == 1, torch.maximum(s, zero), torch.where(
                    w == 2, s.abs(),
                    torch.where(torch.sin(p * 2.0) >= 0, s.abs(), zero))))
    if waveform == 0:
        return s
    if waveform == 1:
        return torch.maximum(s, zero)
    if waveform == 2:
        return s.abs()
    return torch.where(torch.sin(p * 2.0) >= 0, s.abs(), zero)


def fm_feedback_ref(base: Tensor, feedback: Union[Number, Tensor],
                    waveform: Union[int, Tensor], fb1: Tensor,
                    fb2: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of fm_feedback, on any device: a Python loop over the
    samples of base [..., n] (phase angles, f32) with the carry (fb1, fb2)
    [...], the previous two outputs. Per sample p = base + (fb1 + fb2) *
    feedback, out = shape(p); feedback is a number or a tensor
    broadcastable to [...], waveform an int, or an integer tensor
    broadcastable to [...] (a waveform a voice). Returns (out [..., n],
    fb1', fb2'): the last two outputs, unmasked."""
    fb = as_f32(feedback, base)
    if isinstance(waveform, torch.Tensor) and waveform.numel() == 1:
        waveform = int(waveform)  # one waveform: read back once
    c1, c2 = fb1, fb2
    out = torch.empty_like(base)
    for i in range(base.shape[-1]):
        s = _shape_wave(base[..., i] + (c1 + c2) * fb, waveform)
        out[..., i] = s
        c1, c2 = s, c1
    return out, c1, c2


def _lib():
    lib = _build.library("fm_feedback")
    fn = lib.zt_fm_feedback
    if fn.argtypes is None:
        fn.argtypes = [_C] * 7 + [ctypes.c_longlong, ctypes.c_float, _C,
                                  ctypes.c_longlong] + [ctypes.c_int] * 3 + [_C]
        fn.restype = ctypes.c_int
    return lib


def fm_feedback_cuda(base: Tensor, feedback: Union[Number, Tensor],
                     waveform: Union[int, Tensor], fb1: Tensor,
                     fb2: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The kernel: base f32 [V, n] contiguous on a CUDA device; feedback a
    number (rounded to f32, passed by value) or an f32 tensor on base's
    device broadcastable to [V]; waveform an int (by value) or an int32
    tensor on base's device broadcastable to [V] (a waveform a voice; one
    element is read for all); fb1/fb2 f32 [V]. Any V and any n >= 1.
    Nothing is copied between host and card. Returns (out [V, n], fb1',
    fb2')."""
    dev = base.device
    if dev.type != "cuda":
        raise ValueError(f"fm_feedback_cuda needs CUDA tensors, got base on {dev}")
    if base.dim() != 2 or base.dtype != torch.float32 or not base.is_contiguous():
        raise ValueError(f"base must be a contiguous f32 [V, n], got {base.dtype} "
                         f"{tuple(base.shape)}")
    V, n = base.shape
    if n < 1:
        raise ValueError("base has no samples")
    for name, t in (("fb1", fb1), ("fb2", fb2)):
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != (V,) \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous f32 [{V}] on {dev}")
    fbp, fb_stride, fb = None, 0, 0.0
    if isinstance(feedback, torch.Tensor):
        if feedback.device != dev or feedback.dtype != torch.float32:
            raise ValueError(f"feedback must be f32 on {dev}, got {feedback.dtype} on "
                             f"{feedback.device}")
        fbp = feedback.broadcast_to((V,))
        if V > 1 and fbp.stride(0) not in (0, 1):
            fbp = fbp.contiguous()
        fb_stride = fbp.stride(0) if V > 1 else 0
    else:
        fb = float(np.float32(feedback))
    wp, w_stride, w = None, 0, 0
    if isinstance(waveform, torch.Tensor):
        if waveform.device != dev or waveform.dtype != torch.int32:
            raise ValueError(f"waveform must be int32 on {dev}, got {waveform.dtype} on "
                             f"{waveform.device}")
        wp = waveform.reshape(()) if waveform.numel() == 1 else waveform.broadcast_to((V,))
        if wp.dim() and V > 1 and wp.stride(0) not in (0, 1):
            wp = wp.contiguous()
        w_stride = wp.stride(0) if wp.dim() and V > 1 else 0
    else:
        w = int(waveform)
    out = torch.empty((V, n), dtype=torch.float32, device=dev)
    f1 = torch.empty((V,), dtype=torch.float32, device=dev)
    f2 = torch.empty((V,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().zt_fm_feedback(base.data_ptr(), fb1.data_ptr(), fb2.data_ptr(),
                                    out.data_ptr(), f1.data_ptr(), f2.data_ptr(),
                                    None if fbp is None else fbp.data_ptr(), fb_stride, fb,
                                    None if wp is None else wp.data_ptr(), w_stride, w, V, n,
                                    stream)
    if err != 0:
        raise RuntimeError(f"fm_feedback kernel launch failed: cudaError_t {err}")
    count("launch.fm_feedback")
    return out, f1, f2


def fm_feedback(base: Tensor, feedback: Union[Number, Tensor], waveform: Union[int, Tensor],
                fb1: Tensor, fb2: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The feedback recurrence (see fm_feedback_ref): the CUDA kernel for a
    CUDA base [V, n], else the plain version."""
    if base.device.type == "cuda" and base.dim() == 2:
        return fm_feedback_cuda(base, feedback, waveform, fb1, fb2)
    return fm_feedback_ref(base, feedback, waveform, fb1, fb2)


def fm_osc(
    cnt0: Tensor,
    freq: Tensor,
    phase: Union[Tensor, float],
    waveform: Union[int, Tensor],
    feedback: Union[Number, Tensor],
    fb_state: Tuple[Tensor, Tensor],
    sample_rate: float,
    active: Optional[Tensor] = None,
) -> Tuple[Tensor, Tuple[Tensor, Tensor], Tensor]:
    """Returns (cnt_end, (fb1, fb2), out [..., n]).

    cnt0: u32 counters [...] (int64); freq: f32 [..., n]; phase:
    broadcastable; waveform: an int, or an integer tensor broadcastable to
    [...] (a waveform a voice); feedback: a number (0 takes the parallel
    path) or an f32 tensor broadcastable to [...] (always the recurrence);
    fb_state: the previous two output samples [...]. Inactive samples do
    not advance the phase and output 0; they still step the feedback
    recurrence (base is constant there)."""
    ifreq = freq_to_ifreq(as_f32(freq, cnt0), sample_rate)
    if active is not None:
        ifreq = torch.where(active, ifreq, torch.zeros_like(ifreq))
    cnt, cnt_end = _advance(cnt0, ifreq)
    t = utof23(cnt)
    base = (t + as_f32(phase, t)) * as_f32(PI, t) * 2.0
    fb1, fb2 = fb_state
    zero = torch.zeros((), dtype=F32, device=base.device)
    if not isinstance(feedback, torch.Tensor) and feedback == 0.0:
        w = waveform[..., None] if isinstance(waveform, torch.Tensor) and waveform.dim() \
            else waveform
        out = _shape_wave(base, w)
        if active is not None:
            out = torch.where(active, out, zero)
        new_fb2 = out[..., -2] if out.shape[-1] >= 2 else fb1
        return cnt_end, (out[..., -1], new_fb2), out
    out, f1, f2 = fm_feedback(base.contiguous(), feedback, waveform, fb1, fb2)
    if active is not None:
        out = torch.where(active, out, zero)
    return cnt_end, (f1, f2), out
