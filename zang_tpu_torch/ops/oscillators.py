"""Oscillators on u32 phase counters (port of zang_tpu/ops/oscillators.py,
the segment-programmed path the song uses and the per-sample-frequency
oscillators of the examples: sine_osc, trisaw_naive, cycle).

Phase counters are int64 tensors holding u32 values (see ops/scan.py).
plan_phase_segments is the numpy twin of the JAX package's planner.
"""

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..core.timeline import part_columns
from .scan import F32, as_f32, exclusive_cumsum_u32, freq_to_ifreq, ftou32, t_rows, u32, utof23
from .segprog import SegProgram

PI = 3.14159265358979323846  # rounded to f32 where used, as np.float32(PI)
GAIN = 0.7


def plan_phase_segments(timelines, freq_fn, sample_rate: float,
                        guard_div8: bool = False, freqs_override=None) -> SegProgram:
    """Host: note-constant frequencies -> a phase SegProgram, over every
    segment of the part at once.

    Values per segment: ifreq (u32 increment), A = cnt0 - start*ifreq (u32,
    so cnt(t) = A + t*ifreq mod 2^32, bit-identical to per-sample
    accumulation), valid (f32 0/1). freq_fn(note_params) -> frequency
    (core.timeline.PartColumns.param_f32), or freqs_override [V, K] gives
    each segment's frequency (the script backend's note-rate columns).
    guard_div8 applies the pulse validity rule (silent, no phase advance
    outside [0, sr/8] — PulseOsc.zig:82-84). timelines may be the part's
    PartColumns.
    """
    cols = part_columns(timelines)
    if freqs_override is not None:
        freqs = cols.per_segment(np.asarray(freqs_override, dtype=np.float32))
    else:
        freqs = cols.param_f32(freq_fn)
    srbase = np.float32(np.float32(4294967296.0) / np.float32(sample_rate))
    with np.errstate(over="ignore"):
        scaled = srbase * freqs
        mag = np.abs(scaled).astype(np.uint32)
        inc = np.where(scaled >= 0, mag, np.uint32(0) - mag)
        ok = np.ones(len(freqs), dtype=bool)
        if guard_div8:
            ok = (freqs >= 0) & (freqs <= np.float32(sample_rate) / np.float32(8.0))
            inc = np.where(ok, inc, np.uint32(0))
        # exact u32 phase at each segment start: the sum mod 2^32 of the
        # voice's earlier segments' lens * inc (an exclusive prefix sum over
        # the part, less its value at the voice's first segment)
        lens = (cols.ends() - cols.starts).astype(np.uint32)
        adv = lens * inc
        before = np.cumsum(adv, dtype=np.uint32) - adv
        voice_base = np.repeat(before[cols.offsets[:-1][cols.counts > 0]],
                               cols.counts[cols.counts > 0])
        A = (before - voice_base) - cols.starts.astype(np.uint32) * inc
    return SegProgram(starts=cols.padded_starts(),
                      values={"ifreq": cols.pad(inc), "A": cols.pad(A),
                              "valid": cols.pad(ok.astype(np.float32))})


def phase_from_chunk(vals: dict, t_idx: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Device: (cnt, ifreq, valid) per sample from evaluated phase program
    values (ifreq, A as u32-in-int64; valid f32). t_idx: [n] or [V, n]
    frames >= 0 (scan.t_rows)."""
    ifreq = vals["ifreq"]
    cnt = u32(vals["A"] + t_rows(t_idx).to(torch.int64) * ifreq)
    return cnt, ifreq, vals["valid"] > 0.5


def sine_wave(cnt: torch.Tensor, phase: Union[torch.Tensor, float]) -> torch.Tensor:
    """out = sin((t + phase) * pi * 2), t = utof23(cnt) (SineOsc.zig:4-6)."""
    t = utof23(cnt)
    return torch.sin((t + as_f32(phase, t)) * as_f32(PI, t) * 2.0)


def _advance(cnt0: torch.Tensor, ifreq: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample phase counters (exclusive) and the end counter, u32 in
    int64."""
    cnt = u32(cnt0[..., None] + exclusive_cumsum_u32(ifreq))
    return cnt, u32(cnt[..., -1] + ifreq[..., -1])


def _gated_ifreq(freq, sample_rate, active, like):
    ifreq = freq_to_ifreq(as_f32(freq, like), sample_rate)
    if active is not None:
        ifreq = torch.where(active, ifreq, torch.zeros_like(ifreq))
    return ifreq


def sine_osc(cnt0: torch.Tensor, freq: torch.Tensor,
             phase: Union[torch.Tensor, float], sample_rate: float,
             active: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sine oscillator with a per-sample frequency (SineOsc.zig:23-87).
    cnt0: u32 counters [...] (int64); freq: f32 [..., n]. Inactive samples
    do not advance the phase and output 0. Returns (cnt_end, out)."""
    cnt, cnt_end = _advance(cnt0, _gated_ifreq(freq, sample_rate, active, cnt0))
    out = sine_wave(cnt, phase)
    if active is not None:
        out = torch.where(active, out, torch.zeros((), dtype=F32, device=out.device))
    return cnt_end, out


def trisaw_wave(cnt: torch.Tensor, ifreq: torch.Tensor,
                color: Union[torch.Tensor, float],
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Anti-aliased tri/saw values from phase counters (TriSawOsc.zig:92-117),
    f32 in the reference's expression order."""
    brpt = ftou32(torch.clamp(as_f32(color, cnt), 0.0, 1.0))
    col = utof23(brpt)
    gain = as_f32(GAIN, col)
    f = utof23(torch.clamp(ifreq, min=1))
    omf = 1.0 - f
    rcpf = 1.0 / f
    c1 = gain / col
    c2 = -gain / (1.0 - col)
    p = utof23(cnt) - col
    prev = u32(cnt - ifreq) < brpt
    cur = cnt < brpt
    wrapped = cnt < ifreq
    up = c1 * (p + p - f)
    down = c2 * (p + p - f)
    updown = rcpf * (c2 * (p * p) - c1 * ((p - f) * (p - f)))
    downup = -rcpf * (gain + c2 * ((p + omf) * (p + omf)) - c1 * (p * p))
    ududu = -rcpf * (gain + c1 * omf * (p + p + omf))
    dudud = -rcpf * (gain + c2 * omf * (p + p + omf))
    v_nowrap = torch.where(prev, torch.where(cur, up, updown), down)
    v_wrap = torch.where(prev, ududu, torch.where(cur, downup, dudud))
    out = gain + torch.where(wrapped, v_wrap, v_nowrap)
    if valid is not None:
        out = torch.where(valid, out, torch.zeros((), dtype=F32, device=out.device))
    return out


def pulse_wave(cnt: torch.Tensor, ifreq: torch.Tensor,
               color: Union[torch.Tensor, float],
               valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Anti-aliased pulse values from phase counters (PulseOsc.zig:96-113).

    The 3-bit transition state machine reduces to per-sample pure functions:
    prev bit = (cnt - ifreq) < brpt, cur bit = cnt < brpt, wrap = cnt < ifreq
    (unsigned compares on the masked int64 counters)."""
    brpt = ftou32(torch.clamp(as_f32(color, cnt), 0.0, 1.0))
    col = utof23(brpt)
    gain = as_f32(GAIN, col)
    # gdf only matters on transition samples, where ifreq >= 1
    gdf = gain / utof23(torch.clamp(ifreq, min=1))
    cc121 = gdf * 2.0 * (col - 1.0) + gain
    cc212 = gdf * 2.0 * col - gain
    p = utof23(cnt)
    prev = u32(cnt - ifreq) < brpt
    cur = cnt < brpt
    wrapped = cnt < ifreq
    updown = gdf * 2.0 * (col - p) + gain  # 0b010
    downup = gdf * 2.0 * p - gain  # 0b101
    v_nowrap = torch.where(prev, torch.where(cur, gain, updown), -gain)
    v_wrap = torch.where(prev, cc121, torch.where(cur, downup, cc212))
    out = torch.where(wrapped, v_wrap, v_nowrap)
    if valid is not None:
        out = torch.where(valid, out, torch.zeros((), dtype=F32, device=out.device))
    return out


def trisaw_naive_wave(cnt: torch.Tensor, color: Union[torch.Tensor, float],
                      active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Naive tri/saw values from u32 phase counters (TriSawOsc.zig:137-151):
    saw when color < 0.25 or > 0.75, a fixed triangle otherwise (the
    reference's controlled-frequency path reads color this crudely)."""
    t = utof23(cnt)
    color_f = as_f32(color, t)
    saw = t * 2.0 - 1.0
    tri = torch.where(
        t < 0.25, t * 4.0,
        torch.where(t < 0.75, 1.0 - (t - 0.25) * 4.0, (t - 0.75) * 4.0 - 1.0))
    out = as_f32(GAIN, t) * torch.where((color_f < 0.25) | (color_f > 0.75), saw, tri)
    if active is not None:
        out = torch.where(active, out, torch.zeros((), dtype=F32, device=out.device))
    return out


def trisaw_naive(cnt0: torch.Tensor, freq: torch.Tensor,
                 color: Union[torch.Tensor, float], sample_rate: float,
                 active: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Naive tri/saw on a u32 phase with a per-sample frequency, the
    reference's controlled-frequency path (TriSawOsc.zig:120-156). Inactive
    samples do not advance the phase and output 0. Returns (cnt_end, out)."""
    cnt, cnt_end = _advance(cnt0, _gated_ifreq(freq, sample_rate, active, cnt0))
    return cnt_end, trisaw_naive_wave(cnt, color, active)


def cycle(cnt0: torch.Tensor, speed: torch.Tensor, sample_rate: float,
          active: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phasor 0 -> ~1 wrapping (src/modules/Cycle.zig) on a u32 phase.
    Returns (cnt_end, out)."""
    cnt, cnt_end = _advance(cnt0, _gated_ifreq(speed, sample_rate, active, cnt0))
    out = utof23(cnt)
    if active is not None:
        out = torch.where(active, out, torch.zeros((), dtype=F32, device=out.device))
    return cnt_end, out
