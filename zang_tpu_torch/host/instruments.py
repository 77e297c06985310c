"""The song's instruments (port of zang_tpu/host/instruments.py:80-217).

Same protocol as the JAX package: plan() compiles note timelines into
segment programs on the host (numpy, bit-identical to the JAX plans),
init_state() makes the carried state, render() evaluates one chunk for all
subvoices on the device. Only the tiled chunk format is supported.
"""

from typing import List

import numpy as np
import torch

from ..core.curves import PaintCurve
from ..core.timeline import SubvoiceTimeline, active_from
from ..ops import control, filters, oscillators
from ..ops.segprog import eval_tiled_chunk

F32 = np.float32


def default_freq(p):
    """Default note-frequency accessor (params["freq"], f32)."""
    return F32(p["freq"])


def _plan_envelope(timelines, sample_rate, env_const, prog):
    segs = [
        control.compile_envelope(
            tl, sample_rate,
            lambda k, p: {**env_const, "note_on": bool(p["note_on"])},
        )
        for tl in timelines
    ]
    prog["env"] = control.painter_program(segs, timelines[0].total)
    return prog


def _tiled(chunk_prog, name):
    if not (isinstance(chunk_prog, dict) and "tb" in chunk_prog):
        raise ValueError(f"{name}: only the tiled chunk format is supported")
    return chunk_prog


def _env(prog, ctx):
    return control.eval_painter(eval_tiled_chunk(_tiled(prog["env"], "env"), ctx.t_idx),
                                ctx.t_idx)


class PMOscInstrument:
    """Two-operator phase-mod instrument + ADSR (examples/modules.zig:80-128).

    Modulator and carrier share one phase counter (ratio 1, multiplier 1):
    carrier = sin(t + sin(t))."""

    def __init__(self, release_duration: float, freq_fn=None) -> None:
        self.release_duration = release_duration
        self.freq_fn = freq_fn or default_freq

    def _env_const(self):
        return {
            "attack": PaintCurve.cubed(0.025),
            "decay": PaintCurve.cubed(0.1),
            "release": PaintCurve.cubed(self.release_duration),
            "sustain_volume": 0.5,
        }

    def plan(self, timelines: List[SubvoiceTimeline], sample_rate: float):
        prog = {
            "phase": oscillators.plan_phase_segments(timelines, self.freq_fn, sample_rate),
            "active_from": active_from(timelines),
        }
        return _plan_envelope(timelines, sample_rate, self._env_const(), prog)

    def init_state(self, num_voices: int, device):
        return ()

    def render(self, state, prog, ctx):
        vals = eval_tiled_chunk(_tiled(prog["phase"], "phase"), ctx.t_idx)
        cnt, _, _ = oscillators.phase_from_chunk(vals, ctx.t_idx)
        mod = oscillators.sine_wave(cnt, 0.0)
        car = oscillators.sine_wave(cnt, mod)
        return state, car * _env(prog, ctx)  # env is 0 outside notes


class NiceInstrument:
    """Pulse -> lowpass -> ADSR (examples/modules.zig:189-248).

    color is a scalar or a per-voice [V] array, so the song's two organs
    render as one part. The lowpass runs through filters.svf_filter_table
    (the CUDA kernel for CUDA tensors)."""

    def __init__(self, color, freq_fn=None) -> None:
        self.color = color
        self.freq_fn = freq_fn or default_freq

    def plan(self, timelines, sample_rate):
        phase = oscillators.plan_phase_segments(
            timelines, self.freq_fn, sample_rate, guard_div8=True
        )
        # per-note cutoff = cutoffFromFrequency(freq * 8, sr), f32 on host
        f = F32
        cut = np.zeros_like(phase.values["valid"])
        for v, tl in enumerate(timelines):
            k = len(tl.starts)
            if k:
                freqs = tl.param_f32(self.freq_fn)
                x = f(2.0) * (f(1.0) - np.cos(
                    f(np.pi) * (freqs * f(8.0)) / f(sample_rate), dtype=F32))
                cut[v, :k] = np.sqrt(np.clip(x, f(0.0), f(1.0)), dtype=F32)
                cut[v, k:] = cut[v, k - 1]
        phase.values["cut"] = cut

        prog = {"phase": phase, "active_from": active_from(timelines)}
        return _plan_envelope(timelines, sample_rate, self._env_const(), prog)

    def _env_const(self):
        return {
            "attack": PaintCurve.cubed(0.01),
            "decay": PaintCurve.cubed(0.1),
            "release": PaintCurve.cubed(0.5),
            "sustain_volume": 0.8,
        }

    def init_state(self, num_voices: int, device):
        return {
            "l": torch.zeros((num_voices,), dtype=torch.float32, device=device),
            "b": torch.zeros((num_voices,), dtype=torch.float32, device=device),
        }

    def render(self, state, prog, ctx):
        phase = _tiled(prog["phase"], "phase")
        af = prog["active_from"]
        act = ctx.t_idx[None, :] >= af[:, None]
        vals = eval_tiled_chunk({k: v for k, v in phase.items() if k != "cut"},
                                ctx.t_idx)
        cnt, ifreq, valid = oscillators.phase_from_chunk(vals, ctx.t_idx)
        color = self.color
        if np.ndim(color) == 1:  # per-voice -> broadcast over samples
            color = torch.as_tensor(np.asarray(color, F32), device=cnt.device)[:, None]
        osc = oscillators.pulse_wave(cnt, ifreq, color, valid & act) * 0.5
        l, b, filtered = filters.svf_filter_table(
            state["l"], state["b"], osc.contiguous(), "low_pass",
            phase["tb"], phase["cut"], 0.7, ctx.t0, af,
        )
        return {"l": l, "b": b}, _env(prog, ctx) * filtered
