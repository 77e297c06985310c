"""Device-side instruments (port of zang_tpu/host/instruments.py, the
offline parts: examples/modules.zig's instruments, the mouse-driven PM
voice and the FM synth of example_fmsynth.zig).

Same protocol as the JAX package: plan() compiles note timelines into
segment programs on the host (numpy, bit-identical to the JAX plans),
init_state() makes the carried state, render() evaluates one chunk for all
subvoices on the device, in either chunk format (ops/segprog.py). The live
parameter surface (param_specs, device_params, live_planner, the
"__params__" vector) is not ported.
"""

from typing import List

import numpy as np
import torch

from ..core import twelve_tet
from ..core.curves import PaintCurve
from ..core.timeline import SubvoiceTimeline, active_from
from ..ops import control, filters, fm, oscillators
from ..ops.scan import freq_to_ifreq, u32
from ..ops.segprog import SegProgram, eval_chunk

F32 = np.float32

# NiceInstrument's oscillator and envelope math holds about a dozen [V, n]
# tensors at a time, half of them int64: ~6 MiB a voice at 65536 frames. It
# runs over groups of this many voice-samples (2048 voices a 65536-frame
# chunk), so 16384 voices fit an 80 GB card (13.6 GiB at the peak, the
# 4 GiB buffer of all voices included).
GROUP_VOICE_SAMPLES = 2048 * 65536


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


def _cubed_adsr(release: float = 1.0) -> dict:
    """The ADSR most of the examples' voices share (examples/modules.zig):
    cubed 25 ms attack and 0.1 s decay, sustain 0.5, a cubed release."""
    return {"attack": PaintCurve.cubed(0.025), "decay": PaintCurve.cubed(0.1),
            "release": PaintCurve.cubed(release), "sustain_volume": 0.5}


def _painter(prog, name, ctx):
    return control.eval_painter(eval_chunk(prog[name], ctx.t_idx), ctx.t_idx)


def _env(prog, ctx):
    return _painter(prog, "env", ctx)


def _active(prog, ctx):
    return ctx.t_idx[None, :] >= prog["active_from"][:, None]


def _phase(prog, ctx):
    return oscillators.phase_from_chunk(eval_chunk(prog["phase"], ctx.t_idx), ctx.t_idx)


def _freq_program(timelines) -> SegProgram:
    """Each voice's note frequency as a SegProgram {"freq"} (padding starts
    at total, repeating the last value)."""
    total = timelines[0].total
    freq = np.zeros((len(timelines), max(1, max(len(t.starts) for t in timelines))),
                    dtype=np.float32)
    starts = np.full_like(freq, total, dtype=np.int64)
    for v, tl in enumerate(timelines):
        k = len(tl.starts)
        if k:
            freq[v, :k] = tl.param_f32(default_freq)
            freq[v, k:] = freq[v, k - 1]
            starts[v, :k] = tl.starts
    return SegProgram(starts=starts, values={"freq": freq})


def _zeros(num_voices, dtype, device):
    return torch.zeros((num_voices,), dtype=dtype, device=device)


class PMOscInstrument:
    """Two-operator phase-mod instrument + ADSR (examples/modules.zig:80-128).

    Modulator and carrier share one phase counter (ratio 1, multiplier 1):
    carrier = sin(t + sin(t))."""

    def __init__(self, release_duration: float, freq_fn=None) -> None:
        self.release_duration = release_duration
        self.freq_fn = freq_fn or default_freq

    def plan(self, timelines: List[SubvoiceTimeline], sample_rate: float):
        prog = {
            "phase": oscillators.plan_phase_segments(timelines, self.freq_fn, sample_rate),
            "active_from": active_from(timelines),
        }
        return _plan_envelope(timelines, sample_rate,
                              _cubed_adsr(self.release_duration), prog)

    def init_state(self, num_voices: int, device):
        return ()

    def render(self, state, prog, ctx):
        cnt, _, _ = _phase(prog, ctx)
        mod = oscillators.sine_wave(cnt, 0.0)
        car = oscillators.sine_wave(cnt, mod)
        return state, car * _env(prog, ctx)  # env is 0 outside notes


class NiceInstrument:
    """Pulse -> lowpass -> ADSR (examples/modules.zig:189-248).

    color is a scalar or a per-voice [V] array, so the song's two organs
    render as one part. In the tiled chunk format the lowpass takes the
    cutoff as per-tile tables through filters.svf_filter_table; in the flat
    format as a dense [V, n] cutoff with the activity mask through
    filters.svf_filter, as the JAX package does (the CUDA kernels for CUDA
    tensors)."""

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
        return {"l": _zeros(num_voices, torch.float32, device),
                "b": _zeros(num_voices, torch.float32, device)}

    def _osc(self, prog, ctx, voices):
        """The pulse oscillator of the voices in the slice `voices`, [v, n]."""
        vals = eval_chunk({k: v[voices] for k, v in prog["phase"].items() if k != "cut"},
                          ctx.t_idx)
        cnt, ifreq, valid = oscillators.phase_from_chunk(vals, ctx.t_idx)
        act = ctx.t_idx[None, :] >= prog["active_from"][voices, None]
        color = self.color
        if np.ndim(color) == 1:  # per-voice -> broadcast over samples
            color = torch.as_tensor(np.asarray(color, F32)[voices],
                                    device=cnt.device)[:, None]
        return oscillators.pulse_wave(cnt, ifreq, color, valid & act) * 0.5

    def render(self, state, prog, ctx):
        phase = prog["phase"]
        af = prog["active_from"]
        V = af.shape[0]
        # the oscillator and the envelope by groups of voices (one group
        # unless V is large), the filter in one call at the full V. The
        # renderer sums [V, n] over voices as ever, so the grouping does not
        # touch the order of that sum.
        group = max(1, GROUP_VOICE_SAMPLES // ctx.n)
        groups = [slice(g, min(g + group, V)) for g in range(0, V, group)]
        if len(groups) == 1:
            buf = self._osc(prog, ctx, groups[0]).contiguous()
        else:
            buf = torch.empty((V, ctx.n), dtype=torch.float32, device=ctx.t_idx.device)
            for g in groups:
                buf[g] = self._osc(prog, ctx, g)
        if "tb" in phase:
            l, b, buf = filters.svf_filter_table(
                state["l"], state["b"], buf, "low_pass", phase["tb"], phase["cut"], 0.7,
                ctx.t0, af, donate_x=True,
            )
        else:  # flat: the cutoff evaluated alone gives the same bits per name
            cut = eval_chunk({"starts": phase["starts"], "cut": phase["cut"]},
                             ctx.t_idx)["cut"]
            l, b, buf = filters.svf_filter(state["l"], state["b"], buf, "low_pass", cut,
                                           0.7, _active(prog, ctx))
        env = prog["env"]
        for g in groups:
            buf[g] *= _env({"env": {k: v[g] for k, v in env.items()}}, ctx)
        return {"l": l, "b": b}, buf


class HardSquareInstrument:
    """Pulse gated hard on/off (examples/modules.zig:250-289)."""

    def __init__(self, freq_fn=None) -> None:
        self.freq_fn = freq_fn or default_freq

    def plan(self, timelines, sample_rate):
        return {
            "phase": oscillators.plan_phase_segments(
                timelines, self.freq_fn, sample_rate, guard_div8=True),
            "active_from": active_from(timelines),
            "gate": control.painter_program(
                [control.compile_gate(tl) for tl in timelines], timelines[0].total),
        }

    def init_state(self, num_voices: int, device):
        return ()

    def render(self, state, prog, ctx):
        cnt, ifreq, valid = _phase(prog, ctx)
        osc = oscillators.pulse_wave(cnt, ifreq, 0.5, valid & _active(prog, ctx))
        return state, osc * _painter(prog, "gate", ctx)


class FilteredSawtoothInstrument:
    """TriSaw * 1.5 -> ADSR multiply -> lowpass (examples/modules.zig:130-187).
    The lowpass runs through filters.svf_filter with a scalar cutoff (the
    dense-cut CUDA kernel for CUDA tensors)."""

    def __init__(self, freq_fn=None) -> None:
        self.freq_fn = freq_fn or default_freq

    def plan(self, timelines, sample_rate):
        prog = {
            "phase": oscillators.plan_phase_segments(
                timelines, self.freq_fn, sample_rate, guard_div8=True),
            "active_from": active_from(timelines),
        }
        _plan_envelope(timelines, sample_rate, _cubed_adsr(), prog)
        prog["cutoff"] = filters.cutoff_from_frequency(
            F32(F32(440.0) * F32(twelve_tet.c5)), sample_rate)
        return prog

    def init_state(self, num_voices: int, device):
        return {"l": _zeros(num_voices, torch.float32, device),
                "b": _zeros(num_voices, torch.float32, device)}

    def render(self, state, prog, ctx):
        act = _active(prog, ctx)
        cnt, ifreq, valid = _phase(prog, ctx)
        osc = oscillators.trisaw_wave(cnt, ifreq, 0.0, valid & act) * 1.5
        pre = osc * _env(prog, ctx)
        l, b, out = filters.svf_filter(state["l"], state["b"], pre, "low_pass",
                                       prog["cutoff"], 0.7, act)
        return {"l": l, "b": b}, out


class SquareWithEnvelope:
    """Pulse x ADSR (examples/modules.zig:291-337), with linear curves for
    the reference's bare durations, as the JAX package reads them; `weird`
    picks pulse color 0.3 instead of 0.5 (modules.zig:324)."""

    def __init__(self, weird: bool = False, freq_fn=None) -> None:
        self.weird = weird
        self.freq_fn = freq_fn or default_freq

    def plan(self, timelines, sample_rate):
        prog = {
            "phase": oscillators.plan_phase_segments(
                timelines, self.freq_fn, sample_rate, guard_div8=True),
            "active_from": active_from(timelines),
        }
        env_const = {
            "attack": PaintCurve.linear(0.01),
            "decay": PaintCurve.linear(0.1),
            "release": PaintCurve.linear(0.5),
            "sustain_volume": 0.5,
        }
        return _plan_envelope(timelines, sample_rate, env_const, prog)

    def init_state(self, num_voices: int, device):
        return ()

    def render(self, state, prog, ctx):
        cnt, ifreq, valid = _phase(prog, ctx)
        osc = oscillators.pulse_wave(cnt, ifreq, 0.3 if self.weird else 0.5,
                                     valid & _active(prog, ctx))
        return state, osc * _env(prog, ctx)


class MousePMInstrument:
    """Keyboard notes plus pointer-driven PM parameters (example_mouse.zig),
    offline: the controller streams ({"x": [(frame, value)], "y": ...}) are
    baked into the plan. Each move re-targets a linear 0.1 s glide toward
    x*4 (the modulator ratio; x*880 Hz in absolute mode) and y*2 (the
    multiplier). mode 0: modulator frequency = note frequency * ratio; mode
    1: ratio is the frequency."""

    def __init__(self, mode: int = 0, controllers=None) -> None:
        self.cfg = {"mode": int(mode)}
        # without a script the pointer stays centred
        self._controllers = controllers or {"x": [(0, 0.5)], "y": [(0, 0.5)]}

    def _ratio_params(self, p: dict) -> dict:
        v = float(p["value"])
        goal = F32(v * 4.0) if self.cfg["mode"] == 0 else F32(v * 880.0)
        return {"curve": PaintCurve.linear(0.1), "goal": goal,
                "note_on": True, "prev_note_on": True}

    def _mult_params(self, p: dict) -> dict:
        return {"curve": PaintCurve.linear(0.1),
                "goal": F32(float(p["value"]) * 2.0),
                "note_on": True, "prev_note_on": True}

    def _controller_program(self, events, fn, sample_rate, total):
        st = control.PortamentoWalkStream(sample_rate, lambda k, p: fn(p))
        # stable sort by frame only: same-frame moves keep their order
        evs = sorted(events, key=lambda ev: ev[0])
        for i, (s, v) in enumerate(evs):
            e = evs[i + 1][0] if i + 1 < len(evs) else max(total, int(s) + 1)
            st.feed(int(s), int(e), True, {"value": float(v)})
        return control.painter_program([st.segs], total)

    def plan(self, timelines, sample_rate):
        total = timelines[0].total
        prog = {"active_from": active_from(timelines)}
        prog["ratio"] = self._controller_program(
            self._controllers["x"], self._ratio_params, sample_rate, total)
        prog["mult"] = self._controller_program(
            self._controllers["y"], self._mult_params, sample_rate, total)
        prog["freqs"] = _freq_program(timelines)
        return _plan_envelope(timelines, sample_rate, _cubed_adsr(), prog)

    def init_state(self, num_voices: int, device):
        return {"mod_cnt": _zeros(num_voices, torch.int64, device),
                "car_cnt": _zeros(num_voices, torch.int64, device)}

    def render(self, state, prog, ctx):
        act = _active(prog, ctx)
        ratio = _painter(prog, "ratio", ctx)  # [1, n]
        mult = _painter(prog, "mult", ctx)
        freq = eval_chunk(prog["freqs"], ctx.t_idx)["freq"]
        base = torch.ones_like(freq) if self.cfg["mode"] else freq
        mod_cnt, mod_sig = oscillators.sine_osc(
            state["mod_cnt"], base * ratio, 0.0, ctx.sample_rate, act)
        car_cnt, car = oscillators.sine_osc(
            state["car_cnt"], freq, mod_sig * mult, ctx.sample_rate, act)
        return {"mod_cnt": mod_cnt, "car_cnt": car_cnt}, car * _env(prog, ctx)


# ---------------------------------------------------------------------------
# example_fmsynth (examples/example_fmsynth.zig): OPL-style 2-operator FM,
# feedback on the modulator, tremolo/vibrato LFOs.


def _opl_volume(v):
    """OPL volume bits -> linear gain (example_fmsynth.zig:146-156;
    decibels() here is 2^(db/6), the framework's long-standing mapping)."""
    db = 0.0
    for bit, d in ((32, -24.0), (16, -12.0), (8, -6.0), (4, -3.0),
                   (2, -1.5), (1, -0.75)):
        if v & bit:
            db += d
    return float(F32(np.exp2(F32(db / 6.0))))


def _opl_adr(v):
    """Attack/decay/release index -> seconds (example_fmsynth.zig:160-171)."""
    return float(F32(0.002 + 4.0 * (1.0 - v / 15.0) ** 3))


def _opl_sustain(v):
    """Sustain bits -> level (example_fmsynth.zig:163-169)."""
    db = 0.0
    for bit, d in ((8, -24.0), (4, -12.0), (2, -6.0), (1, -3.0)):
        if v & bit:
            db += d
    return float(F32(np.exp2(F32(db / 6.0))))


def _tremolo_amount(flag, depth):
    """Tremolo flag+depth -> modulation amount (example_fmsynth.zig:173-181;
    decibels(db) = 10^(db/20) as in the reference)."""
    if not flag:
        return 0.0
    db = -1.0 if depth == 0 else -4.8
    return float(F32(1.0 - 10.0 ** (db / 20.0)))


def _vibrato_amount(flag, depth):
    """Vibrato flag+depth -> relative frequency swing
    (example_fmsynth.zig:183-191: 2^(cents/1200) - 1)."""
    if not flag:
        return 0.0
    cents = 7.0 if depth == 0 else 14.0
    return float(F32(2.0 ** (cents / 1200.0) - 1.0))


# freq_mul index -> multiplier (example_fmsynth.zig:134-144)
_FREQ_MUL = [0.5] + [float(x) for x in range(1, 11)] + [10.0, 12.0, 12.0, 15.0, 15.0]

# modulator feedback index -> phase offset gain (example_fmsynth.zig:193-203)
_FEEDBACK = [0.0, np.pi / 16, np.pi / 8, np.pi / 4,
             np.pi / 2, np.pi, 2 * np.pi, 4 * np.pi]

# the two MainModule-level LFOs (example_fmsynth.zig:437-451)
_TREMOLO_HZ = 3.7
_VIBRATO_HZ = 6.4


class FMSynthInstrument:
    """2-op FM with the reference example's parameters, offline.

    Constructor args are the raw integer parameter values (the reference's
    Parameter encoding); mod_adr/car_adr pack (attack, decay, sustain,
    release). algorithm 1 = phase modulation, 0 = additive
    (example_fmsynth.zig:295-311). The modulator's feedback (_FEEDBACK[3] =
    pi/4 by default) runs through fm.fm_feedback (the FM feedback CUDA
    kernel for CUDA tensors); the carrier's feedback is a literal 0.0, so it
    stays on the parallel path."""

    def __init__(self, mod_freq_mul=2, mod_waveform=0, mod_volume=12,
                 mod_adr=(8, 8, 8, 8), mod_feedback=3, car_freq_mul=1,
                 car_waveform=0, car_volume=0, car_adr=(8, 8, 8, 8),
                 algorithm=1, mod_tremolo=0, mod_vibrato=0,
                 car_tremolo=0, car_vibrato=0,
                 tremolo_depth=1, vibrato_depth=1):
        self.cfg = dict(
            mod_freq_mul=mod_freq_mul, mod_waveform=mod_waveform,
            mod_volume=mod_volume, mod_attack=mod_adr[0],
            mod_decay=mod_adr[1], mod_sustain=mod_adr[2],
            mod_release=mod_adr[3], mod_tremolo=mod_tremolo,
            mod_vibrato=mod_vibrato, mod_feedback=mod_feedback,
            car_freq_mul=car_freq_mul, car_waveform=car_waveform,
            car_volume=car_volume, car_attack=car_adr[0],
            car_decay=car_adr[1], car_sustain=car_adr[2],
            car_release=car_adr[3], car_tremolo=car_tremolo,
            car_vibrato=car_vibrato, tremolo_depth=tremolo_depth,
            vibrato_depth=vibrato_depth, algorithm=algorithm,
        )
        self._apply_cfg()

    def _apply_cfg(self):
        c = self.cfg
        self.mod = dict(
            freq_mul=_FREQ_MUL[c["mod_freq_mul"]], waveform=c["mod_waveform"],
            volume=_opl_volume(c["mod_volume"]),
            attack=_opl_adr(c["mod_attack"]), decay=_opl_adr(c["mod_decay"]),
            sustain=_opl_sustain(c["mod_sustain"]),
            release=_opl_adr(c["mod_release"]),
            feedback=_FEEDBACK[c["mod_feedback"]],
            tremolo=_tremolo_amount(c["mod_tremolo"], c["tremolo_depth"]),
            vibrato=_vibrato_amount(c["mod_vibrato"], c["vibrato_depth"]),
        )
        self.car = dict(
            freq_mul=_FREQ_MUL[c["car_freq_mul"]], waveform=c["car_waveform"],
            volume=_opl_volume(c["car_volume"]),
            attack=_opl_adr(c["car_attack"]), decay=_opl_adr(c["car_decay"]),
            sustain=_opl_sustain(c["car_sustain"]),
            release=_opl_adr(c["car_release"]), feedback=0.0,
            tremolo=_tremolo_amount(c["car_tremolo"], c["tremolo_depth"]),
            vibrato=_vibrato_amount(c["car_vibrato"], c["vibrato_depth"]),
        )
        self.algorithm = c["algorithm"]

    def _env(self, timelines, sample_rate, op):
        segs = [control.compile_envelope(tl, sample_rate,
                                         lambda k, p: self._env_params(op, p))
                for tl in timelines]
        return control.painter_program(segs, timelines[0].total)

    @staticmethod
    def _env_params(op, p):
        return {"attack": PaintCurve.cubed(op["attack"]),
                "decay": PaintCurve.cubed(op["decay"]),
                "release": PaintCurve.cubed(op["release"]),
                "sustain_volume": op["sustain"],
                "note_on": bool(p["note_on"])}

    def plan(self, timelines, sample_rate):
        return {"active_from": active_from(timelines),
                "mod_env": self._env(timelines, sample_rate, self.mod),
                "car_env": self._env(timelines, sample_rate, self.car),
                "freqs": _freq_program(timelines)}

    def init_state(self, num_voices, device):
        return {"mod_cnt": _zeros(num_voices, torch.int64, device),
                "car_cnt": _zeros(num_voices, torch.int64, device),
                "mod_fb1": _zeros(num_voices, torch.float32, device),
                "mod_fb2": _zeros(num_voices, torch.float32, device)}

    @staticmethod
    def _lfo(hz, ctx):
        """A MainModule-level LFO, phase-continuous from frame 0
        (example_fmsynth.zig:437-451): the u32 phase in closed form from the
        absolute frame index. Returns [n]."""
        ifreq = freq_to_ifreq(torch.tensor(hz, dtype=torch.float32,
                                           device=ctx.t_idx.device), ctx.sample_rate)
        return oscillators.sine_wave(u32(ifreq * ctx.t_idx.to(torch.int64)), 0.0)

    def render(self, state, prog, ctx):
        act = _active(prog, ctx)
        freq = eval_chunk(prog["freqs"], ctx.t_idx)["freq"]
        f32 = lambda v: float(F32(v))  # noqa: E731 (the JAX package's f32 constants)
        if any(op["tremolo"] != 0.0 or op["vibrato"] != 0.0
               for op in (self.mod, self.car)):
            trem_lfo = self._lfo(_TREMOLO_HZ, ctx)[None, :]
            vib_lfo = self._lfo(_VIBRATO_HZ, ctx)[None, :]

        def op_freq(op):
            f = freq * f32(op["freq_mul"])
            if op["vibrato"] != 0.0:
                f = f * (vib_lfo * f32(op["vibrato"]) + 1.0)
            return f

        def op_gain(sig, op):
            sig = sig * f32(op["volume"])
            if op["tremolo"] != 0.0:
                sig = sig * (trem_lfo * f32(op["tremolo"]) + 1.0)
            return sig

        mod_cnt, (fb1, fb2), mod_out = fm.fm_osc(
            state["mod_cnt"], op_freq(self.mod), 0.0, self.mod["waveform"],
            self.mod["feedback"], (state["mod_fb1"], state["mod_fb2"]),
            ctx.sample_rate, act)
        mod_sig = op_gain(mod_out, self.mod) * _painter(prog, "mod_env", ctx)
        # the carrier's feedback is 0 in the reference (example_fmsynth.zig:345)
        car_cnt, _, car_out = fm.fm_osc(
            state["car_cnt"], op_freq(self.car),
            mod_sig if self.algorithm == 1 else 0.0, self.car["waveform"], 0.0,
            (torch.zeros_like(fb1), torch.zeros_like(fb2)), ctx.sample_rate, act)
        out = op_gain(car_out, self.car) * _painter(prog, "car_env", ctx)
        if self.algorithm == 0:
            out = out + mod_sig
        return {"mod_cnt": mod_cnt, "car_cnt": car_cnt,
                "mod_fb1": fb1, "mod_fb2": fb2}, out
