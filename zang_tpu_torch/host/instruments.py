"""Device-side instruments (port of zang_tpu/host/instruments.py:
examples/modules.zig's instruments, the mouse-driven PM voice and the FM
synth of example_fmsynth.zig).

Same protocol as the JAX package: plan() compiles note timelines into
segment programs on the host (numpy, bit-identical to the JAX plans),
init_state() makes the carried state, render() evaluates one chunk for all
subvoices on the device, in either chunk format (ops/segprog.py). The live
surface is the JAX package's too: live_planner() (host/liveplan.py, the
incremental planners a LiveSession feeds), and for MousePM and FMSynth
param_specs(), device_params(), apply_plan_params(), controller_specs()
and the "__params__" branch of render(), where the device-kind parameters
arrive as an f32 tensor on the card, a row a voice [V, P].

lane_foldable: render() takes ctx.t_idx as [V, n] rows as well as [n]
(ops/scan.t_rows), so a LiveFleet renders all its lanes of this instrument
as one [L * V, n] pass (serve/live.py).

capturable: render() enqueues device work alone and takes ctx.t0 as an
int32 [1] tensor on the card, so a chunk step of such parts is captured as
a CUDA graph (graph/render.py).
"""

from typing import Dict, List

import numpy as np
import torch

from ..core import twelve_tet
from ..core.curves import PaintCurve
from ..core.timeline import SubvoiceTimeline, active_from, part_columns
from ..ops import control, filters, fm, oscillators
from ..ops.scan import freq_to_ifreq, t_rows, u32
from ..ops.segprog import SegProgram, eval_chunk
from .params import ParamSpec

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


# the same values over a part's columns (core/timeline.PartColumns.param_f32)
default_freq.array_form = lambda cols: cols.column("freq", F32)


def _plan_envelope(timelines, sample_rate, env_const, prog):
    prog["env"] = control.envelope_program(timelines, sample_rate, env_const)
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
    return t_rows(ctx.t_idx) >= prog["active_from"][:, None]


def _phase(prog, ctx):
    return oscillators.phase_from_chunk(eval_chunk(prog["phase"], ctx.t_idx), ctx.t_idx)


def _freq_program(timelines) -> SegProgram:
    """Each voice's note frequency as a SegProgram {"freq"} (padding starts
    at total, repeating the last value)."""
    cols = part_columns(timelines)
    return SegProgram(starts=cols.padded_starts(),
                      values={"freq": cols.pad(cols.param_f32(default_freq))})


def _zeros(num_voices, dtype, device):
    return torch.zeros((num_voices,), dtype=dtype, device=device)


def _live_env_kit(polyphony, sample_rate, freq_fn, env_const,
                  guard_div8=False, extra_fns=None, static=None):
    """LivePlanKit matching the {phase, active_from, env} plan structure
    (host/liveplan.py): O(1) host work an event instead of a full re-plan."""
    from . import liveplan as lp

    def env_fn(k, p, _c=env_const):
        return {**_c, "note_on": bool(p["note_on"])}

    return lp.LivePlanKit(
        {
            "phase": lp.IncPhase(polyphony, sample_rate, freq_fn,
                                 guard_div8=guard_div8, extra_fns=extra_fns),
            "active_from": lp.IncActiveFrom(polyphony),
            "env": lp.IncEnvelope(polyphony, sample_rate, env_fn),
        },
        static=static,
    )


class PMOscInstrument:
    """Two-operator phase-mod instrument + ADSR (examples/modules.zig:80-128).

    Modulator and carrier share one phase counter (ratio 1, multiplier 1):
    carrier = sin(t + sin(t))."""

    def __init__(self, release_duration: float, freq_fn=None) -> None:
        self.release_duration = release_duration
        self.freq_fn = freq_fn or default_freq

    def plan(self, timelines: List[SubvoiceTimeline], sample_rate: float):
        cols = part_columns(timelines)
        prog = {
            "phase": oscillators.plan_phase_segments(cols, self.freq_fn, sample_rate),
            "active_from": active_from(timelines),
        }
        return _plan_envelope(cols, sample_rate, _cubed_adsr(self.release_duration), prog)

    lane_foldable = True
    capturable = True

    def live_planner(self, polyphony: int, sample_rate: float):
        return _live_env_kit(polyphony, sample_rate, self.freq_fn,
                             _cubed_adsr(self.release_duration))

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
        cols = part_columns(timelines)
        phase = oscillators.plan_phase_segments(cols, self.freq_fn, sample_rate,
                                                guard_div8=True)
        # per-note cutoff = cutoffFromFrequency(freq * 8, sr), f32 on host
        f = F32
        freqs = cols.param_f32(self.freq_fn)
        x = f(2.0) * (f(1.0) - np.cos(
            f(np.pi) * (freqs * f(8.0)) / f(sample_rate), dtype=F32))
        phase.values["cut"] = cols.pad(np.sqrt(np.clip(x, f(0.0), f(1.0)), dtype=F32))

        prog = {"phase": phase, "active_from": active_from(timelines)}
        return _plan_envelope(cols, sample_rate, self._env_const(), prog)

    def _env_const(self):
        return {
            "attack": PaintCurve.cubed(0.01),
            "decay": PaintCurve.cubed(0.1),
            "release": PaintCurve.cubed(0.5),
            "sustain_volume": 0.8,
        }

    lane_foldable = True
    capturable = True

    def live_planner(self, polyphony: int, sample_rate: float):
        f = F32

        def cut_fn(p):  # scalar twin of plan()'s vectorized cutoff math
            fr = f(self.freq_fn(p))
            x = f(2.0) * (f(1.0) - np.cos(f(np.pi) * (fr * f(8.0)) / f(sample_rate)))
            return np.sqrt(np.clip(x, f(0.0), f(1.0)))

        return _live_env_kit(polyphony, sample_rate, self.freq_fn,
                             self._env_const(), guard_div8=True,
                             extra_fns={"cut": cut_fn})

    def init_state(self, num_voices: int, device):
        return {"l": _zeros(num_voices, torch.float32, device),
                "b": _zeros(num_voices, torch.float32, device)}

    @staticmethod
    def _t(ctx, voices):
        """The frames of the voices in the slice `voices` (every voice's
        when t_idx is [n])."""
        return ctx.t_idx[voices] if ctx.t_idx.dim() == 2 else ctx.t_idx

    def _osc(self, prog, ctx, voices):
        """The pulse oscillator of the voices in the slice `voices`, [v, n]."""
        t = self._t(ctx, voices)
        vals = eval_chunk({k: v[voices] for k, v in prog["phase"].items() if k != "cut"}, t)
        cnt, ifreq, valid = oscillators.phase_from_chunk(vals, t)
        act = t_rows(t) >= prog["active_from"][voices, None]
        color = self.color
        if np.ndim(color) == 1:  # per-voice -> broadcast over samples
            color = self._device_color(cnt.device)[voices, None]
        return oscillators.pulse_wave(cnt, ifreq, color, valid & act) * 0.5

    def _device_color(self, device):
        """The per-voice color [V] f32 on `device`, copied there once a device
        and kept (a copy a chunk could not be captured: graph/render.py). A
        copy of the instrument given another color array makes its own."""
        cache = self.__dict__.setdefault("_colors", {})
        hit = cache.get(device)
        if hit is None or hit[0] is not self.color:
            hit = cache[device] = (self.color, torch.as_tensor(np.asarray(self.color, F32),
                                                               device=device))
        return hit[1]

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
            t = self._t(ctx, g)
            buf[g] *= control.eval_painter(eval_chunk({k: v[g] for k, v in env.items()}, t), t)
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

    lane_foldable = True

    def live_planner(self, polyphony: int, sample_rate: float):
        from . import liveplan as lp

        return lp.LivePlanKit({
            "phase": lp.IncPhase(polyphony, sample_rate, self.freq_fn, guard_div8=True),
            "active_from": lp.IncActiveFrom(polyphony),
            "gate": lp.IncGate(polyphony),
        })

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
        prog["cutoff"] = self._cutoff(sample_rate)
        return prog

    @staticmethod
    def _cutoff(sample_rate):
        return filters.cutoff_from_frequency(F32(F32(440.0) * F32(twelve_tet.c5)),
                                             sample_rate)

    lane_foldable = True

    def live_planner(self, polyphony: int, sample_rate: float):
        return _live_env_kit(polyphony, sample_rate, self.freq_fn, _cubed_adsr(),
                             guard_div8=True, static={"cutoff": self._cutoff(sample_rate)})

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

    lane_foldable = True

    def init_state(self, num_voices: int, device):
        return ()

    def render(self, state, prog, ctx):
        cnt, ifreq, valid = _phase(prog, ctx)
        osc = oscillators.pulse_wave(cnt, ifreq, 0.3 if self.weird else 0.5,
                                     valid & _active(prog, ctx))
        return state, osc * _env(prog, ctx)


class MousePMInstrument:
    """Keyboard notes plus pointer-driven PM parameters (example_mouse.zig).

    Continuous controllers (LiveSession.push_controller, or the offline
    `controllers` streams {"x": [(frame, value)], "y": ...} baked into the
    plan): each move re-targets a linear 0.1 s glide toward x*4 (the
    modulator ratio; x*880 Hz in absolute mode) and y*2 (the multiplier).
    mode 0: modulator frequency = note frequency * ratio; mode 1: ratio is
    the frequency. `mode` is a live parameter of kind "both": render's
    select rides the per-block device vector, the goal mapping applies to
    later controller paints on the host. On the full re-plan path a mode
    flip remaps the whole controller history, as in the JAX package."""

    lane_foldable = True

    def __init__(self, mode: int = 0, controllers=None) -> None:
        self.cfg = {"mode": int(mode)}
        # the offline default stream, for plan() calls that pass none
        self._controllers = controllers

    # -- live parameter protocol (host/params.py) ---------------------------

    def param_specs(self) -> List[ParamSpec]:
        return [ParamSpec("mode", 2, self.cfg["mode"],
                          "Modulator frequency: 0 relative / 1 absolute",
                          kind="both")]

    def device_params(self, values: Dict[str, int]) -> np.ndarray:
        return np.asarray([float(values["mode"])], np.float32)

    def apply_plan_params(self, values: Dict[str, int]) -> None:
        self.cfg["mode"] = int(values.get("mode", self.cfg["mode"]))

    def controller_specs(self) -> Dict[str, float]:
        """Pointer position in [0,1]^2; centred before the first move."""
        return {"x": 0.5, "y": 0.5}

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

    def plan(self, timelines, sample_rate, controllers=None):
        total = timelines[0].total
        if controllers is None:
            controllers = self._controllers or {
                n: [(0, v)] for n, v in self.controller_specs().items()}
        prog = {"active_from": active_from(timelines)}
        prog["ratio"] = self._controller_program(
            controllers["x"], self._ratio_params, sample_rate, total)
        prog["mult"] = self._controller_program(
            controllers["y"], self._mult_params, sample_rate, total)
        prog["freqs"] = _freq_program(timelines)
        return _plan_envelope(timelines, sample_rate, _cubed_adsr(), prog)

    def live_planner(self, polyphony: int, sample_rate: float):
        from . import liveplan as lp

        env_const = _cubed_adsr()
        return lp.LivePlanKit(
            {
                "active_from": lp.IncActiveFrom(polyphony),
                "env": lp.IncEnvelope(
                    polyphony, sample_rate,
                    lambda k, p: {**env_const, "note_on": bool(p["note_on"])}),
                "freqs": lp.IncValues(polyphony, {"freq": default_freq}),
            },
            controllers={
                "x": {"ratio": lp.IncPortamento(
                    1, sample_rate, lambda k, p: self._ratio_params(p))},
                "y": {"mult": lp.IncPortamento(
                    1, sample_rate, lambda k, p: self._mult_params(p))},
            },
        )

    def init_state(self, num_voices: int, device):
        return {"mod_cnt": _zeros(num_voices, torch.int64, device),
                "car_cnt": _zeros(num_voices, torch.int64, device)}

    def render(self, state, prog, ctx):
        act = _active(prog, ctx)
        ratio = _painter(prog, "ratio", ctx)  # [1, n]
        mult = _painter(prog, "mult", ctx)
        freq = eval_chunk(prog["freqs"], ctx.t_idx)["freq"]
        if "__params__" in prog:
            mode = prog["__params__"][:, 0:1]  # [V, 1]
            # relative: mod freq = note freq * ratio; absolute: ratio IS the
            # frequency (the goal mapping already scaled it by 880)
            base = torch.where(mode > 0.5, torch.ones_like(freq), freq)
        else:
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

# device param vector layout (render() reads prog["__params__"] by column)
_FM_DEV = ("mod_freq_mul", "mod_waveform", "mod_volume", "mod_feedback",
           "mod_tremolo", "mod_vibrato", "car_freq_mul", "car_waveform",
           "car_volume", "car_tremolo", "car_vibrato", "algorithm")


class FMSynthInstrument:
    """2-op FM with the reference example's parameters, offline.

    Constructor args are the raw integer parameter values (the reference's
    Parameter encoding); mod_adr/car_adr pack (attack, decay, sustain,
    release). algorithm 1 = phase modulation, 0 = additive
    (example_fmsynth.zig:295-311). The modulator's feedback (_FEEDBACK[3] =
    pi/4 by default) runs through fm.fm_feedback (the FM feedback CUDA
    kernel for CUDA tensors); the carrier's feedback is a literal 0.0, so it
    stays on the parallel path.

    Live control: param_specs() exposes all 22 parameters. The 12
    device-kind values reach render() as prog["__params__"], an f32 tensor
    [V, 12] on the card (_FM_DEV columns; a row a voice, so a fleet's lanes
    each keep their own): the waveform and algorithm selects are where
    chains, and the modulator's feedback and waveform go to the FM kernel
    by pointer, a value a voice, so a change needs no read back. The
    envelope values are plan-kind: the incremental planners re-read
    self.mod/self.car when painting the open segment."""

    lane_foldable = True

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

    # -- live parameter protocol (host/params.py) ---------------------------

    def param_specs(self) -> List[ParamSpec]:
        """The reference's 22 parameters, in its panel order
        (example_fmsynth.zig:375-398), defaults from this instance's
        constructor values."""
        c = self.cfg

        def p(name, desc, n, fav=False, kind="device"):
            return ParamSpec(name, n, c[name], desc, fav, kind)

        return [
            p("mod_freq_mul", "Modulator frequency multiplier:", 16, True),
            p("mod_waveform", "Modulator waveform:", 4),
            p("mod_volume", "Modulator volume:  ", 64, True),
            p("mod_attack", "Modulator attack:  ", 16, kind="plan"),
            p("mod_decay", "Modulator decay:   ", 16, kind="plan"),
            p("mod_sustain", "Modulator sustain: ", 16, True, kind="plan"),
            p("mod_release", "Modulator release: ", 16, kind="plan"),
            p("mod_tremolo", "Modulator tremolo: ", 2),
            p("mod_vibrato", "Modulator vibrato: ", 2),
            p("mod_feedback", "Modulator feedback:", 8, True),
            p("car_freq_mul", "Carrier frequency multiplier:", 16, True),
            p("car_waveform", "Carrier waveform:", 4),
            p("car_volume", "Carrier volume:  ", 64, True),
            p("car_attack", "Carrier attack:  ", 16, kind="plan"),
            p("car_decay", "Carrier decay:   ", 16, kind="plan"),
            p("car_sustain", "Carrier sustain: ", 16, True, kind="plan"),
            p("car_release", "Carrier release: ", 16, kind="plan"),
            p("car_tremolo", "Carrier tremolo: ", 2),
            p("car_vibrato", "Carrier vibrato: ", 2),
            p("tremolo_depth", "Tremolo depth: ", 2),
            p("vibrato_depth", "Vibrato depth: ", 2),
            p("algorithm", "Algorithm: ", 2),
        ]

    def device_params(self, values: Dict[str, int]) -> np.ndarray:
        """Integer values -> the f32 vector render() unpacks (_FM_DEV
        layout); every index->value table is applied here, on the host."""
        td, vd = values["tremolo_depth"], values["vibrato_depth"]
        out = {
            "mod_freq_mul": _FREQ_MUL[values["mod_freq_mul"]],
            "mod_waveform": float(values["mod_waveform"]),
            "mod_volume": _opl_volume(values["mod_volume"]),
            "mod_feedback": _FEEDBACK[values["mod_feedback"]],
            "mod_tremolo": _tremolo_amount(values["mod_tremolo"], td),
            "mod_vibrato": _vibrato_amount(values["mod_vibrato"], vd),
            "car_freq_mul": _FREQ_MUL[values["car_freq_mul"]],
            "car_waveform": float(values["car_waveform"]),
            "car_volume": _opl_volume(values["car_volume"]),
            "car_tremolo": _tremolo_amount(values["car_tremolo"], td),
            "car_vibrato": _vibrato_amount(values["car_vibrato"], vd),
            "algorithm": float(values["algorithm"]),
        }
        return np.asarray([out[k] for k in _FM_DEV], np.float32)

    def apply_plan_params(self, values: Dict[str, int]) -> None:
        """Adopt the plan-kind values (envelope ADSR) into the config the
        planners read; device-kind values are mirrored too, so an offline
        plan()/render() of this instance matches the live values."""
        self.cfg.update({k: int(v) for k, v in values.items() if k in self.cfg})
        self._apply_cfg()

    def _env(self, timelines, sample_rate, op):
        return control.envelope_program(timelines, sample_rate, self._env_const(op))

    @staticmethod
    def _env_const(op):
        return {"attack": PaintCurve.cubed(op["attack"]),
                "decay": PaintCurve.cubed(op["decay"]),
                "release": PaintCurve.cubed(op["release"]),
                "sustain_volume": op["sustain"]}

    @classmethod
    def _env_params(cls, op, p):
        # reads `op` (self.mod / self.car) at call time: the incremental
        # planners re-invoke this when painting the open segment, which is
        # what makes plan-kind parameter changes land on the next block
        return {**cls._env_const(op), "note_on": bool(p["note_on"])}

    def plan(self, timelines, sample_rate):
        cols = part_columns(timelines)
        return {"active_from": active_from(timelines),
                "mod_env": self._env(cols, sample_rate, self.mod),
                "car_env": self._env(cols, sample_rate, self.car),
                "freqs": _freq_program(cols)}

    def live_planner(self, polyphony: int, sample_rate: float):
        from . import liveplan as lp

        return lp.LivePlanKit({
            "active_from": lp.IncActiveFrom(polyphony),
            "mod_env": lp.IncEnvelope(polyphony, sample_rate,
                                      lambda k, p: self._env_params(self.mod, p)),
            "car_env": lp.IncEnvelope(polyphony, sample_rate,
                                      lambda k, p: self._env_params(self.car, p)),
            "freqs": lp.IncValues(polyphony, {"freq": lambda p: F32(p["freq"])}),
        })

    def init_state(self, num_voices, device):
        return {"mod_cnt": _zeros(num_voices, torch.int64, device),
                "car_cnt": _zeros(num_voices, torch.int64, device),
                "mod_fb1": _zeros(num_voices, torch.float32, device),
                "mod_fb2": _zeros(num_voices, torch.float32, device)}

    @staticmethod
    def _lfo(hz, ctx):
        """A MainModule-level LFO, phase-continuous from each voice's own
        frame 0 (example_fmsynth.zig:437-451): the u32 phase in closed form
        from the absolute frame index. Returns [1, n], or [V, n] for a
        t_idx of rows (a fleet's lanes, each at its own frame)."""
        ifreq = freq_to_ifreq(torch.tensor(hz, dtype=torch.float32,
                                           device=ctx.t_idx.device), ctx.sample_rate)
        return oscillators.sine_wave(u32(ifreq * t_rows(ctx.t_idx).to(torch.int64)), 0.0)

    def render(self, state, prog, ctx):
        act = _active(prog, ctx)
        freq = eval_chunk(prog["freqs"], ctx.t_idx)["freq"]
        f32 = lambda v: float(F32(v))  # noqa: E731 (the JAX package's f32 constants)
        live = "__params__" in prog
        # live: each device-kind value a column [V, 1] of the [V, 12] rows
        P = ({name: prog["__params__"][:, i:i + 1] for i, name in enumerate(_FM_DEV)}
             if live else None)
        if live or any(op["tremolo"] != 0.0 or op["vibrato"] != 0.0
                       for op in (self.mod, self.car)):
            trem_lfo = self._lfo(_TREMOLO_HZ, ctx)
            vib_lfo = self._lfo(_VIBRATO_HZ, ctx)

        def op_freq(op, pre):
            if live:
                f = freq * P[pre + "freq_mul"]
                return f * (vib_lfo * P[pre + "vibrato"] + 1.0)
            f = freq * f32(op["freq_mul"])
            if op["vibrato"] != 0.0:
                f = f * (vib_lfo * f32(op["vibrato"]) + 1.0)
            return f

        def op_gain(sig, op, pre):
            if live:
                sig = sig * P[pre + "volume"]
                return sig * (trem_lfo * P[pre + "tremolo"] + 1.0)
            sig = sig * f32(op["volume"])
            if op["tremolo"] != 0.0:
                sig = sig * (trem_lfo * f32(op["tremolo"]) + 1.0)
            return sig

        if live:  # feedback and waveform a voice, read by the kernel on the card
            m_wave = P["mod_waveform"][:, 0].to(torch.int32)
            m_fb = P["mod_feedback"][:, 0]
        else:
            m_wave, m_fb = self.mod["waveform"], self.mod["feedback"]
        mod_cnt, (fb1, fb2), mod_out = fm.fm_osc(
            state["mod_cnt"], op_freq(self.mod, "mod_"), 0.0, m_wave, m_fb,
            (state["mod_fb1"], state["mod_fb2"]), ctx.sample_rate, act)
        mod_sig = op_gain(mod_out, self.mod, "mod_") * _painter(prog, "mod_env", ctx)
        # the carrier's feedback is 0 in the reference (example_fmsynth.zig:345)
        if live:
            algo = P["algorithm"]
            car_phase = mod_sig * algo  # algorithm 1 = phase modulation
            c_wave = P["car_waveform"][:, 0].to(torch.int32)
        else:
            car_phase = mod_sig if self.algorithm == 1 else 0.0
            c_wave = self.car["waveform"]
        car_cnt, _, car_out = fm.fm_osc(
            state["car_cnt"], op_freq(self.car, "car_"), car_phase, c_wave, 0.0,
            (torch.zeros_like(fb1), torch.zeros_like(fb2)), ctx.sample_rate, act)
        out = op_gain(car_out, self.car, "car_") * _painter(prog, "car_env", ctx)
        if live:
            # algorithm 0 = additive: the (already enveloped) modulator
            # signal adds into the output (example_fmsynth.zig:299-303)
            out = out + mod_sig * (1.0 - algo)
        elif self.algorithm == 0:
            out = out + mod_sig
        return {"mod_cnt": mod_cnt, "car_cnt": car_cnt,
                "mod_fb1": fb1, "mod_fb2": fb2}, out
