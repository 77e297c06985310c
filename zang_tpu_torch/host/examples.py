"""The reference's example programs as offline render configs (port of
zang_tpu/host/examples.py: all twenty, the eight zangscript ones through
the port's script backend).

Each example (examples/example_*.zig) is a function
`ex_<name>(seconds, device="cuda", backend="torch") -> (audio f32 [C, total]
on device, sample_rate)`; keyboard and mouse input become scripted event
sequences. backend="oracle" renders the example's twin through the port's
reference oracle instead (zang_tpu_torch/oracle: numpy on the host, f32
numpy [C, total]; device is not used), as the JAX package's backend="oracle"
does.
The instruments live in host/instruments.py. On the card the examples reach
every CUDA kernel of the port:

  play         PMOsc melody + FilteredSawtooth drone   dense-cut SVF (K2)
  fmsynth      8-voice 2-op FM, modulator feedback pi/4  FM feedback (K5)
  polyphony    39 Nice voices + decimator               table-cut SVF (K1)
  polyphony2   Nice behind a 3-slot dispatcher          table-cut SVF (K1)
  sampler      drum loop -> overdrive -> decimator      table lookup (K4)
  song         the Bach Toccata, 20 s                   table-cut SVF (K1)
  stereo       two panned noise voices, a [2, 1] cutoff dense-cut SVF (K2)
  detuned      noise-warbled trisaw -> lowpass -> echoes dense-cut SVF (K2),
                                                        twice a chunk
  script       DemoSynth: pulse * envelope through a    dense-cut SVF (K2),
               delay whose feedback is low-passed       once a sub-chunk
  script_runtime  DemoSynth, edited and reloaded         dense-cut SVF (K2)
  arpeggiator, delay, portamento, mouse, envelope,      no kernel
  vibrato, curve, laser, subsong, two (scripts)

Run: python -m zang_tpu_torch.host.examples NAME out.wav [--seconds S]
                                                       [--device cuda]
"""

import argparse
import os
from typing import List, Tuple

import numpy as np
import torch

from ..core import twelve_tet as tt
from ..core.curves import PaintCurve
from ..core.mixdown import mixdown_s16
from ..core.notes import SongEvent
from ..core.timeline import SubvoiceTimeline, active_from, compile_timelines, part_columns
from ..core.wav import write_wav_s16
from ..device import require_device
from ..graph.render import Performance, render_performance
from ..ops import control, effects, filters, noise, oscillators
from ..ops import delay as d_ops
from ..ops.segprog import eval_chunk
from ..oracle import examples as oex
from ..oracle import instruments as oi
from ..oracle.script import render_script_oracle
from ..script import compile_script
from ..script.torch_backend import ScriptInstrument
from . import configs
from . import instruments as ti
from . import song as song_mod

F32 = np.float32
A4 = 440.0
MIX_VOLUME = 0.25

# the render chunk of every example but the song (module-level, as in the
# JAX package, so a test can vary it)
DEFAULT_CHUNK = 16384
# the song's render chunk
SONG_CHUNK = 65536


def _note(params, t, nid):
    return SongEvent(params, t=t, note_id=nid)


def _simple_song(notes: List[Tuple[float, float, float]], extra=None):
    """notes: (t_on, duration, freq). Returns chronological SongEvents."""
    song = []
    for i, (t0, dur, freq) in enumerate(notes):
        p = {"freq": float(F32(freq)), "note_on": True}
        q = {"freq": float(F32(freq)), "note_on": False}
        if extra:
            p.update(extra)
            q.update(extra)
        song.append(_note(p, t0, i + 1))
        song.append(_note(q, t0 + dur, i + 1))
    song.sort(key=lambda e: (e.t, e.note_id))
    return song


BACKENDS = ("torch", "oracle")


def _device(device, backend):
    """The render's device for backend "torch" (raises without CUDA unless
    the caller asks for the CPU: before planning, to fail fast); None for
    the oracle, which runs on the host."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    return require_device(device) if backend == "torch" else None


def _render_script(src, name, song, seconds, device, sr=44100.0, polyphony=1,
                   backend="torch"):
    """A zangscript module as an instrument of `polyphony` voices over `song`."""
    total = int(seconds * sr)
    cs = compile_script(src)
    if backend == "oracle":
        return render_script_oracle(cs, name, song, total, sr, polyphony=polyphony), sr
    inst = ScriptInstrument(cs, name)
    tls = compile_timelines(song, polyphony, sr, total)
    return render_performance(Performance([(inst, tls)], sr), total,
                              chunk_size=DEFAULT_CHUNK, device=device), sr


def _oracle_twin_part(inst, tls):
    """(make_module(v), make_params, num_temps, tls) twin for the standard
    examples/modules.zig instruments (oracle/instruments.py)."""
    if isinstance(inst, ti.PMOscInstrument):
        rd = inst.release_duration
        return (lambda v: oi.PMOscInstrument(rd, mode="parity"), oex.std_params, 3, tls)
    if isinstance(inst, ti.FilteredSawtoothInstrument):
        return (lambda v: oi.FilteredSawtoothInstrument(mode="parity"),
                oex.std_params, 3, tls)
    if isinstance(inst, ti.NiceInstrument):
        color = float(inst.color)
        return (lambda v: oi.NiceInstrument(color, mode="parity"), oex.std_params, 2, tls)
    if isinstance(inst, ti.HardSquareInstrument):
        return (lambda v: oi.HardSquareInstrument(mode="parity"), oex.std_params, 2, tls)
    raise NotImplementedError(type(inst).__name__)


def _render_parts(parts, seconds, sr, device, num_channels=1, post_fn=None,
                  post_init=None, backend="torch", oracle_parts=None, oracle_post=None):
    """The parts [(instrument, timelines)] as a Performance on `device`, or,
    for the oracle, their twins: oracle_parts() (default: each stock
    instrument's twin) summed, then oracle_post() on the mix if given."""
    total = int(seconds * sr)
    if backend == "oracle":
        oparts = (oracle_parts() if oracle_parts is not None
                  else [_oracle_twin_part(inst, tls) for inst, tls in parts])
        post = oracle_post() if oracle_post is not None else None
        return oex.render_parts(oparts, total, sr, num_channels, post), sr
    perf = Performance(parts, sr, num_channels=num_channels, post_fn=post_fn,
                       post_init_state=post_init)
    return render_performance(perf, total, chunk_size=DEFAULT_CHUNK,
                              device=device), sr


# ---------------------------------------------------------------------------
# example_play: PMOsc keyboard voice + filtered-sawtooth drone
# (examples/example_play.zig).


def ex_play(seconds=6.0, device="cuda", backend="torch"):
    dev = _device(device, backend)
    sr = 48000.0
    melody = _simple_song([
        (0.2 + i * 0.45, 0.35, A4 * tt.rel_freq(n))
        for i, n in enumerate([-9, -5, -2, 0, -2, -5, -9, -5, 3, 0, -2, 0])
    ])
    drone = _simple_song([(0.0, seconds - 1.0, A4 * tt.c4 / 4.0)])
    total = int(seconds * sr)
    tls0 = compile_timelines(melody, 1, sr, total)
    tls1 = compile_timelines(drone, 1, sr, total)
    return _render_parts(
        [(ti.PMOscInstrument(1.0), tls0), (ti.FilteredSawtoothInstrument(), tls1)],
        seconds, sr, dev, backend=backend)


# ---------------------------------------------------------------------------
# example_envelope: very slow ADSR made audible (examples/example_envelope.zig:
# pulse(0.5) * env(cubed 1.0 x3, sustain 0.5) * 5.0, c2 note).

ENVELOPE_SCRIPT = """
EnvDemo = defmodule freq: cob, note_on: boolean, begin
    e = Envelope(attack=.cubed(1.0), decay=.cubed(1.0), release=.cubed(1.0),
                 sustain_volume=0.5, note_on) * 5.0
    out PulseOsc(freq, color=0.5) * e
end
"""


def ex_envelope(seconds=8.0, device="cuda", backend="torch"):
    dev = _device(device, backend)
    song = _simple_song([(0.1, 4.0, A4 * tt.c2)])
    return _render_script(ENVELOPE_SCRIPT, "EnvDemo", song, seconds, dev, sr=48000.0,
                          backend=backend)


# ---------------------------------------------------------------------------
# example_vibrato (examples/example_vibrato.zig): pulse at freq*(1+0.02*sin(4Hz)).

VIBRATO_SCRIPT = """
Vib = defmodule freq: cob, note_on: boolean, begin
    f = freq * (1 + 0.02 * SineOsc(freq=4, phase=0))
    out PulseOsc(freq=f, color=0.3) * Gate(note_on)
end
"""


def ex_vibrato(seconds=4.0, device="cuda", backend="torch"):
    dev = _device(device, backend)
    song = _simple_song([(0.1, 1.5, A4 * tt.a3), (2.0, 1.5, A4 * tt.d4)])
    return _render_script(VIBRATO_SCRIPT, "Vib", song, seconds, dev, sr=48000.0,
                          backend=backend)


# ---------------------------------------------------------------------------
# example_curve / example_laser: curve-driven FM (examples/example_curve.zig,
# example_laser.zig:22-42 curves; laser adds random freq_mul per shot).

LASER_SCRIPT = """
Laser = defmodule freq_mul: constant, carrier_mul: constant,
                  modulator_mul: constant, modulator_rad: constant,
                  note_on: boolean, begin
    mod_freq = freq_mul * modulator_mul * Curve(function=.smoothstep, curve=defcurve
        0.0 1000.0
        0.1 200.0
        0.2 100.0
    end)
    car_freq = freq_mul * carrier_mul * Curve(function=.smoothstep, curve=defcurve
        0.0 1000.0
        0.1 200.0
        0.2 100.0
    end)
    m = SineOsc(freq=mod_freq, phase=0) * modulator_rad
    c = SineOsc(freq=car_freq, phase=m)
    vol = Curve(function=.smoothstep, curve=defcurve
        0.0 0.0
        0.004 1.0
        0.2 0.0
    end)
    out c * vol
end
"""


def ex_laser(seconds=3.0, seed=0, device="cuda", backend="torch"):
    dev = _device(device, backend)
    rng = np.random.default_rng(seed)
    song = []
    t = 0.1
    nid = 1
    while t < seconds - 0.3:
        freq_mul = 1.0 + float(rng.random()) * 0.1 - 0.05
        song.append(_note({"freq_mul": freq_mul, "carrier_mul": 2.0,
                           "modulator_mul": 0.5, "modulator_rad": 1.0,
                           "note_on": True}, t, nid))
        song.append(_note({"freq_mul": freq_mul, "carrier_mul": 2.0,
                           "modulator_mul": 0.5, "modulator_rad": 1.0,
                           "note_on": False}, t + 0.25, nid))
        nid += 1
        t += 0.3
    return _render_script(LASER_SCRIPT, "Laser", song, seconds, dev, backend=backend)


def ex_curve(seconds=4.5, device="cuda", backend="torch"):
    dev = _device(device, backend)
    src = """
CurvePlayer = defmodule freq_mul: constant, note_on: boolean, begin
    out SineOsc(
        freq = freq_mul * Curve(curve=defcurve
            0.0  440.0
            0.5  880.0
            1.0  110.0
            1.5  660.0
            2.0  330.0
            3.9   20.0
        end, function=.linear),
        phase = SineOsc(
            freq = freq_mul * Curve(curve=defcurve
                0.0 110.0
                1.5  55.0
                3.0 220.0
            end, function=.smoothstep),
            phase = 0
        )
    )
end
"""
    song = _simple_song([(0.0, 4.0, 0.0)])
    for e in song:
        e.params["freq_mul"] = 1.0
    return _render_script(src, "CurvePlayer", song, seconds, dev, backend=backend)


# ---------------------------------------------------------------------------
# example_subsong (examples/example_subsong.zig): notes within notes — each
# outer key triggers a 5-note inner melody, transposed by the outer freq.

SUBSONG_SCRIPT = f"""
SubtrackPlayer = defmodule freq: cob, note_on: boolean, begin
    base_freq = freq
    out from deftrack f: constant, gate: boolean, begin
        0.0 (f={A4 * tt.c4}, gate=true)
        1.0 (f={A4 * tt.ab3}, gate=true)
        2.0 (f={A4 * tt.g3}, gate=true)
        3.0 (f={A4 * tt.eb3}, gate=true)
        4.0 (f={A4 * tt.c3}, gate=true)
        5.0 (f={A4 * tt.c3}, gate=false)
    end, 1 begin
        e = Envelope(attack=.cubed(0.025), decay=.cubed(0.1),
                     release=.cubed(1.0), sustain_volume=0.5, note_on=gate)
        out SineOsc(freq = f * base_freq / {A4 * tt.c4}, phase=0) * e
    end
end
"""


def ex_subsong(seconds=8.0, device="cuda", backend="torch"):
    dev = _device(device, backend)
    song = _simple_song([(0.0, 5.5, A4 * tt.c4), (6.0, 1.8, A4 * tt.e4)])
    return _render_script(SUBSONG_SCRIPT, "SubtrackPlayer", song, seconds, dev,
                          backend=backend)


# ---------------------------------------------------------------------------
# example_two (examples/example_two.zig): a note plays only while BOTH
# impulse streams are active — host-side span intersection feeding one voice.


def ex_two(seconds=4.0, device="cuda", backend="torch"):
    dev = _device(device, backend)
    sr = 48000.0
    # stream 0: keys (freq); stream 1: color changes; intersect note_on
    s0 = [(0.2, 1.2, A4 * tt.a3), (1.8, 1.8, A4 * tt.c4)]
    s1_on = [(0.5, 2.8)]
    song = []
    nid = 1
    for t0, dur, freq in s0:
        for t1, dur1 in s1_on:
            lo = max(t0, t1)
            hi = min(t0 + dur, t1 + dur1)
            if lo < hi:
                song.append(_note({"freq": freq, "note_on": True}, lo, nid))
                song.append(_note({"freq": freq, "note_on": False}, hi, nid))
                nid += 1
    song.sort(key=lambda e: (e.t, e.note_id))
    src = """
Two = defmodule freq: cob, note_on: boolean, begin
    e = Envelope(attack=.instantaneous, decay=.instantaneous,
                 release=.linear(0.3), sustain_volume=1, note_on)
    out SineOsc(freq, phase=0) * e * 0.5
end
"""
    return _render_script(src, "Two", song, seconds, dev, sr=sr, backend=backend)


# ---------------------------------------------------------------------------
# example_arpeggiator (examples/example_arpeggiator.zig): held chords cycled
# at 30 ms a step; the host generates the arpeggiator's impulse stream.


def ex_arpeggiator(seconds=4.0, device="cuda", backend="torch"):
    dev = _device(device, backend)
    sr = 48000.0
    step = 0.03
    chords = [
        (0.0, 2.0, [0, 4, 7]),        # major triad held
        (2.0, 1.9, [0, 3, 7, 10]),    # minor 7th held
    ]
    song = []
    nid = 1
    t = 0.0
    while t < seconds - step:
        for t0, dur, degs in chords:
            if t0 <= t < t0 + dur:
                deg = degs[int(round(t / step)) % len(degs)]
                f = A4 * tt.rel_freq(deg - 9)
                song.append(_note({"freq": f, "note_on": True}, t, nid))
                song.append(_note({"freq": f, "note_on": False}, t + step, nid))
                nid += 1
                break
        t += step
    song.sort(key=lambda e: (e.t, e.note_id))
    tls = compile_timelines(song, 1, sr, int(seconds * sr))
    return _render_parts([(ti.HardSquareInstrument(), tls)], seconds, sr, dev,
                         backend=backend)


# ---------------------------------------------------------------------------
# example_polyphony (examples/example_polyphony.zig): 39 brute-force voices
# (one a key) + a Decimator bitcrush on the mix.


class DecimatedNice(ti.NiceInstrument):
    """The polyphony example's voice: NiceInstrument(0.3); the decimator is
    the performance's post chain."""

    def __init__(self):
        super().__init__(0.3)


def ex_polyphony(seconds=5.0, device="cuda", backend="torch"):
    dev = _device(device, backend)
    sr = 48000.0
    total = int(seconds * sr)
    tlss = []
    for i in range(12):  # staggered chord roll
        t0 = 0.15 + 0.11 * i
        song = _simple_song([(t0, seconds - t0 - 1.0, A4 * tt.rel_freq(i - 9))])
        tlss.extend(compile_timelines(song, 1, sr, total))
    # pad to 39 voices like the reference's one-voice-per-key array
    while len(tlss) < 39:
        tlss.append(SubvoiceTimeline(
            starts=np.zeros((0,), np.int64), resets=np.zeros((0,), bool),
            params=[], total=total))

    def post_fn(state, mix, ctx):  # the bitcrush at a 6 kHz fake rate
        cnt, val, out = effects.decimator(
            state["cnt"], state["val"], mix[None, :], 6000.0, ctx.sample_rate)
        return {"cnt": cnt, "val": val}, out

    def post_init(device):
        return {"cnt": torch.full((1,), 0xFFFFFFFF, dtype=torch.int64, device=device),
                "val": torch.zeros((1,), dtype=torch.float32, device=device)}

    return _render_parts([(DecimatedNice(), tlss)], seconds, sr, dev,
                         post_fn=post_fn, post_init=post_init, backend=backend,
                         oracle_post=lambda: oex.DecimatorPost(6000.0))


# ---------------------------------------------------------------------------
# example_stereo (examples/example_stereo.zig): two filtered noise voices
# panned by a 0.1 Hz sine; continuous (no notes).

STEREO_SEED = 0xA0D10
DETUNED_SEED = 0xDE7


class StereoNoise:
    """Two lowpassed white-noise voices (320 and 380 Hz), panned 0..0.5 and
    0.5..1 by one 0.1 Hz sine; renders stereo [2, n] itself. The noise tape
    of a chunk is the draw of the key fold_in(PRNGKey(STEREO_SEED), t0), as
    in the JAX package."""

    output_channels = 2

    def plan(self, timelines, sample_rate):
        return {"active_from": active_from(timelines)}

    def init_state(self, num_voices, device):
        return {"pan_cnt": torch.zeros((), dtype=torch.int64, device=device),
                "l0": torch.zeros((2,), dtype=torch.float32, device=device),
                "b0": torch.zeros((2,), dtype=torch.float32, device=device)}

    def render(self, state, prog, ctx):
        sr, dev = ctx.sample_rate, ctx.t_idx.device
        pan_cnt, pan = oscillators.sine_osc(
            state["pan_cnt"], torch.full((ctx.n,), 0.1, dtype=torch.float32, device=dev),
            0.0, sr)
        key = noise.fold_in(noise.prng_key(STEREO_SEED), ctx.t0)
        white, _ = noise.white_noise(key, (2, ctx.n), dev)
        cut = torch.as_tensor(
            np.stack([filters.cutoff_from_frequency(f, sr) for f in (320.0, 380.0)]),
            device=dev)[:, None]
        l, b, filtered = filters.svf_filter(state["l0"], state["b0"], white, "low_pass",
                                            cut, 0.4)
        filtered = filtered * 4.0
        # voice 0 pans 0..0.5, voice 1 pans 0.5..1 (scaleWave)
        panv = torch.stack([pan * 0.25 + 0.25, pan * 0.25 + 0.75])
        out = torch.stack([(filtered * panv).sum(dim=0),
                           (filtered * (1.0 - panv)).sum(dim=0)])
        return {"pan_cnt": pan_cnt, "l0": l, "b0": b}, out


def ex_stereo(seconds=6.0, device="cuda", backend="torch"):
    dev = _device(device, backend)
    sr = 48000.0
    if backend == "oracle":
        return oex.render_stereo_noise(int(seconds * sr), sr, chunk=DEFAULT_CHUNK), sr
    tls = compile_timelines(_simple_song([(0.0, seconds, 1.0)]), 1, sr,
                            int(seconds * sr))
    return _render_parts([(StereoNoise(), tls)], seconds, sr, dev, num_channels=2)


# ---------------------------------------------------------------------------
# example_detuned (examples/example_detuned.zig): slow-filtered noise warble
# modulating a trisaw's frequency; env + lowpass; through StereoEchoes.


class DetunedInstrument:
    """Naive trisaw whose frequency is the note's times a warble multiplier
    exp2(4 * lowpass(white noise, 4 Hz)), then ADSR and a lowpass.

    The multiplier feeds the oscillator's per-sample u32 phase step, so a
    difference in its last place accumulates in the phase over seconds (the
    JAX package's own oracle twin therefore takes the multiplier as a
    shared input trajectory, zang_tpu/oracle/examples.py DetunedTwin).
    warble_mul does the same here: None (the default) makes the multiplier
    from the noise tape of fold_in(PRNGKey(DETUNED_SEED), t0); an f32
    [V, total] array is read instead, a chunk at a time."""

    def __init__(self, warble_mul=None) -> None:
        self.warble_mul = warble_mul

    def plan(self, timelines, sample_rate):
        cols = part_columns(timelines)
        prog = {"active_from": active_from(timelines),
                "phase": oscillators.plan_phase_segments(cols, ti.default_freq, sample_rate,
                                                         guard_div8=True)}
        ti._plan_envelope(cols, sample_rate, ti._cubed_adsr(), prog)
        # per-note freq as a column for the warble multiply
        prog["phase"].values["freq"] = cols.pad(cols.param_f32(ti.default_freq))
        if self.warble_mul is not None:
            prog["warble_mul"] = np.ascontiguousarray(self.warble_mul, F32)
        return prog

    def init_state(self, num_voices, device):
        z = lambda: torch.zeros((num_voices,), dtype=torch.float32, device=device)
        return {"cnt": torch.zeros((num_voices,), dtype=torch.int64, device=device),
                "nl": z(), "nb": z(), "l": z(), "b": z()}

    @staticmethod
    def warble(nl, nb, ctx):
        """One chunk of the multiplier from the carried 4 Hz filter state
        (nl, nb) [V]. Returns (nl', nb', multiplier [V, n])."""
        key = noise.fold_in(noise.prng_key(DETUNED_SEED), ctx.t0)
        white, _ = noise.white_noise(key, (nl.shape[0], ctx.n), ctx.t_idx.device)
        cut = float(filters.cutoff_from_frequency(4.0, ctx.sample_rate))
        nl, nb, w = filters.svf_filter(nl, nb, white, "low_pass", cut, 0.0)
        return nl, nb, torch.exp2(w * 4.0)  # examples: multiplyWithScalar 4

    def render(self, state, prog, ctx):
        act = ti._active(prog, ctx)
        nl, nb = state["nl"], state["nb"]
        if "warble_mul" in prog:
            mul = prog["warble_mul"][:, ctx.t0:ctx.t0 + ctx.n]
            if mul.shape[1] < ctx.n:  # the last chunk runs past the trajectory
                mul = torch.nn.functional.pad(mul, (0, ctx.n - mul.shape[1]), value=1.0)
        else:
            nl, nb, mul = self.warble(nl, nb, ctx)
        freq = eval_chunk(prog["phase"], ctx.t_idx)["freq"] * mul
        cnt, osc = oscillators.trisaw_naive(state["cnt"], freq, 0.0, ctx.sample_rate, act)
        cutm = float(filters.cutoff_from_frequency(880.0 * 8.0, ctx.sample_rate))
        l, b, out = filters.svf_filter(state["l"], state["b"], osc * ti._env(prog, ctx),
                                       "low_pass", cutm, 0.7, act)
        return {"cnt": cnt, "nl": nl, "nb": nb, "l": l, "b": b}, out


def ex_detuned(seconds=5.0, device="cuda", backend="torch", warble_mul=None):
    """warble_mul: see DetunedInstrument (None: the port's own warble). The
    oracle twin takes the same multiplier: warble_mul if given, else the
    port's trajectory on the CPU (oracle/examples.py detuned_warble)."""
    dev = _device(device, backend)
    sr = 48000.0
    song = _simple_song([
        (0.2, 0.8, A4 * tt.c3), (1.2, 0.8, A4 * tt.eb3),
        (2.2, 0.8, A4 * tt.g3), (3.2, 1.2, A4 * tt.c4),
    ])
    total = int(seconds * sr)
    tls = compile_timelines(song, 2, sr, total)

    def post_fn(state, mix, ctx):
        return d_ops.stereo_echoes(state, mix, 0.6, 0.7)

    def post_init(device):
        return d_ops.stereo_echoes_init(15000, device)

    def oracle_parts():
        warble = (oex.detuned_warble(len(tls), total, sr, chunk=DEFAULT_CHUNK)
                  if warble_mul is None else np.asarray(warble_mul, F32))
        return [(lambda v: oex.DetunedTwin(warble[v], sr), oex.std_params, 2, tls)]

    return _render_parts([(DetunedInstrument(warble_mul), tls)], seconds, sr, dev,
                         num_channels=2, post_fn=post_fn, post_init=post_init,
                         backend=backend, oracle_parts=oracle_parts,
                         oracle_post=lambda: oex.StereoEchoesPost(15000, 0.6, 0.7))


# ---------------------------------------------------------------------------
# example_portamento (examples/example_portamento.zig): monophonic synth
# whose frequency glides (cubed 0.5 s) to the newest held key; the envelope
# restarts only when a key goes down with all keys released.


class PortamentoInstrument:
    """Sine through a Portamento glide, times an ADSR."""

    def plan(self, timelines, sample_rate):
        prog = {"active_from": active_from(timelines)}
        porta_segs = [control.compile_portamento(
            tl, sample_rate,
            lambda k, p: {"curve": PaintCurve.cubed(0.5),
                          "goal": F32(p["freq"]),
                          "note_on": bool(p["note_on"]),
                          "prev_note_on": bool(p["prev_note_on"])})
            for tl in timelines]
        prog["porta"] = control.painter_program(porta_segs, timelines[0].total)
        env_tls = [
            SubvoiceTimeline(
                starts=tl.starts,
                resets=np.array([bool(p["note_on"]) and not bool(p["prev_note_on"])
                                 for p in tl.params], dtype=bool),
                params=tl.params, total=tl.total)
            for tl in timelines
        ]
        return ti._plan_envelope(env_tls, sample_rate, ti._cubed_adsr(), prog)

    def init_state(self, num_voices, device):
        return {"cnt": torch.zeros((num_voices,), dtype=torch.int64, device=device)}

    def render(self, state, prog, ctx):
        freq = ti._painter(prog, "porta", ctx)
        cnt, osc = oscillators.sine_osc(state["cnt"], freq, 0.0, ctx.sample_rate,
                                        ti._active(prog, ctx))
        return {"cnt": cnt}, ti._env(prog, ctx) * osc


def ex_portamento(seconds=4.0, device="cuda", backend="torch"):
    dev = _device(device, backend)
    sr = 48000.0
    # scripted mono keyboard: (time, freq or None = all released)
    moves = [(0.2, A4 * tt.c3), (0.8, A4 * tt.g3), (1.4, A4 * tt.e3),
             (2.0, None), (2.4, A4 * tt.a3), (3.2, None)]
    song = []
    nid = 0
    prev_on = False
    for t, f in moves:
        if f is not None:
            nid += 1
            song.append(_note({"freq": float(F32(f)), "note_on": True,
                               "prev_note_on": prev_on}, t, nid))
            prev_on = True
        else:
            song.append(_note({"freq": song[-1].params["freq"], "note_on": False,
                               "prev_note_on": prev_on}, t, nid))
            prev_on = False
    tls = compile_timelines(song, 1, sr, int(seconds * sr))

    def oracle_parts():
        def porta_params(sr_, p):
            return {"sample_rate": sr_, "freq": p["freq"], "note_on": p["note_on"],
                    "prev_note_on": p["prev_note_on"]}

        return [(lambda v: oex.PortaTwin(), porta_params, 2, tls)]

    return _render_parts([(PortamentoInstrument(), tls)], seconds, sr, dev,
                         backend=backend, oracle_parts=oracle_parts)


# ---------------------------------------------------------------------------
# example_mouse (examples/example_mouse.zig): PM oscillator whose ratio and
# multiplier follow glides toward a scripted pointer path.


def ex_mouse(seconds=4.0, device="cuda", backend="torch"):
    dev = _device(device, backend)
    sr = 48000.0
    total = int(seconds * sr)
    # scripted pointer path (t, x, y) in [0, 1]^2, quantized to frames as the
    # live pointer events would be
    path = [(0.0, 0.3, 0.5), (0.5, 0.5, 0.6), (1.0, 0.8, 0.3),
            (1.5, 0.4, 0.8), (2.0, 0.6, 0.2), (2.5, 0.9, 0.9),
            (3.0, 0.2, 0.4)]
    ctl_song = [_note({"v": i, "note_on": True}, t, i + 1)
                for i, (t, x, y) in enumerate(path)]
    ctl_tl = compile_timelines(ctl_song, 1, sr, total)[0]
    controllers = {
        "x": [(int(f), path[k][1]) for k, f in enumerate(ctl_tl.starts)],
        "y": [(int(f), path[k][2]) for k, f in enumerate(ctl_tl.starts)],
    }
    tls = compile_timelines(_simple_song([(0.1, seconds - 0.8, A4 * tt.a3)]), 1, sr,
                            total)

    def oracle_parts():
        ratio = oex.controller_buffer(controllers["x"], total, sr, lambda v: F32(v * 4.0))
        mult = oex.controller_buffer(controllers["y"], total, sr, lambda v: F32(v * 2.0))
        return [(lambda v: oex.MousePMTwin(ratio, mult), oex.std_params, 2, tls)]

    return _render_parts([(ti.MousePMInstrument(controllers=controllers), tls)],
                         seconds, sr, dev, backend=backend, oracle_parts=oracle_parts)


# ---------------------------------------------------------------------------
# example_fmsynth (examples/example_fmsynth.zig): OPL-style 2-operator FM,
# 8-voice polyphony, the instrument's default parameters.


def ex_fmsynth(seconds=4.0, device="cuda", backend="torch"):
    dev = _device(device, backend)
    sr = 48000.0
    song = _simple_song([
        (0.1 + 0.4 * i, 0.3, A4 * tt.rel_freq(n))
        for i, n in enumerate([-9, -5, -2, 0, 3, 0, -2, -5])
    ])
    tls = compile_timelines(song, 8, sr, int(seconds * sr))
    inst = ti.FMSynthInstrument()

    return _render_parts(
        [(inst, tls)], seconds, sr, dev, backend=backend,
        oracle_parts=lambda: [(lambda v: oex.FMSynthTwin(inst.mod, inst.car, inst.algorithm),
                               oex.std_params, 1, tls)])


# ---------------------------------------------------------------------------
# example_sampler (examples/example_sampler.zig): the looped drum loop
# through overdrive and decimator (host/configs.py).


def ex_sampler(seconds=6.0, device="cuda", backend="torch"):
    dev = _device(device, backend)
    if backend == "oracle":
        return oex.render_sampler_chain(seconds)[None, :], configs.SAMPLE_RATE
    perf, total = configs.build_sampler_performance(seconds=seconds)
    return render_performance(perf, total, chunk_size=DEFAULT_CHUNK,
                              device=dev), perf.sample_rate


# ---------------------------------------------------------------------------
# example_polyphony2 (examples/example_polyphony2.zig): NiceInstrument(0.3)
# behind a 3-slot dispatcher; the song holds 5-note overlaps, so slots are
# recycled and voices stolen.


def ex_polyphony2(seconds=6.0, device="cuda", backend="torch"):
    dev = _device(device, backend)
    sr = 48000.0
    song = _simple_song([
        (0.2 + 0.25 * i, 1.2, 220.0 * tt.rel_freq(n))
        for i, n in enumerate([0, 4, 7, 12, 16, 12, 7, 4, 0, -5, -1, 2, 7])
    ])
    tls = compile_timelines(song, 3, sr, int(seconds * sr))
    return _render_parts([(ti.NiceInstrument(0.3), tls)], seconds, sr, dev,
                         backend=backend)


# ---------------------------------------------------------------------------
# example_delay (examples/example_delay.zig): HardSquare keyboard voice
# through StereoEchoes(15000) (examples/modules.zig:464-525).


def ex_delay(seconds=8.0, device="cuda", backend="torch"):
    dev = _device(device, backend)
    sr = 48000.0
    song = _simple_song([
        (0.2 + 0.5 * i, 0.25, A4 * tt.rel_freq(n))
        for i, n in enumerate([-12, -5, 0, 3, 7, 3, 0, -5])
    ])
    tls = compile_timelines(song, 1, sr, int(seconds * sr))

    def post_fn(state, mix, ctx):
        return d_ops.stereo_echoes(state, mix, 0.6, 0.7)

    def post_init(device):
        return d_ops.stereo_echoes_init(15000, device)

    return _render_parts([(ti.HardSquareInstrument(), tls)], seconds, sr, dev,
                         num_channels=2, post_fn=post_fn, post_init=post_init,
                         backend=backend,
                         oracle_post=lambda: oex.StereoEchoesPost(15000, 0.6, 0.7))


# ---------------------------------------------------------------------------
# example_script (examples/example_script.zig): play a scripted module. The
# demo script (zang_tpu_torch/data/demo_synth.txt, the JAX package's
# DEMO_SCRIPT) exercises the reference fixture's features: a defcurve
# argument, a delay with a feedback block, a Filter in the feedback path.

DEMO_SCRIPT_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "data", "demo_synth.txt")
with open(DEMO_SCRIPT_PATH) as _f:
    DEMO_SCRIPT = _f.read()


def ex_script(seconds=6.0, device="cuda", backend="torch"):
    dev = _device(device, backend)
    song = _simple_song([
        (0.2 + 0.45 * i, 0.3, A4 * tt.rel_freq(n))
        for i, n in enumerate([-9, -2, 0, 3, 0, -2, -9, -14])
    ])
    return _render_script(DEMO_SCRIPT, "DemoSynth", song, seconds, dev, sr=44100.0,
                          backend=backend)


# ---------------------------------------------------------------------------
# example_script_runtime_mono/poly (examples/example_script_runtime_*.zig):
# live reload. The script is rendered, edited on disk, reloaded through
# LiveScript (a fresh plan replaces the reference's bytecode interpreter),
# and rendered again; the two halves are concatenated.


def ex_script_runtime(seconds=6.0, device="cuda", backend="torch"):
    import tempfile

    from ..script.runtime import LiveScript

    dev = _device(device, backend)
    sr = 44100.0
    half = seconds / 2.0
    total = int(half * sr)
    song = _simple_song([
        (0.15 + 0.4 * i, 0.3, A4 * tt.rel_freq(n))
        for i, n in enumerate([0, 3, 7, 3, 0, -5])
    ])
    edited = (DEMO_SCRIPT.replace("color=0.3", "color=0.5")
              .replace(".cubed(0.6)", ".cubed(0.2)"))
    if backend == "oracle":  # the script before and after the edit, each from frame 0
        halves = [_render_script(src, "DemoSynth", song, half, None, sr=sr, polyphony=2,
                                 backend="oracle")[0] for src in (DEMO_SCRIPT, edited)]
        return np.concatenate(halves, axis=-1), sr
    tls = compile_timelines(song, 2, sr, total)
    with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as f:
        f.write(DEMO_SCRIPT)
        path = f.name
    try:
        live = LiveScript(path, "DemoSynth")
        if not live.ok:
            raise RuntimeError(live.error)
        first = render_performance(Performance([(live.instrument, tls)], sr), total,
                                   chunk_size=DEFAULT_CHUNK, device=dev)
        # edit: brighter pulse + faster release, then hot-reload
        with open(path, "w") as f:
            f.write(edited)
        if not (live.maybe_reload() and live.ok):
            raise RuntimeError(f"reload failed: {live.error}")
        second = render_performance(Performance([(live.instrument, tls)], sr), total,
                                    chunk_size=DEFAULT_CHUNK, device=dev)
    finally:
        os.unlink(path)
    return torch.cat([first, second], dim=-1), sr


# ---------------------------------------------------------------------------
# example_song (examples/example_song.zig): a slice of the Bach Toccata.


def ex_song(seconds=20.0, device="cuda", backend="torch"):
    dev = _device(device, backend)
    if backend == "oracle":
        return song_mod.render_song_oracle(seconds)[None, :], float(song_mod.SAMPLE_RATE)
    total = int(seconds * song_mod.SAMPLE_RATE)
    perf = song_mod.build_performance(total)
    return render_performance(perf, total, chunk_size=SONG_CHUNK,
                              device=dev), float(song_mod.SAMPLE_RATE)


# ---------------------------------------------------------------------------
# registry + CLI


EXAMPLES = {
    "play": ex_play,
    "envelope": ex_envelope,
    "vibrato": ex_vibrato,
    "curve": ex_curve,
    "laser": ex_laser,
    "subsong": ex_subsong,
    "two": ex_two,
    "arpeggiator": ex_arpeggiator,
    "polyphony": ex_polyphony,
    "stereo": ex_stereo,
    "detuned": ex_detuned,
    "portamento": ex_portamento,
    "mouse": ex_mouse,
    "fmsynth": ex_fmsynth,
    "sampler": ex_sampler,
    "polyphony2": ex_polyphony2,
    "delay": ex_delay,
    "script": ex_script,
    "script_runtime": ex_script_runtime,
    "song": ex_song,
}


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="zang-torch-examples",
        description="Render a ported reference example to WAV.")
    ap.add_argument("name", choices=sorted(EXAMPLES))
    ap.add_argument("output")
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    kw = {"seconds": args.seconds} if args.seconds else {}
    audio, sr = EXAMPLES[args.name](device=args.device, **kw)
    pcm = mixdown_s16(audio, MIX_VOLUME).cpu().numpy()
    ch = pcm.shape[0]
    write_wav_s16(args.output, pcm if ch > 1 else pcm[0], int(sr), num_channels=ch)
    print(f"{args.name}: wrote {args.output} ({audio.shape[-1] / sr:.1f}s, {ch}ch)")


if __name__ == "__main__":
    main()
