"""The port's reference oracle (zang_tpu_torch/oracle) against the JAX
package's (zang_tpu/oracle), on the CPU, bit for bit.

The port's copy is sequential numpy f32 and the same C++ inner loops built
with the same g++ flags, so on one machine every comparison here is exact:

- every zo_* entry of csrc/zang_oracle.cpp, called through both libraries
  with the same seeded inputs (outputs, carried state, return values);
  the library builds into zang_tpu_torch/build/ (~1 s of g++);
- every module (Painter through Envelope and Portamento, SineOsc, PulseOsc,
  TriSawOsc, Gate, cutoff_from_frequency, Filter, the xoshiro generator,
  Noise, Cycle, Decimator, Distortion, Sample/Sampler, Curve, Delay) in
  both its parity and exact modes, painted over spans that cross the
  1024-frame block seams, with notes starting and ending among them;
- render_song_oracle at 10 s in both modes (~2 s each package);
- render_script_oracle with a NoiseTapeFactory on two multi-site scripts
  of tests/test_script_fuzz.py's tier-2 generator (the tapes drawn by the
  port's threefry, equal to jax.random's);
- `python -m zang_tpu_torch.host.render_wav song --engine oracle` at 2 s,
  byte for byte with the JAX CLI's WAV, and the oracle engines refused for
  another config as in the JAX CLI;
- bench_fidelity at 2 s on the CPU: the whole render against the oracle,
  equal to deviation_dbfs against the JAX package's render_song_oracle;
- the F2 script (a painter, Gate, inside a zangscript delay body whose
  feedback is low-passed, as chip_smoke.py phase 15 renders it) at chunks
  8,192 and 16,384: the port within -90 dBFS of the oracle, where the JAX
  renderer (which evaluates the chunk's tiled painter program at a
  sub-chunk's frames) is printed to document the port's departure.
"""

import ctypes
import importlib.util
import io
import json
import os
import random
import subprocess
import sys
import zlib
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from zang_tpu.core import curves as jcurves
from zang_tpu.core import span as jspan
from zang_tpu.host import song as jsong
from zang_tpu.oracle import modules as jmod
from zang_tpu.oracle import native as jnative
from zang_tpu.oracle import script as jscript_oracle
from zang_tpu.script import compile_script as jcompile
from zang_tpu_torch.core import curves as tcurves
from zang_tpu_torch.core import span as tspan
from zang_tpu_torch.graph.fidelity import deviation_dbfs
from zang_tpu_torch.host import song as tsong
from zang_tpu_torch.oracle import modules as tmod
from zang_tpu_torch.oracle import native as tnative
from zang_tpu_torch.oracle import script as tscript_oracle
from zang_tpu_torch.ops import _build
from zang_tpu_torch.script import compile_script as tcompile

torch.set_num_threads(1)  # xdist workers share the cores (see PERF.md §7)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = np.float32
SR = 44100.0
PARITY_DB = -90.0  # FIDELITY.md's parity budget

# ---------------------------------------------------------------------------
# the native entries


def test_library_builds_into_the_port_build_dir():
    secs = tnative.build()
    assert secs >= 0.0
    so = [f for f in os.listdir(_build.BUILD_DIR) if f.startswith("libzang_oracle_")
          and f.endswith(".so")]
    assert so, os.listdir(_build.BUILD_DIR)
    assert tnative.SRC == os.path.join(ROOT, "zang_tpu_torch", "csrc", "zang_oracle.cpp")
    with open(tnative.SRC, "rb") as a, open(os.path.join(
            ROOT, "zang_tpu", "oracle", "native", "zang_oracle.cpp"), "rb") as b:
        # the copy differs from the JAX package's in its header comment only
        ours, theirs = a.read().splitlines(), b.read().splitlines()
        assert len(ours) == len(theirs)
        assert [i for i, (x, y) in enumerate(zip(ours, theirs)) if x != y] == [3]


N = 2500  # frames a native call: crosses two 1024-frame seams


def _data8(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8)


def _native_case(name, rng):
    """The arguments of one zo_* call: numpy arrays for pointers (each
    package's library gets its own copy), Python scalars otherwise."""
    u = lambda lo, hi, n=N: rng.uniform(lo, hi, n).astype(F32)  # noqa: E731
    out = np.zeros(N, F32) if rng.random() < 0.5 else u(-0.5, 0.5)
    f1 = lambda v: np.array([v], F32)  # noqa: E731
    cnt = lambda: np.array([rng.integers(0, 2 ** 32)], np.uint32)  # noqa: E731
    data = _data8(rng, 6000)
    return {
        "zo_sine_exact": [out, N, f1(0.3), 1, 0.0, u(20, 2000), 1, 0.0, u(-1, 1), SR],
        "zo_sine_parity": [out, N, cnt(), 1, 0.0, u(20, 2000), 0, 0.25, None, SR],
        "zo_pulse_const": [out, N, cnt(), SR, 440.0, 0.3],
        "zo_pulse_ctl": [out, N, cnt(), SR, u(-100, 6000), 0.7],
        "zo_trisaw_const": [out, N, cnt(), SR, 330.0, 0.2],
        "zo_trisaw_ctl_exact": [out, N, f1(0.1), SR, u(20, 3000), 0.4],
        "zo_trisaw_ctl_parity": [out, N, cnt(), SR, u(20, 3000), 0.0],
        "zo_paint_toward": [out, N, 7, f1(0.2), f1(0.1), 0.05, 3, 0.04, SR, 0.8,
                            np.zeros(1, np.int32)],
        "zo_filter": [out, u(-1, 1), N, f1(0.01), f1(-0.02), 1.0, 1.0, 1.0, 1, 0.0,
                      u(0.01, 0.9), 0, 0.5, None],
        "zo_noise_pink": [out, u(0, 1), N, u(-0.1, 0.1, 7)],
        "zo_decimator_exact": [out, u(-1, 1), N, f1(0.0), f1(1.0), 0.137],
        "zo_distortion": [out, u(-1.5, 1.5), N, int(rng.integers(0, 2)), 0.9, 0.5, 0.1],
        "zo_cycle_exact": [out, N, f1(0.7), 1, 0.0, u(0, 50), SR],
        "zo_sampler_resample_exact": [out, N, f1(3.5), 0.83, data, data.size, 1, 2, 1, 1],
        "zo_sampler_resample_parity": [out, N, f1(3.5), 1.37, data, data.size, 2, 1, 0, 0],
        "zo_sampler_copy": [out, N, 11.0, data, data.size, 0, 1, 0, 1],
        "zo_curve_linear_exact": [out, N, 0.25, 1e-3],
        "zo_curve_smoothstep_exact": [out, N, 0.1, 3e-4, 200.0, -150.0],
        "zo_curve_linear_parity": [out, N, 0.25, 1e-3],
        "zo_curve_smoothstep_parity": [out, N, 0.1, 3e-4, 200.0, -150.0],
        "zo_fm_feedback": [out, u(0, 6.3), N, 0.785398, int(rng.integers(0, 4)), f1(0.01),
                           f1(-0.02)],
    }[name]


def _c_arg(a):
    if isinstance(a, np.ndarray):
        ctype = {np.dtype(F32): ctypes.c_float, np.dtype(np.uint32): ctypes.c_uint32,
                 np.dtype(np.uint8): ctypes.c_uint8, np.dtype(np.int32): ctypes.c_int}
        return a.ctypes.data_as(ctypes.POINTER(ctype[a.dtype]))
    return a


NATIVE_ENTRIES = [
    "zo_sine_exact", "zo_sine_parity", "zo_pulse_const", "zo_pulse_ctl",
    "zo_trisaw_const", "zo_trisaw_ctl_exact", "zo_trisaw_ctl_parity", "zo_paint_toward",
    "zo_filter", "zo_noise_pink", "zo_decimator_exact", "zo_distortion", "zo_cycle_exact",
    "zo_sampler_resample_exact", "zo_sampler_resample_parity", "zo_sampler_copy",
    "zo_curve_linear_exact", "zo_curve_smoothstep_exact", "zo_curve_linear_parity",
    "zo_curve_smoothstep_parity", "zo_fm_feedback",
]


def test_native_entries_are_the_jax_oracle_s():
    names = {ln.split("(")[0].split()[-1] for ln in open(tnative.SRC)
             if ln.startswith(("void zo_", "int zo_"))}
    assert names == set(NATIVE_ENTRIES)


@pytest.mark.parametrize("name", NATIVE_ENTRIES)
def test_native_entry_bit_for_bit(name):
    for seed in range(3):
        args = _native_case(name, np.random.default_rng(zlib.crc32(name.encode()) + seed))
        mine = [a.copy() if isinstance(a, np.ndarray) else a for a in args]
        theirs = [a.copy() if isinstance(a, np.ndarray) else a for a in args]
        r1 = getattr(tnative.lib(), name)(*map(_c_arg, mine))
        r2 = getattr(jnative.lib(), name)(*map(_c_arg, theirs))
        if name == "zo_paint_toward":  # the only entry that returns a value
            assert r1 == r2
        for a, b in zip(mine, theirs):
            if isinstance(a, np.ndarray):
                assert a.tobytes() == b.tobytes(), name
        assert not np.array_equal(mine[0], args[0]), f"{name} wrote nothing"


# ---------------------------------------------------------------------------
# the modules, both modes, over spans that cross block seams

TOTAL = 6 * 1024 + 300
MODES = ("parity", "exact")


def _spans(seed, total=TOTAL):
    """[(start, end, note_id_changed, note_on)]: spans of 1-1500 frames
    cut at random (most cross a 1024-frame seam), some starting a note,
    some ending it."""
    rng = random.Random(seed)
    spans, pos, on = [], 0, False
    while pos < total:
        end = min(total, pos + rng.choice([1, 37, 500, 1024, 1100, 1500]))
        nic = rng.random() < 0.3
        on = True if nic else (on if rng.random() < 0.7 else not on)
        spans.append((pos, end, nic, on))
        pos = end
    return spans


def _paint(pkg, make, params_fn, seed=0, num_temps=0):
    """Paint one module of `pkg` ("jax" or "port") over _spans(seed)."""
    mod, span_cls, curves = ((jmod, jspan.Span, jcurves) if pkg == "jax"
                             else (tmod, tspan.Span, tcurves))
    m = make(mod)
    out = np.zeros(TOTAL, F32)
    temps = [np.zeros(TOTAL, F32) for _ in range(num_temps)]
    for s, e, nic, on in _spans(seed):
        m.paint(span_cls(s, e), [out], temps, nic, params_fn(curves, on))
    return out, m


def _both(make, params_fn, seed=0):
    a, ma = _paint("port", make, params_fn, seed)
    b, mb = _paint("jax", make, params_fn, seed)
    assert a.dtype == b.dtype == F32
    assert a.tobytes() == b.tobytes()
    assert np.abs(a).max() > 0.0
    return a, ma, mb


_rng = np.random.default_rng(1234)
FREQ_BUF = _rng.uniform(50.0, 3000.0, TOTAL).astype(F32)
PHASE_BUF = _rng.uniform(-1.0, 1.0, TOTAL).astype(F32)
INPUT_BUF = _rng.uniform(-1.0, 1.0, TOTAL).astype(F32)
CUT_BUF = _rng.uniform(0.01, 0.95, TOTAL).astype(F32)
RES_BUF = _rng.uniform(0.0, 1.0, TOTAL).astype(F32)
SPEED_BUF = _rng.uniform(0.0, 40.0, TOTAL).astype(F32)

MODULE_CASES = {
    "sine_const": (lambda m, mode: m.SineOsc(mode),
                   lambda c, on: {"sample_rate": SR, "freq": 440.0, "phase": 0.0}),
    "sine_buffers": (lambda m, mode: m.SineOsc(mode),
                     lambda c, on: {"sample_rate": SR, "freq": FREQ_BUF, "phase": PHASE_BUF}),
    "pulse_const": (lambda m, mode: m.PulseOsc(mode),
                    lambda c, on: {"sample_rate": SR, "freq": 220.0, "color": 0.3}),
    "pulse_buffer": (lambda m, mode: m.PulseOsc(mode),
                     lambda c, on: {"sample_rate": SR, "freq": FREQ_BUF, "color": 0.6}),
    "trisaw_const": (lambda m, mode: m.TriSawOsc(mode),
                     lambda c, on: {"sample_rate": SR, "freq": 330.0, "color": 0.2}),
    "trisaw_buffer": (lambda m, mode: m.TriSawOsc(mode),
                      lambda c, on: {"sample_rate": SR, "freq": FREQ_BUF, "color": 0.0}),
    "envelope_cubed": (lambda m, mode: m.Envelope(mode), lambda c, on: {
        "sample_rate": SR, "attack": c.PaintCurve.cubed(0.01),
        "decay": c.PaintCurve.cubed(0.02), "release": c.PaintCurve.cubed(0.03),
        "sustain_volume": 0.5, "note_on": on}),
    "envelope_mixed": (lambda m, mode: m.Envelope(mode), lambda c, on: {
        "sample_rate": SR, "attack": c.PaintCurve.instantaneous(),
        "decay": c.PaintCurve.squared(0.015), "release": c.PaintCurve.linear(0.04),
        "sustain_volume": 0.7, "note_on": on}),
    "gate": (lambda m, mode: m.Gate(mode), lambda c, on: {"note_on": on}),
    "portamento": (lambda m, mode: m.Portamento(mode), lambda c, on: {
        "sample_rate": SR, "curve": c.PaintCurve.cubed(0.05), "goal": 440.0 if on else 220.0,
        "note_on": True, "prev_note_on": on}),
    "cycle_const": (lambda m, mode: m.Cycle(mode),
                    lambda c, on: {"sample_rate": SR, "speed": 7.5}),
    "cycle_buffer": (lambda m, mode: m.Cycle(mode),
                     lambda c, on: {"sample_rate": SR, "speed": SPEED_BUF}),
    "decimator": (lambda m, mode: m.Decimator(mode), lambda c, on: {
        "sample_rate": SR, "input": INPUT_BUF, "fake_sample_rate": 6000.0 if on else 50000.0}),
    "distortion_overdrive": (lambda m, mode: m.Distortion(mode), lambda c, on: {
        "input": INPUT_BUF, "type": "overdrive", "ingain": 0.9, "outgain": 0.5,
        "offset": 0.0}),
    "distortion_clip": (lambda m, mode: m.Distortion(mode), lambda c, on: {
        "input": INPUT_BUF, "type": "clip", "ingain": 0.6, "outgain": 0.8, "offset": 0.1}),
    "curve_linear": (lambda m, mode: m.Curve(mode), lambda c, on: {
        "sample_rate": SR, "function": "linear", "curve": [
            c.CurveNode(value=440.0, t=0.0), c.CurveNode(value=880.0, t=0.03),
            c.CurveNode(value=110.0, t=0.07), c.CurveNode(value=20.0, t=0.1)]}),
    "curve_smoothstep": (lambda m, mode: m.Curve(mode), lambda c, on: {
        "sample_rate": SR, "function": "smoothstep", "curve": [
            c.CurveNode(value=0.0, t=0.0), c.CurveNode(value=1.0, t=0.004),
            c.CurveNode(value=0.0, t=0.05)]}),
    "noise_white_tape": (
        lambda m, mode: m.Noise(mode, tape_fn=lambda n: np.random.default_rng(n).random(
            n, dtype=np.float32)),
        lambda c, on: {"color": "white"}),
    "noise_pink_tape": (
        lambda m, mode: m.Noise(mode, tape_fn=lambda n: np.random.default_rng(n + 1).random(
            n, dtype=np.float32)),
        lambda c, on: {"color": "pink"}),
}
for _t in ("low_pass", "band_pass", "high_pass", "notch", "all_pass", "bypass"):
    MODULE_CASES[f"filter_{_t}"] = (lambda m, mode: m.Filter(mode), lambda c, on, _t=_t: {
        "input": INPUT_BUF, "type": _t, "cutoff": 0.3, "res": 0.5})
MODULE_CASES["filter_buffers"] = (lambda m, mode: m.Filter(mode), lambda c, on: {
    "input": INPUT_BUF, "type": "low_pass", "cutoff": CUT_BUF, "res": RES_BUF})


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(MODULE_CASES))
def test_module_bit_for_bit(case, mode):
    make, params_fn = MODULE_CASES[case]
    for seed in range(2):
        _both(lambda m: make(m, mode), params_fn, seed)


@pytest.mark.parametrize("mode", MODES)
def test_painter_state_bit_for_bit(mode):
    """The Painter's carried state (t, last value, the parity table walk)
    after each span, through an Envelope."""
    make, params_fn = MODULE_CASES["envelope_cubed"]
    a, ma, mb = _both(lambda m: make(m, mode), params_fn, 3)
    for attr in ("t", "last_value", "start", "_table_pos", "_table_t0"):
        assert np.float32(getattr(ma.painter, attr)).tobytes() == \
            np.float32(getattr(mb.painter, attr)).tobytes(), attr
    assert ma.state == mb.state


def test_cutoff_from_frequency_bit_for_bit():
    freqs = np.concatenate([np.geomspace(1.0, 24000.0, 4001), [0.0, 4.0, 7040.0]])
    for sr in (44100.0, 48000.0):
        got = [F32(tmod.cutoff_from_frequency(f, sr)).tobytes() for f in freqs]
        want = [F32(jmod.cutoff_from_frequency(f, sr)).tobytes() for f in freqs]
        assert got == want


def test_xoshiro_bit_for_bit():
    for seed in (0, 1, 12345, 2 ** 63 + 7):
        a, b = tmod._Xoshiro256pp(seed), jmod._Xoshiro256pp(seed)
        assert [a.next_u64() for _ in range(200)] == [b.next_u64() for _ in range(200)]
        assert [a.float_f32() for _ in range(200)] == [b.float_f32() for _ in range(200)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("color", ("white", "pink"))
def test_noise_default_stream_bit_for_bit(color, mode):
    """Noise without a tape draws xoshiro256++ from a per-process seed
    counter: both packages' counters set alike, the same stream."""
    saved = (tmod._noise_next_seed[0], jmod._noise_next_seed[0])
    try:
        tmod._noise_next_seed[0] = jmod._noise_next_seed[0] = 5
        _both(lambda m: m.Noise(mode), lambda c, on: {"color": color})
        assert tmod._noise_next_seed[0] == jmod._noise_next_seed[0] == 6
    finally:
        tmod._noise_next_seed[0], jmod._noise_next_seed[0] = saved


SAMPLE_CASES = [  # (channels, sample rate, format, bytes a sample, channel, loop)
    (1, 44100, "signed16_lsb", 2, 0, True),     # the copy path (ratio 1)
    (2, 22050, "signed16_lsb", 2, 1, True),
    (1, 48000, "unsigned8", 1, 0, False),
    (2, 96000, "signed24_lsb", 3, 0, True),
    (1, 11025, "signed32_lsb", 4, 0, False),
    (1, 44100, "signed16_lsb", 2, 1, True),     # channel out of range: silent
]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", range(len(SAMPLE_CASES)))
def test_sampler_bit_for_bit(case, mode):
    ch, rate, fmt, width, channel, loop = SAMPLE_CASES[case]
    data = _data8(np.random.default_rng(case), 1777 * ch * width).tobytes()

    def make(m):
        return m.Sampler(mode)

    cache = {}

    def params(c, on):
        pkg = "port" if c is tcurves else "jax"
        if pkg not in cache:
            cache[pkg] = (tmod if pkg == "port" else jmod).Sample(ch, rate, fmt, data)
        return {"sample_rate": SR, "sample": cache[pkg], "channel": channel, "loop": loop}

    if channel >= ch:
        a, _ = _paint("port", make, params)
        b, _ = _paint("jax", make, params)
        assert not a.any() and not b.any()
        return
    a, ma, mb = _both(make, params)
    assert F32(ma.t).tobytes() == F32(mb.t).tobytes()


def test_delay_bit_for_bit():
    rng = np.random.default_rng(7)
    for length in (1, 300, 1024, 4410):
        a, b = tmod.Delay(length), jmod.Delay(length)
        outs = []
        for step in range(40):
            n = int(rng.integers(1, length + 1))
            x = rng.uniform(-1, 1, n).astype(F32)
            oa, ob = np.zeros(n, F32), np.zeros(n, F32)
            ra, rb = a.read(oa), b.read(ob)
            assert ra == rb
            a.write(x[:ra])
            b.write(x[:rb])
            outs.append(oa)
            assert oa.tobytes() == ob.tobytes() and a.index == b.index
            if step == 20:
                a.reset()
                b.reset()
        assert a.buffer.tobytes() == b.buffer.tobytes()
        assert np.concatenate(outs).any()


# ---------------------------------------------------------------------------
# the song


@pytest.mark.parametrize("mode", MODES)
def test_render_song_oracle_bit_for_bit(mode):
    got = tsong.render_song_oracle(10.0, mode)
    want = jsong.render_song_oracle(10.0, mode)
    assert got.shape == (480000,) and got.dtype == F32
    assert got.tobytes() == want.tobytes()
    assert np.abs(got).max() > 0.5


def test_build_oracle_voices_is_the_song():
    voices = tsong.build_oracle_voices()
    assert [len(v.sub_voices) for v in voices] == [3, 10, 4]
    jv = jsong.build_oracle_voices()
    for a, b in zip(voices, jv):
        assert type(a.sub_voices[0]["module"]).__name__ == \
            type(b.sub_voices[0]["module"]).__name__


# ---------------------------------------------------------------------------
# the script oracle with per-site noise tapes (NoiseTapeFactory)

_spec = importlib.util.spec_from_file_location(
    "_torch_oracle_fuzz_generators", os.path.join(ROOT, "tests", "test_script_fuzz.py"))
_JF = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_JF)


def _port_site_tapes(sites, polyphony, total, chunk):
    """The engine's positional white tapes, a site each, drawn by the port's
    threefry (script/torch_backend.py exec_op "noise")."""
    from zang_tpu_torch.ops import noise as tnoise

    tapes = []
    for site in sites:
        key0 = tnoise.prng_key(zlib.crc32(site.encode()) & 0x7FFFFFFF)
        cols = [tnoise.uniform(tnoise.fold_in(key0, c * chunk), (polyphony, chunk),
                               "cpu").numpy() for c in range(-(-total // chunk))]
        tapes.append(np.concatenate(cols, axis=1)[:, :total])
    return [[t[v] for t in tapes] for v in range(polyphony)]


@pytest.mark.parametrize("seed", [40, 79])
def test_script_oracle_noise_tape_factory(seed):
    """tests/test_script_fuzz.py's tier-2 draws for `seed` (two Noise
    sites): the port's and the JAX package's render_script_oracle on the
    same per-site tapes, bit for bit; the port's tapes are jax.random's."""
    from zang_tpu.core.timeline import compile_timelines as jcompile_timelines
    from zang_tpu.script.jax_backend import ScriptInstrument as JScriptInstrument
    from zang_tpu_torch.core.notes import SongEvent as TSongEvent

    rng = random.Random(888000 + seed)
    src = _JF.ScriptGenWild(rng).script()
    polyphony = rng.choice([1, 2, 3, 4])
    song = _JF._fuzz_song_wild(rng, polyphony)
    total = 30000
    inst = JScriptInstrument(jcompile(src), "Root")
    inst.plan(jcompile_timelines(song, polyphony, SR, total), SR)
    sites = _JF._noise_sites(inst._ir["ops"])
    assert len(sites) == 2, src
    tapes = _port_site_tapes(sites, polyphony, total, 8192)
    jtapes = _JF._engine_noise_tapes(inst, polyphony, total, chunk=8192)
    for v in range(polyphony):
        for s in range(2):
            assert tapes[v][s].tobytes() == np.asarray(jtapes[v][s], F32).tobytes()
    tsong_ = [TSongEvent(dict(e.params), t=e.t, note_id=e.note_id) for e in song]
    got = tscript_oracle.render_script_oracle(tcompile(src), "Root", tsong_, total, SR,
                                              polyphony=polyphony, noise_tapes=tapes)
    want = jscript_oracle.render_script_oracle(jcompile(src), "Root", song, total, SR,
                                               polyphony=polyphony, noise_tapes=jtapes)
    assert got.tobytes() == np.asarray(want).tobytes()
    assert np.abs(got).max() > 1e-4


def test_script_oracle_refuses_user_builtins():
    assert "Curve" in tscript_oracle._BUILTIN_CLASSES
    assert set(tscript_oracle._BUILTIN_CLASSES) == set(jscript_oracle._BUILTIN_CLASSES)


# ---------------------------------------------------------------------------
# the CLI's --engine oracle


def _cli(module, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("engine", ["oracle", "oracle-exact"])
def test_render_wav_engine_oracle_is_the_jax_cli_s_bytes(tmp_path, engine):
    ours, theirs = tmp_path / "port.wav", tmp_path / "jax.wav"
    p = _cli("zang_tpu_torch.host.render_wav", "song", str(ours), "--engine", engine,
             "--seconds", "2", "--device", "cpu")
    assert p.returncode == 0, p.stderr
    assert f"engine={engine}" in p.stdout
    p = _cli("zang_tpu.host.render_wav", "song", str(theirs), "--engine", engine,
             "--seconds", "2")
    assert p.returncode == 0, p.stderr
    assert ours.read_bytes() == theirs.read_bytes()
    assert len(ours.read_bytes()) == 44 + 2 * 96000


def test_render_wav_engine_oracle_needs_no_cuda(tmp_path):
    """The oracle runs on the host: --engine oracle with the default
    --device cuda renders where there is no card."""
    from zang_tpu_torch.core.mixdown import mixdown_s16_np
    from zang_tpu_torch.core.wav import read_wav
    from zang_tpu_torch.host import render_wav

    out = tmp_path / "x.wav"
    with redirect_stdout(io.StringIO()):
        render_wav.main(["song", str(out), "--engine", "oracle", "--seconds", "1"])
    w = read_wav(str(out))
    want = mixdown_s16_np(tsong.render_song_oracle(1.0)[None, :], tsong.MIX_VOLUME)[0]
    assert w.sample_rate == 48000 and w.num_channels == 1
    assert np.frombuffer(w.data, "<i2").tobytes() == want.tobytes()


@pytest.mark.parametrize("config", ["sampler", "poly_echo"])
def test_render_wav_engine_oracle_refused_for_configs(tmp_path, config):
    from zang_tpu_torch.host import render_wav

    with pytest.raises(SystemExit) as e:
        render_wav.main([config, str(tmp_path / "x.wav"), "--engine", "oracle"])
    assert e.value.code == 2
    assert not (tmp_path / "x.wav").exists()


# ---------------------------------------------------------------------------
# bench.py's fidelity metric through the port


def test_bench_fidelity_is_the_whole_render_against_the_oracle(capsys):
    from zang_tpu_torch import bench

    seconds, chunk = 2.0, 16384
    bench.bench_fidelity(seconds, chunk, torch.device("cpu"))
    out, err = capsys.readouterr()
    (line,) = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert line["metric"] == "torch_bach_render_fidelity_rms_dbfs"
    assert line["unit"] == "dbfs_rms_vs_oracle"
    mix = tsong.render_song(seconds, chunk_size=chunk, device="cpu").numpy()
    rms, _ = deviation_dbfs(mix, jsong.render_song_oracle(seconds))
    assert line["value"] == round(float(rms), 1)
    assert line["vs_baseline"] == round(float(rms) / -90.0, 3)
    assert line["value"] < PARITY_DB
    assert "# bench_fidelity oracle 2 s of song in" in err
    assert "# bench_fidelity on the JAX golden's windows: -" in err


# ---------------------------------------------------------------------------
# F2: a painter inside a zangscript delay body

F2_SCRIPT = """
F2 = defmodule freq: cob, note_on: boolean, begin
    out delay 4000 begin
        out Gate(note_on) * PulseOsc(freq, color=0.5) * 0.3 + feedback * 0.5
        feedback Filter(input=Gate(note_on) * PulseOsc(freq, color=0.5) * 0.3,
                        type=.low_pass, cutoff=0.2, res=0)
    end
end
"""
F2_NOTES = [(0.1, 0.3, 220.0), (0.5, 0.2, 330.0), (0.8, 0.25, 440.0)]
F2_TOTAL = 3 * 16384


def _f2_song(song_event):
    song = []
    for i, (t0, dur, f) in enumerate(F2_NOTES):
        song.append(song_event({"freq": f, "note_on": True}, t=t0, note_id=i + 1))
        song.append(song_event({"freq": f, "note_on": False}, t=t0 + dur, note_id=i + 1))
    return song


@pytest.mark.parametrize("chunk", [8192, 16384])
def test_f2_delay_body_painter_matches_the_oracle(chunk):
    """The port evaluates a painter over the whole chunk and slices it per
    sub-chunk of the delay, as the oracle paints it; the JAX renderer reads
    the chunk's tiled program at a sub-chunk's frames (ROADMAP F2), printed
    here, not bounded."""
    from zang_tpu.core.notes import SongEvent as JSongEvent
    from zang_tpu.core.timeline import compile_timelines as jct
    from zang_tpu.graph.render import Performance as JP, render_performance as jrp
    from zang_tpu.script.jax_backend import ScriptInstrument as JSI
    from zang_tpu_torch.core.notes import SongEvent as TSongEvent
    from zang_tpu_torch.core.timeline import compile_timelines as tct
    from zang_tpu_torch.graph.render import Performance as TP, render_performance as trp
    from zang_tpu_torch.script.torch_backend import ScriptInstrument as TSI

    oracle = tscript_oracle.render_script_oracle(tcompile(F2_SCRIPT), "F2",
                                                 _f2_song(TSongEvent), F2_TOTAL, SR)
    joracle = jscript_oracle.render_script_oracle(jcompile(F2_SCRIPT), "F2",
                                                  _f2_song(JSongEvent), F2_TOTAL, SR)
    assert oracle.tobytes() == np.asarray(joracle).tobytes()
    tls = tct(_f2_song(TSongEvent), 1, SR, F2_TOTAL)
    got = trp(TP([(TSI(tcompile(F2_SCRIPT), "F2"), tls)], SR), F2_TOTAL, chunk,
              device="cpu").numpy()
    jax_render = np.asarray(jrp(JP([(JSI(jcompile(F2_SCRIPT), "F2"),
                                     jct(_f2_song(JSongEvent), 1, SR, F2_TOTAL))], SR),
                                F2_TOTAL, chunk_size=chunk))
    db, _ = deviation_dbfs(got, oracle)
    jdb, _ = deviation_dbfs(jax_render, oracle)
    print(f"F2 at chunk {chunk}: the port {db:.1f} dBFS from the oracle, the JAX "
          f"renderer {jdb:.1f} dBFS")
    assert float(np.sqrt(np.mean(oracle.astype(np.float64) ** 2))) > 0.05
    assert db < PARITY_DB
