"""The port's zangscript (zang_tpu_torch/script/) against zang_tpu's, on the CPU.

- The front end (tokenizer, parser, codegen, the printers) is a copy: on
  the corpus of tests/test_script.py and the example scripts, the token
  stream, the parse, codegen and builtin dumps and zangc's --dump-lowered
  (the planned IR, which fixes site names, temps and column order) are
  identical text; every ScriptError and PlanError case raises in both with
  the same message, and mutated scripts compile or fail alike.
- The ops the backend added: control.compile_curve and its walk bit for
  bit; svf_filter's "mix" (per-sample muls) within -120 dBFS and "bypass"
  exactly; distortion("clip") and decimator(active=, ratio=) bit for bit.
- LiveScript reloads, keeps the old instrument on a failed reload, and
  builds its error from the port's own Source.
- zangc: -o emits a module that imports the port and renders the port's
  bits; the dumps are the JAX CLI's; a user builtin written against torch
  (a torch twin of each tests/test_script.py class) renders within -90 dBFS
  of the JAX one.
"""

import importlib.util
import os
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zang_tpu.core import timeline as jtl
from zang_tpu.core.notes import SongEvent as JSongEvent
from zang_tpu.graph import render as jrender
from zang_tpu.host import examples as jex
from zang_tpu.ops import control as jctl
from zang_tpu.ops import effects as jfx
from zang_tpu.ops import filters as jfilt
from zang_tpu.script import compile_script as jcompile
from zang_tpu.script import printers as jprinters
from zang_tpu.script import runtime as jruntime
from zang_tpu.script.errors import ScriptError as JScriptError, Source as JSource
from zang_tpu.script.jax_backend import PlanError as JPlanError
from zang_tpu.script.jax_backend import ScriptInstrument as JScriptInstrument
from zang_tpu.script.tokenize import Tokenizer as JTokenizer
from zang_tpu_torch.core import timeline as ttl
from zang_tpu_torch.core.notes import SongEvent as TSongEvent
from zang_tpu_torch.graph import render as trender
from zang_tpu_torch.ops import control as tctl
from zang_tpu_torch.ops import effects as tfx
from zang_tpu_torch.ops import filters as tfilt
from zang_tpu_torch.script import compile_script as tcompile
from zang_tpu_torch.script import printers as tprinters
from zang_tpu_torch.script import runtime as truntime
from zang_tpu_torch.script import zangc as tzangc
from zang_tpu_torch.script.errors import ScriptError as TScriptError, Source as TSource
from zang_tpu_torch.script.torch_backend import PlanError as TPlanError
from zang_tpu_torch.script.torch_backend import ScriptInstrument as TScriptInstrument
from zang_tpu_torch.script.tokenize import Tokenizer as TTokenizer

torch.set_num_threads(1)  # xdist workers share the cores (see PERF.md §7)

HERE = os.path.dirname(os.path.abspath(__file__))
SR = 44100.0
BUDGET_DB = -90.0


def _load(name):
    """A module of tests/ by path (its scripts and generators)."""
    spec = importlib.util.spec_from_file_location(f"_torch_script_{name}",
                                                  os.path.join(HERE, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_JS = _load("test_script")
_JF = _load("test_script_fuzz")


def _rms_db(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return 20 * np.log10(np.sqrt(np.mean(d * d)) + 1e-30)


# ---------------------------------------------------------------------------
# the corpus: tests/test_script.py's scripts and the example scripts

ENUM_TRACK = """
F = defmodule freq: cob, note_on: boolean, begin
    osc = Gate(note_on) * PulseOsc(freq, color=0.5) * 0.5
    out from deftrack ft: FilterType, begin
        0.0 (ft=.low_pass)
        0.25 (ft=.bypass)
        0.5 (ft=.high_pass)
    end, 1 begin
        out Filter(input=osc, type=ft, cutoff=0.25, res=0.3)
    end
end
"""

CORPUS = {
    "voice": _JS.VOICE_SRC,
    "robust_good": _JS.TestCompilerRobustness.GOOD,
    "fuzz_valid": _JF.VALID,
    "delay_feedback": """
E = defmodule freq: cob, note_on: boolean, begin
    dry = Gate(note_on) * PulseOsc(freq, color=0.5) * 0.3
    out delay 2048 begin
        result = dry + feedback * 0.6
        out result
        feedback Filter(input=result, type=.low_pass, cutoff=0.4, res=0)
    end
end
""",
    "track_call": """
Coin = defmodule freq: cob, note_on: boolean, begin
    base_freq = freq
    out from deftrack f: constant, gate: boolean, begin
        0.0 (f=750, gate=true)
        0.045 (f=1000, gate=true)
        0.09 (f=1000, gate=false)
    end, 1 begin
        out Gate(note_on=gate) * SineOsc(freq=base_freq * (f / 1000), phase=0) * 0.5
    end
end
""",
    "enum_track": ENUM_TRACK,
    "exported_enum": """
D = defmodule freq: cob, note_on: boolean, dist: DistortionType, begin
    out Distortion(input=Gate(note_on) * SineOsc(freq, phase=0) * 0.8,
                   type=dist, ingain=0.6, outgain=0.7, offset=0.1)
end
""",
    "payload_envelope": """
V = defmodule freq: cob, note_on: boolean, begin
    e = from deftrack a: PaintCurve, begin
        0.0 (a=.linear(0.02))
    end, 1 begin
        out Envelope(attack=a, decay=.cubed(0.1), release=.linear(0.3),
                     sustain_volume=0.8, note_on)
    end
    out e * SineOsc(freq, phase=0)
end
""",
    "noise_color": """
N = defmodule note_on: boolean, begin
    out from deftrack c: NoiseColor, begin
        0.0 (c=.pink)
    end, 1 begin
        out Gate(note_on) * Noise(color=c) * 0.3
    end
end
""",
    "plan_error_curve_param": """
M = defmodule c: curve, begin
    out Curve(curve=c, function=.linear)
end
""",
    "plan_error_curve_fn": """
M = defmodule note_on: boolean, begin
    out from deftrack fn: InterpolationFunction, begin
        0.0 (fn=.linear)
    end, 1 begin
        out Curve(curve=defcurve
            0.0 0.0
            1.0 1.0
        end, function=fn)
    end
end
""",
    "builtin_functions": """
M = defmodule freq: cob, note_on: boolean, begin
    s = SineOsc(freq, phase=0)
    a = max(0, s) + min(0, s) - abs(s) * 0.1
    b = pow(abs(s) + 0.1, 2) + sqrt(abs(s)) + cos(s * pi)
    out (a + b * 0.1) * Gate(note_on) * 0.2
end
""",
    "demo": jex.DEMO_SCRIPT,
    "envelope": jex.ENVELOPE_SCRIPT,
    "vibrato": jex.VIBRATO_SCRIPT,
    "laser": jex.LASER_SCRIPT,
    "subsong": jex.SUBSONG_SCRIPT,
    **{f"snippet_{k}": v for k, v in _JS.TestAllBuiltinsRender.SNIPPETS.items()},
}


def _tokens(tokenizer_cls, source_cls, src):
    tk = tokenizer_cls(source_cls("<script>", src))
    out = []
    while True:
        t = tk.next()
        out.append((t.tt, t.source_range.loc0.line, t.source_range.loc0.index,
                    t.source_range.loc1.index, np.float32(t.number).tobytes()))
        if t.tt == "end_of_file":
            return out


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_front_end_output_is_the_jax_packages(name):
    src = CORPUS[name]
    assert _tokens(TTokenizer, TSource, src) == _tokens(JTokenizer, JSource, src)
    t, j = tcompile(src), jcompile(src)
    assert tprinters.dump_parse(t) == jprinters.dump_parse(j)
    assert tprinters.dump_codegen(t) == jprinters.dump_codegen(j)
    lowered = tprinters.dump_lowered(t)
    assert lowered == jprinters.dump_lowered(j)
    assert lowered.startswith("module ")


def test_builtins_dump_is_the_jax_packages():
    assert tprinters.dump_builtins() == jprinters.dump_builtins()
    assert "Envelope" in tprinters.dump_builtins()


# every ScriptError case of tests/test_script.py and tests/test_script_fuzz.py
ERROR_CASES = [
    "M = defmodule x: cob, begin out y end",
    "M = defmodule x: nosuchtype, begin out 1 end",
    "M = defmodule begin out Envelope(note_on=true) end",
    "M = defmodule begin out SineOsc(freq=0, phase=0, freq=1) end",
    "M = defmodule begin out feedback end",
    "M = M2",
    "pi = 3",
    "M = defmodule begin out 1 end\nM = defmodule begin out 2 end",
    "A = B\nB = A",
    "M = defmodule begin out nosuch end",
    "M = defmodule begin out SineOsc(bogus=1, phase=0) end",
    "M = defmodule begin out 1 +",
    "M = defmodule f: curve, begin out Curve(curve=f, function=.nope) end",
    "M = defmodule begin feedback 1 end",
    "", "\n\n\n", "=", "M = defmodule begin",
    "M = defmodule begin out " + "(" * 200 + "1.0" + ")" * 200 + " end",
    "M = defmodule begin out M() end",
    "M = defcurve 1.0 0.0 0.5 0.0 end",
    "\x00\x01\x02",
    "M = defmodule begin out 1e999 end",
]


def _outcome(compile_fn, printers, src):
    """("ok", codegen dump) or ("error", the message, the rendered text)."""
    try:
        cs = compile_fn(src)
    except (JScriptError, TScriptError) as e:
        return ("error", e.message, str(e))
    return ("ok", printers.dump_codegen(cs))


@pytest.mark.parametrize("case", range(len(ERROR_CASES)))
def test_script_errors_are_the_jax_packages(case):
    src = ERROR_CASES[case]
    got = _outcome(tcompile, tprinters, src)
    assert got == _outcome(jcompile, jprinters, src)
    if case < 14:  # tests/test_script.py's cases all raise
        assert got[0] == "error"


@pytest.mark.parametrize("seed", range(6))
def test_mutated_scripts_compile_or_fail_alike(seed):
    """tests/test_script_fuzz.py's mutation fuzz (its seeds): each mutated
    script compiles to the same bytecode or fails with the same diagnostic."""
    rng = random.Random(1000 + seed)
    for _ in range(60):
        src = rng.choice(_JF.CORPUS)
        for _ in range(rng.randrange(1, 4)):
            src = _JF.mutate(src, rng)
        assert _outcome(tcompile, tprinters, src) == _outcome(jcompile, jprinters, src), src


def _both_timelines(song, polyphony, total):
    """The same (params, t, note_id) events through each package's compiler."""
    return (jtl.compile_timelines([JSongEvent(p, t=t, note_id=i) for p, t, i in song],
                                  polyphony, SR, total),
            ttl.compile_timelines([TSongEvent(p, t=t, note_id=i) for p, t, i in song],
                                  polyphony, SR, total))


SONG = [({"freq": 220.0, "note_on": True}, 0.05, 1), ({"freq": 220.0, "note_on": False}, 0.4, 1),
        ({"freq": 330.0, "note_on": True}, 0.5, 2), ({"freq": 440.0, "note_on": True}, 0.6, 3),
        ({"freq": 330.0, "note_on": False}, 0.9, 2), ({"freq": 440.0, "note_on": False}, 1.1, 3)]


@pytest.mark.parametrize("name", ["plan_error_curve_param", "plan_error_curve_fn"])
def test_plan_errors_are_the_jax_packages(name):
    jtls, ttls = _both_timelines([({"note_on": True}, 0.0, 1)], 1, 4096)
    with pytest.raises(JPlanError) as je:
        JScriptInstrument(jcompile(CORPUS[name]), "M").plan(jtls, SR)
    with pytest.raises(TPlanError) as te:
        TScriptInstrument(tcompile(CORPUS[name]), "M").plan(ttls, SR)
    assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# the ops the backend added


CURVE_POINTS = [(0.0, 440.0), (0.05, 880.0), (0.31, 110.0), (0.62, 660.0), (0.9, 20.0)]


@pytest.mark.parametrize("function", ["linear", "smoothstep"])
@pytest.mark.parametrize("block", [1024, 500])
def test_compile_curve_bit_for_bit(function, block):
    """The Curve builtin's segment program: every voice's segments equal,
    and the packed painter programs bit for bit; with notes that reset the
    walk and one that starts inside a block."""
    total = int(1.5 * SR)
    jtls, ttls = _both_timelines(SONG, 2, total)
    for jt, tt in zip(jtls, ttls):
        got = tctl.compile_curve(tt, CURVE_POINTS, function, SR, block)
        assert got == jctl.compile_curve(jt, CURVE_POINTS, function, SR, block)
        assert len(got) > 10
    want = jctl.painter_program([jctl.compile_curve(t, CURVE_POINTS, function, SR, block)
                                 for t in jtls], total)
    got = tctl.painter_program([tctl.compile_curve(t, CURVE_POINTS, function, SR, block)
                                for t in ttls], total)
    np.testing.assert_array_equal(got.starts, want.starts)
    for k, v in want.values.items():
        assert got.values[k].dtype == v.dtype
        np.testing.assert_array_equal(got.values[k], v, err_msg=k)


@pytest.mark.parametrize("guard", [False, True])
def test_phase_plan_freqs_override_bit_for_bit(guard):
    """plan_phase_segments with the script backend's note-rate frequency
    columns (freqs_override, negative and above sr/8 included)."""
    from zang_tpu.ops import oscillators as josc
    from zang_tpu_torch.ops import oscillators as tosc

    jtls, ttls = _both_timelines(SONG, 2, int(1.5 * SR))
    K = max(len(t.starts) for t in jtls)
    freqs = np.random.default_rng(3).uniform(-900.0, 9000.0, (2, K)).astype(np.float32)
    want = josc.plan_phase_segments(jtls, None, SR, guard_div8=guard, freqs_override=freqs)
    got = tosc.plan_phase_segments(ttls, None, SR, guard_div8=guard, freqs_override=freqs)
    np.testing.assert_array_equal(got.starts, want.starts)
    for k, v in want.values.items():
        assert got.values[k].dtype == v.dtype
        np.testing.assert_array_equal(got.values[k], v, err_msg=k)


def test_curve_walk_stream_partial_feeds():
    """CurveWalkStream fed a segment in growing pieces (feed_partial), with
    snapshot/restore, is the JAX package's walk step for step."""
    streams = [mod.CurveWalkStream(CURVE_POINTS, "smoothstep", SR) for mod in (jctl, tctl)]
    for s, e, reset in ((0, 700, True), (0, 3000, True), (3000, 9000, False),
                        (9000, 9100, True), (9000, 30000, True)):
        for st in streams:
            st.feed_partial(s, e, reset)
        assert streams[0].segs == streams[1].segs
        assert streams[0].snapshot() == streams[1].snapshot()
    snaps = [st.snapshot() for st in streams]
    for st in streams:
        st.feed_partial(30000, 50000, False)
    for st, snap in zip(streams, snaps):
        st.restore(snap)
    assert streams[0].segs == streams[1].segs and len(streams[1].segs) > 5


def _mix_case(seed, V=3, n=4096):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((V, n)) * 0.5).astype(np.float32)
    labels = rng.choice(list(tfilt.FILTER_MULS), size=(V, 8))
    seg = np.repeat(labels, n // 8, axis=1)
    muls = np.zeros((3, V, n), np.float32)
    for lab, m in tfilt.FILTER_MULS.items():
        if m is not None:
            muls[:, seg == lab] = np.asarray(m, np.float32)[:, None]
    byp = seg == "bypass"
    act = rng.uniform(size=(V, n)) > 0.1
    cut = rng.uniform(0.05, 0.9, (V, n)).astype(np.float32)
    l0, b0 = (rng.standard_normal(V).astype(np.float32) * 0.1 for _ in range(2))
    return x, muls, byp, act, cut, l0, b0


@pytest.mark.parametrize("res", [0.0, "tensor"])
def test_svf_mix_matches_jax(res):
    """The "mix" type (a filter type that changes by note) with per-sample
    muls, the bypass samples masked out of the recurrence as the backend
    does: within -120 dBFS of the JAX function, end states within 1e-5."""
    x, muls, byp, act, cut, l0, b0 = _mix_case(0)
    r = np.full(x.shape, 0.3, np.float32) if res == "tensor" else res
    mask = act & ~byp
    j = jfilt.svf_filter(jnp.asarray(l0), jnp.asarray(b0), jnp.asarray(x), "mix",
                         jnp.asarray(cut), jnp.asarray(r), jnp.asarray(mask),
                         muls=tuple(jnp.asarray(m) for m in muls))
    t = tfilt.svf_filter(torch.from_numpy(l0), torch.from_numpy(b0), torch.from_numpy(x),
                         "mix", torch.from_numpy(cut),
                         torch.from_numpy(r) if res == "tensor" else r,
                         torch.from_numpy(mask), muls=tuple(torch.from_numpy(m) for m in muls))
    assert _rms_db(t[2].numpy(), j[2]) < -120.0
    for a, b in zip(t[:2], j[:2]):
        assert np.abs(a.numpy() - np.asarray(b)).max() < 1e-5
    assert np.abs(t[2].numpy()).max() > 0.05


def test_svf_bypass_is_the_input():
    x, _, _, act, cut, l0, b0 = _mix_case(1)
    for mask in (None, act):
        j = jfilt.svf_filter(jnp.asarray(l0), jnp.asarray(b0), jnp.asarray(x), "bypass",
                             jnp.asarray(cut), 0.2,
                             None if mask is None else jnp.asarray(mask))
        for fn in (tfilt.svf_filter, tfilt.svf_filter_ref):
            t = fn(torch.from_numpy(l0), torch.from_numpy(b0), torch.from_numpy(x), "bypass",
                   torch.from_numpy(cut), 0.2, None if mask is None else torch.from_numpy(mask))
            for a, b in zip(t, j):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_distortion_clip_bit_for_bit():
    """The clip kind: bit for bit wherever the two packages' gain1 =
    2^(ingain*8-2) agree (all of it when ingain*8-2 is an integer, and the
    0.9 of the sampler config); elsewhere the exp differs by an ulp
    (torch's exp against XLA's) and the output by at most 2 ulps of 1."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 5000)) * 0.8).astype(np.float32)
    ig = rng.uniform(0, 1.2, (2, 5000)).astype(np.float32)
    exact = rng.choice(np.arange(9, dtype=np.float32) / 8, (2, 5000)).astype(np.float32)
    for params in ((0.9, 0.5, 0.0), (exact, 0.7, 0.1), (ig, 0.7, 0.1), (0.3, ig, -0.2)):
        want = np.asarray(jfx.distortion(jnp.asarray(x), "clip",
                                         *(jnp.asarray(p) for p in params)))
        got = tfx.distortion(torch.from_numpy(x), "clip",
                             *(torch.from_numpy(p) if isinstance(p, np.ndarray) else p
                               for p in params)).numpy()
        assert np.abs(got).max() > 0.4
        v = np.asarray(np.float32(params[0]) * np.float32(8.0) - np.float32(2.0))
        same = np.broadcast_to(np.asarray(jnp.exp2(jnp.asarray(v))) == torch.exp(
            torch.from_numpy(v) * tfx.LN2).numpy(), x.shape)
        np.testing.assert_array_equal(got[same], want[same])
        assert np.abs(got - want).max() <= 2.0 ** -22
        if not isinstance(params[0], np.ndarray) or params[0] is exact:
            assert same.all()
        else:
            assert same.mean() > 0.8


# per-sample fake rates: segments of a note-driven rate, passthrough (>= sr)
# and silent (<= 0) segments, and a chunk that ends in each regime
DEC_FAKES = {"rates": [6000.0, 1858.0, 11025.0, 3000.5],
             "ends_passthrough": [6000.0, 1858.0, 48000.0, 44100.0],
             "ends_silent": [44100.0, 6000.0, 0.0, -5.0],
             "mixed": [1858.0, 44099.0, 0.0, 2500.0]}


@pytest.mark.parametrize("name", sorted(DEC_FAKES))
@pytest.mark.parametrize("host_ratio", [True, False], ids=["ratio", "device_division"])
def test_decimator_active_and_ratio_bit_for_bit(name, host_ratio):
    """decimator with a per-sample fake, an active mask and the host-divided
    ratio (the backend's call), or the fake divided on the device; chained
    over two calls: output and end states bit for bit."""
    rng = np.random.default_rng(len(name))
    V, n = 3, 2048
    fakes = np.asarray(DEC_FAKES[name], np.float32)
    jcnt, jval = jnp.full((V,), 0xFFFFFFFF, jnp.uint32), jnp.zeros((V,), jnp.float32)
    tcnt = torch.full((V,), 0xFFFFFFFF, dtype=torch.int64)
    tval = torch.zeros((V,), dtype=torch.float32)
    for k in range(2):
        x = rng.standard_normal((V, n)).astype(np.float32)
        fake = np.repeat(fakes[2 * k:2 * k + 2], n // 2)[None, :].repeat(V, 0)
        act = rng.uniform(size=(V, n)) > 0.2
        ratio = fake / np.float32(SR) if host_ratio else None
        jcnt, jval, jout = jfx.decimator(
            jcnt, jval, jnp.asarray(x), jnp.asarray(fake), SR, active=jnp.asarray(act),
            ratio=None if ratio is None else jnp.asarray(ratio))
        tcnt, tval, tout = tfx.decimator(
            tcnt, tval, torch.from_numpy(x), torch.from_numpy(fake), SR,
            active=torch.from_numpy(act),
            ratio=None if ratio is None else torch.from_numpy(ratio))
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
        np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt).astype(np.int64))
        np.testing.assert_array_equal(tval.numpy(), np.asarray(jval))


# ---------------------------------------------------------------------------
# LiveScript


def _render_port(inst, song=SONG, polyphony=2, total=int(1.2 * SR), chunk=8192):
    tls = ttl.compile_timelines([TSongEvent(p, t=t, note_id=i) for p, t, i in song],
                                polyphony, SR, total)
    return trender.render_performance(trender.Performance([(inst, tls)], SR), total,
                                      chunk, device="cpu").numpy()


def _render_jax(inst, song=SONG, polyphony=2, total=int(1.2 * SR), chunk=8192):
    tls = jtl.compile_timelines([JSongEvent(p, t=t, note_id=i) for p, t, i in song],
                                polyphony, SR, total)
    return np.asarray(jrender.render_performance(jrender.Performance([(inst, tls)], SR),
                                                 total, chunk_size=chunk))


def test_live_script_reload_and_errors(tmp_path):
    path = tmp_path / "live.txt"
    path.write_text(jex.DEMO_SCRIPT)
    live = truntime.LiveScript(str(path), "DemoSynth")
    assert live.ok and live.error is None
    first = live.instrument
    a = _render_port(first)
    # a broken edit: the old instrument keeps playing, the error is kept
    path.write_text("DemoSynth = defmodule begin out nosuch end\n")
    os.utime(path, (1e9, 1e9))
    assert not live.maybe_reload() and not live.ok
    assert isinstance(live.error, TScriptError) and "nosuch" in str(live.error)
    assert live.instrument is first
    # a missing module: the error is built from the port's own Source
    path.write_text(jex.DEMO_SCRIPT)
    os.utime(path, (2e9, 2e9))
    jlive = jruntime.LiveScript(str(path), "DemoSynth")
    for lv in (live, jlive):
        lv.module_name = "Nope"
        assert not lv.reload()
    assert type(live.error.source) is TSource and live.error.source.filename == str(path)
    assert str(live.error) == str(jlive.error) and "Nope" in str(live.error)
    # the edit of the script_runtime example, reloaded
    live.module_name = "DemoSynth"
    path.write_text(jex.DEMO_SCRIPT.replace("color=0.3", "color=0.5"))
    os.utime(path, (3e9, 3e9))
    assert live.maybe_reload() and live.ok and live.instrument is not first
    assert not live.maybe_reload()  # unchanged on disk
    b = _render_port(live.instrument)
    assert a.shape == b.shape and np.abs(a - b).max() > 0.05


# ---------------------------------------------------------------------------
# zangc


def test_zangc_output_module_renders_and_dumps_hold(tmp_path, capsys):
    from zang_tpu.script.zangc import main as jmain

    script = tmp_path / "voice.txt"
    script.write_text(jex.DEMO_SCRIPT)
    flags = ("--dump-parse", "--dump-codegen", "--dump-lowered", "--dump-builtins")
    out = {}
    for tag, main in (("t", tzangc.main), ("j", jmain)):
        paths = [str(tmp_path / f"{tag}{i}.txt") for i in range(len(flags))]
        argv = [str(script), "-o", str(tmp_path / f"gen_{tag}.py")]
        for flag, p in zip(flags, paths):
            argv += [flag, p]
        assert main(argv) == 0
        out[tag] = [open(p).read() for p in paths]
    assert out["t"] == out["j"]
    assert "compiled" in capsys.readouterr().out
    spec = importlib.util.spec_from_file_location("gen_t", tmp_path / "gen_t.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert "import zang_tpu_torch.script" in open(tmp_path / "gen_t.py").read().replace(
        "from zang_tpu_torch.script", "import zang_tpu_torch.script")
    assert mod.EXPORTED_MODULES == ["SweepVoice", "DemoSynth"]
    assert mod.LOWERED_IR == out["t"][2]
    inst = mod.make_instrument("DemoSynth")
    assert isinstance(inst, TScriptInstrument)
    got = _render_port(inst)
    np.testing.assert_array_equal(got, _render_port(
        TScriptInstrument(tcompile(jex.DEMO_SCRIPT), "DemoSynth")))
    assert np.abs(got).max() > 0.1


def test_zangc_error_exit(tmp_path, capsys):
    script = tmp_path / "bad.txt"
    script.write_text("M = defmodule begin out nosuch end")
    assert tzangc.main([str(script)]) == 1
    assert "undeclared" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# user builtins: each of tests/test_script.py's classes and its torch twin


class TorchFold:
    PARAMS = [("input", "buffer"), ("amount", float)]

    def render(self, state, inputs, ctx):
        return state, torch.tanh(inputs["input"] * inputs["amount"])


class JaxFold:
    PARAMS = [("input", "buffer"), ("amount", float)]

    def render(self, state, inputs, ctx):
        return state, jnp.tanh(inputs["input"] * inputs["amount"])


class TorchLag:
    """One-pole smoother, a loop over samples on [V] tensors."""

    PARAMS = [("input", "buffer"), ("coeff", float)]

    def init_state(self, num_voices, device):
        return {"y": torch.zeros((num_voices,), dtype=torch.float32, device=device)}

    def render(self, state, inputs, ctx):
        x, c = inputs["input"], inputs["coeff"][..., 0]
        y, out = state["y"], torch.empty_like(x)
        for i in range(x.shape[-1]):
            y = y + (x[:, i] - y) * c
            out[:, i] = y
        return {"y": y}, out


class JaxLag:
    PARAMS = [("input", "buffer"), ("coeff", float)]

    def init_state(self, num_voices):
        return {"y": jnp.zeros((num_voices,), jnp.float32)}

    def render(self, state, inputs, ctx):
        import jax

        def step(y, xt):
            y = y + (xt - y) * inputs["coeff"][..., 0]
            return y, y

        y, out = jax.lax.scan(step, state["y"], jnp.moveaxis(inputs["input"], -1, 0))
        return {"y": y}, jnp.moveaxis(out, 0, -1)


USER = """
M = defmodule freq: cob, note_on: boolean, begin
    out %s
end
"""


@pytest.mark.parametrize("name, expr", [
    ("Fold", "Fold(input=Gate(note_on) * SineOsc(freq, phase=0), amount=2.5)"),
    ("Lag", "Lag(input=Gate(note_on) * PulseOsc(freq, color=0.5), coeff=0.05)"),
])
def test_user_builtin_torch_twin(name, expr):
    from zang_tpu.script.builtins import user_package as juser
    from zang_tpu.script.compile import builtin_packages as jpackages
    from zang_tpu_torch.script.builtins import user_package as tuser
    from zang_tpu_torch.script.compile import builtin_packages as tpackages

    src = USER % expr
    tcls, jcls = {"Fold": (TorchFold, JaxFold), "Lag": (TorchLag, JaxLag)}[name]
    tcs = tcompile(src, packages=tpackages() + [tuser(type(name, (tcls,), {}))])
    jcs = jcompile(src, packages=jpackages() + [juser(type(name, (jcls,), {}))])
    song, total = SONG[:2], 12000
    got = _render_port(TScriptInstrument(tcs, "M"), song, 1, total, 4096)
    want = _render_jax(JScriptInstrument(jcs, "M"), song, 1, total, 4096)
    assert np.abs(want).max() > 0.1 and np.isfinite(got).all()
    assert _rms_db(got, want) < BUDGET_DB


def test_zangc_add_builtins_torch_module(tmp_path):
    """--add-builtins with a user module written against torch: the
    builtin dump lists it, and the -o module registers it again at load
    and renders it."""
    user_mod = tmp_path / "my_builtins.py"
    user_mod.write_text(
        "import torch\n"
        "class Doubler:\n"
        "    PARAMS = [('input', 'buffer')]\n"
        "    def render(self, state, inputs, ctx):\n"
        "        return state, inputs['input'] * 2.0\n")
    script = tmp_path / "s.txt"
    script.write_text(USER % "Doubler(input=Gate(note_on) * SineOsc(freq, phase=0))")
    dump, gen = tmp_path / "b.txt", tmp_path / "gen.py"
    assert tzangc.main([str(script), "--add-builtins", str(user_mod),
                        "--dump-builtins", str(dump), "-o", str(gen)]) == 0
    assert "module Doubler(input: buffer) [user]" in dump.read_text()
    spec = importlib.util.spec_from_file_location("gen_user", gen)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    doubled = _render_port(mod.make_instrument("M"), SONG[:2], 1, 8192, 8192)
    plain = _render_port(TScriptInstrument(tcompile(
        USER % "Gate(note_on) * SineOsc(freq, phase=0)"), "M"), SONG[:2], 1, 8192, 8192)
    np.testing.assert_array_equal(doubled, plain * 2.0)
