"""The array planners at their edges, against the JAX package's (host only).

The port plans a part's phase, cutoff and envelope over flat per-segment
columns (core/timeline.PartColumns) and walks every voice's envelope in one
native call, reading a stage that starts at t = 0 from a table of its t
sequence (csrc/zang_host.cpp zt_compile_envelopes). The JAX package plans a
voice at a time, and its envelope reference here is its Python walk
(zang_tpu/ops/control.py EnvelopeWalkStream). Every array must be equal in
dtype and bits: voices with no segments, one segment a voice, one voice,
frequencies outside [0, sr/8], the script backend's frequency columns, a
per-voice color, fuzzed multi-voice envelopes, and a stage re-parameterised
mid-flight, which the native walk steps a sample at a time.
"""

import numpy as np
import pytest
import torch

from zang_tpu.core.curves import PaintCurve as JCurve
from zang_tpu.host import instruments as jinst
from zang_tpu.ops import control as jctl
from zang_tpu.ops import oscillators as josc
from zang_tpu_torch import trace
from zang_tpu_torch.core import timeline as ttl
from zang_tpu_torch.core.curves import PaintCurve as TCurve
from zang_tpu_torch.core.notes import SongEvent
from zang_tpu_torch.host import instruments as tinst
from zang_tpu_torch.host import song as tsong
from zang_tpu_torch.ops import control as tctl
from zang_tpu_torch.ops import oscillators as tosc

torch.set_num_threads(1)  # xdist workers share the cores (see PERF.md §7)

SR = 48000.0
TOTAL = 24000


def _tl(starts, note_on, freqs=None, resets=None, total=TOTAL):
    starts = np.asarray(starts, np.int64)
    k = len(starts)
    freqs = [220.0 * (1 + i) for i in range(k)] if freqs is None else freqs
    resets = [i == 0 or bool(note_on[i]) and not bool(note_on[i - 1]) for i in range(k)] \
        if resets is None else resets
    return ttl.SubvoiceTimeline(
        starts=starts, resets=np.asarray(resets, bool),
        params=[{"freq": float(f), "note_on": bool(n)} for f, n in zip(freqs, note_on)],
        total=total)


def _empty():
    return _tl([], [])


PARTS = {
    "empty_voices": lambda: [_empty(), _tl([100, 2000, 9000], [1, 0, 1]), _empty(),
                             _tl([0, 5000], [1, 0]), _empty()],
    "k1": lambda: [_tl([0], [1]), _tl([300], [1]), _tl([12000], [0])],
    "single_voice": lambda: [_tl([10, 4000, 6000, 20000], [1, 0, 1, 0])],
    "all_empty": lambda: [_empty(), _empty()],
}


def _same_program(want, got):
    assert got.starts.dtype == want.starts.dtype
    np.testing.assert_array_equal(got.starts, want.starts)
    assert got.values.keys() == want.values.keys()
    for k, w in want.values.items():
        assert got.values[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got.values[k], w, err_msg=k)


def _jax_walk(tl, fn):
    """The JAX package's Python envelope walk of one voice."""
    st = jctl.EnvelopeWalkStream(SR, fn)
    for k in range(len(tl.starts)):
        e = int(tl.starts[k + 1]) if k + 1 < len(tl.starts) else tl.total
        st.feed(int(tl.starts[k]), e, bool(tl.resets[k]), tl.params[k])
    return st.segs


def _jax_envelopes(tls, fn):
    return jctl.painter_program([_jax_walk(tl, lambda k, p, v=v: fn(v, k, p))
                                 for v, tl in enumerate(tls)], tls[0].total)


def _plan_counts(fn):
    trace.reset_counters("plan.")
    out = fn()
    return out, {k: v for k, v in trace.counters().items() if k.startswith("plan.")}


@pytest.mark.parametrize("guard", [False, True], ids=["plain", "guard_div8"])
@pytest.mark.parametrize("part", sorted(PARTS))
def test_phase_edges(part, guard):
    tls = PARTS[part]()
    _same_program(josc.plan_phase_segments(tls, tinst.default_freq, SR, guard_div8=guard),
                  tosc.plan_phase_segments(tls, tinst.default_freq, SR, guard_div8=guard))


@pytest.mark.parametrize("guard", [False, True], ids=["plain", "guard_div8"])
def test_phase_out_of_range_freqs(guard):
    """Below 0, at and above sr/8: silent and still under the guard."""
    eighth = float(np.float32(SR) / np.float32(8.0))
    freqs = [-300.0, -0.0, 0.0, 1e-3, eighth, float(np.nextafter(np.float32(eighth), 1e9)),
             SR / 4, 0.45 * SR]
    starts = np.arange(len(freqs)) * 2000
    tls = [_tl(starts, [1] * len(freqs), freqs), _tl(starts[:3] + 7, [1, 1, 0], freqs[-3:])]
    _same_program(josc.plan_phase_segments(tls, tinst.default_freq, SR, guard_div8=guard),
                  tosc.plan_phase_segments(tls, tinst.default_freq, SR, guard_div8=guard))


@pytest.mark.parametrize("guard", [False, True], ids=["plain", "guard_div8"])
def test_phase_freqs_override(guard):
    """The script backend's note-rate columns: a [V, K] f64 array wider than
    the part's K, read at each voice's own segments."""
    tls = PARTS["empty_voices"]()
    rng = np.random.default_rng(5)
    freqs = rng.uniform(-100.0, 9000.0, (len(tls), 6))
    _same_program(josc.plan_phase_segments(tls, None, SR, guard_div8=guard, freqs_override=freqs),
                  tosc.plan_phase_segments(tls, None, SR, guard_div8=guard, freqs_override=freqs))


def test_phase_fn_without_array_form():
    """A frequency function with no array form is called a segment."""
    def fn(p):
        return np.float32(p["freq"] * 1.5 + 3.0)

    tls = PARTS["empty_voices"]()
    _same_program(josc.plan_phase_segments(tls, fn, SR, guard_div8=True),
                  tosc.plan_phase_segments(tls, fn, SR, guard_div8=True))


@pytest.mark.parametrize("color", ["scalar", "per_voice"])
@pytest.mark.parametrize("part", ["empty_voices", "k1"])
def test_nice_plan_edges(part, color):
    """NiceInstrument's phase, cutoff and envelope over empty voices and one
    segment a voice, its color a scalar or a value a voice."""
    tls = PARTS[part]()
    c = 0.3 if color == "scalar" else np.linspace(0.1, 0.5, len(tls)).astype(np.float32)
    want = jinst.NiceInstrument(c).plan(tls, SR)
    got = tinst.NiceInstrument(c).plan(tls, SR)
    assert want.keys() == got.keys()
    _same_program(want["phase"], got["phase"])
    _same_program(want["env"], got["env"])
    np.testing.assert_array_equal(got["active_from"], want["active_from"])
    assert got["active_from"].dtype == want["active_from"].dtype


def _fuzz_song(rng, secs):
    song, nid, t = [], 1, 0.05
    while t < secs - 0.5:
        dur = float(rng.uniform(0.005, 1.2))
        f = float(rng.uniform(50.0, 3000.0))
        song.append(SongEvent({"freq": f, "note_on": True}, t=t, note_id=nid))
        song.append(SongEvent({"freq": f, "note_on": False}, t=min(t + dur, secs - 0.2),
                              note_id=nid))
        nid += 1
        t += float(rng.uniform(0.002, 0.6))
    song.sort(key=lambda e: (e.t, e.note_id))
    return song


@pytest.mark.parametrize("seed", range(8))
def test_envelopes_fuzzed(seed):
    """A part of 3 voices from a fuzzed song (stolen voices, notes shorter
    than their attack): one native call against the JAX package's walk a
    voice; an instantaneous attack every fourth seed, a sustain of 1 (no
    decay) every third."""
    rng = np.random.default_rng(seed)
    secs = 4.0
    tls = ttl.compile_timelines(_fuzz_song(rng, secs), 3, SR, int(secs * SR))
    kinds = ["linear", "squared", "cubed"]
    stages = {"attack": (kinds[seed % 3], float(rng.uniform(0.002, 0.3))),
              "decay": (kinds[(seed + 1) % 3], float(rng.uniform(0.01, 0.3))),
              "release": (kinds[(seed + 2) % 3], float(rng.uniform(0.01, 1.0)))}
    if seed % 4 == 0:
        stages["attack"] = ("instantaneous", 0.0)
    sustain = 1.0 if seed % 3 == 0 else float(np.float32(rng.uniform(0.3, 0.95)))

    def const(curve):
        return {name: curve(kind, dur) for name, (kind, dur) in stages.items()} | \
            {"sustain_volume": sustain}

    jconst = const(JCurve)
    want = _jax_envelopes(tls, lambda v, k, p: {**jconst, "note_on": bool(p["note_on"])})
    got, counts = _plan_counts(lambda: tctl.envelope_program(tls, SR, const(TCurve)))
    _same_program(want, got)
    assert counts["plan.envelope_calls"] == 1
    assert counts["plan.stage_stepped"] == 0


def _reparam_part():
    """Voice 0: a held note whose attack, then decay, change length at each
    segment without a new note (so each stage restarts mid-flight, from its
    t); voice 1: the same part's constant envelope."""
    starts = [0, 1000, 2000, 3000, 9000, 9500]
    note_on = [1, 1, 1, 1, 1, 0]
    return [_tl(starts, note_on, resets=[True] + [False] * 5),
            _tl([500, 8000], [1, 0])]


def _reparam_env(curve):
    def env(v, k, p):
        grow = k if v == 0 else 0
        return {"attack": curve("cubed", 0.05 + 0.01 * grow),
                "decay": curve("linear" if grow % 2 else "squared", 0.2 + 0.05 * grow),
                "release": curve("cubed", 0.1),
                "sustain_volume": 0.5, "note_on": bool(p["note_on"])}
    return env


def test_envelope_reparameterised_mid_flight():
    tls = _reparam_part()
    want = _jax_envelopes(tls, _reparam_env(JCurve))
    got, counts = _plan_counts(lambda: tctl.envelope_program(tls, SR, _reparam_env(TCurve)))
    _same_program(want, got)
    assert counts["plan.envelope_calls"] == 1
    assert counts["plan.stage_stepped"] > 0 and counts["plan.stage_table"] > 0


def test_compile_envelope_one_voice_mid_flight():
    """compile_envelope (one voice, the batched entry at V = 1) against the
    JAX package's walk, segment for segment."""
    tl = _reparam_part()[0]
    env = _reparam_env(TCurve)
    got = tctl.compile_envelope(tl, SR, lambda k, p: env(0, k, p))
    jenv = _reparam_env(JCurve)
    want = _jax_walk(tl, lambda k, p: jenv(0, k, p))
    cols = list(zip(*want))
    assert len(got["start"]) == len(want)
    for name, col, dt in zip(("start", "a", "b", "t_step", "t0", "shape"), cols,
                             (np.int64, np.float32, np.float32, np.float32, np.float32,
                              np.int32)):
        np.testing.assert_array_equal(got[name], np.asarray(col, dt), err_msg=name)


def test_note_on_in_release_raises():
    """rc 3 of the native walk: a note_on while in release without a new
    note id is the reference's assert (Envelope.zig:45)."""
    bad = _tl([0, 100, 200], [1, 0, 1], resets=[True, False, False], total=300)
    good = _tl([0, 150], [1, 0], total=300)
    env = {"attack": TCurve.cubed(0.01), "decay": TCurve.cubed(0.1),
           "release": TCurve.cubed(0.5), "sustain_volume": 0.8}
    with pytest.raises(ValueError, match="note_on while in release"):
        tctl.envelope_program([good, bad], SR, env)
    with pytest.raises(ValueError, match="note_on while in release"):
        tctl.compile_envelope(bad, SR, lambda k, p: {**env, "note_on": p["note_on"]})


def test_song_envelope_calls_a_part():
    """The song's plan: one native envelope call a part, every stage walk
    read from a table."""
    _, counts = _plan_counts(lambda: tsong.build_performance(20 * 48000))
    assert counts["plan.envelope_calls"] == 2
    assert counts["plan.stage_table"] > 0 and counts["plan.stage_stepped"] == 0


@pytest.mark.parametrize("case", ["tuples", "empty_lists", "native_dicts"])
def test_painter_program_packs_like_the_jax_package(case):
    """painter_program of per-voice segment lists (the Python walkers') and
    of the native compiler's dicts, voices with no segment among them."""
    tls = PARTS["empty_voices"]()
    env = {"attack": TCurve.cubed(0.01), "decay": TCurve.cubed(0.1),
           "release": TCurve.cubed(0.5), "sustain_volume": 0.8}
    if case == "native_dicts":
        segs = [tctl.compile_envelope(tl, SR, lambda k, p: {**env, "note_on": p["note_on"]})
                for tl in tls]
    elif case == "tuples":
        segs = [tctl.compile_gate(tl) for tl in tls]
    else:
        segs = [[], [(0, 0.5, 0.0, 0.0, 0.0, 0)], []]
    _same_program(jctl.painter_program(segs, TOTAL), tctl.painter_program(segs, TOTAL))
