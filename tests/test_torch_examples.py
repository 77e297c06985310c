"""The port's example configs (zang_tpu_torch/host/examples.py) and their
planners against zang_tpu's.

- Planners, bit for bit: twelve_tet, freq_to_ifreq, sine_osc's counters,
  trisaw_wave,
  compile_gate, paint_table, compile_portamento, the mouse's controller
  programs and the instruments' plans. The elementwise ones are compared
  with the JAX package run op by op (not under jit, where XLA fuses and
  rounds otherwise).
- Each ported example through its public entry on the CPU, against the JAX
  example at the seconds of tests/test_examples_golden.py: every channel
  < -90 dBFS RMS, the eight zangscript examples included
  (test_torch_examples_jax.py). The detuned example is held in two parts,
  as the JAX
  package holds its own oracle twin (zang_tpu/oracle/examples.py
  detuned_warble): its warble multiplier feeds a phase counter, so a
  last-place difference grows over seconds. (a) the port's multiplier
  against the JAX trajectory, a chunk at a time from the same filter state,
  within 1e-5 relative; (b) the cascade on the JAX trajectory < -90 dBFS.
- The committed golden windows (zang_tpu_torch/data/examples_golden_jax.npz,
  what chip_smoke.py holds the card to) against the port's CPU render at
  each example's default seconds: test_torch_examples_golden.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zang_tpu.core import timeline as jtl
from zang_tpu.core import twelve_tet as jtt
from zang_tpu.core.notes import SongEvent as JSongEvent
from zang_tpu.graph import render as jrender
from zang_tpu.host import examples as jex
from zang_tpu.host import instruments as jti
from zang_tpu.ops import control as jctl
from zang_tpu.ops import filters as jfilt
from zang_tpu.ops import noise as jnoise
from zang_tpu.ops import oscillators as josc
from zang_tpu.ops import scan as jscan
from zang_tpu.oracle import examples as joex
from zang_tpu_torch import convert
from zang_tpu_torch.core import timeline as ttl
from zang_tpu_torch.core import twelve_tet as ttt
from zang_tpu_torch.core.notes import SongEvent as TSongEvent
from zang_tpu_torch.core.wav import read_wav
from zang_tpu_torch.device import arrays_to_device
from zang_tpu_torch.graph import render as trender
from zang_tpu_torch.graph.render import render_performance
from zang_tpu_torch.host import examples as tex
from zang_tpu_torch.host import instruments as tti
from zang_tpu_torch.ops import control as tctl
from zang_tpu_torch.ops import delay as tdelay
from zang_tpu_torch.ops import filters as tfilt
from zang_tpu_torch.ops import oscillators as tosc
from zang_tpu_torch.ops import scan as tscan

torch.set_num_threads(1)  # xdist workers share the cores (see PERF.md §7)

BUDGET_DB = -90.0
SR = 48000.0
# tests/test_examples_golden.py:23-44
SECONDS = {"play": 2.0, "arpeggiator": 2.0, "polyphony": 2.0, "portamento": 2.0,
           "mouse": 2.0, "fmsynth": 2.0, "sampler": 2.0, "polyphony2": 2.0,
           "delay": 2.5, "song": 4.0, "stereo": 2.0,
           # the zangscript examples (the port's script backend)
           "envelope": 2.0, "vibrato": 2.0, "curve": 2.0, "laser": 2.0, "subsong": 3.0,
           "two": 2.5, "script": 2.0, "script_runtime": 2.0}
DETUNED_SECONDS = 2.0  # tests/test_examples_golden.py; held in two parts below


def _rms_db(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return 20 * np.log10(np.sqrt((d ** 2).mean()) + 1e-30)


def _leaves(prog, path=""):
    if hasattr(prog, "starts") and hasattr(prog, "values"):
        yield path + ".starts", prog.starts
        for k, v in prog.values.items():
            yield f"{path}.{k}", v
    elif isinstance(prog, dict):
        for k, v in prog.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(prog, (list, tuple)):
        for i, v in enumerate(prog):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, np.asarray(prog)


def _assert_same(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


def _song(event_cls, notes, extra=None):
    """(t_on, duration, freq) notes as each package's SongEvents."""
    song = []
    for i, (t0, dur, f) in enumerate(notes):
        for t, on in ((t0, True), (t0 + dur, False)):
            p = {"freq": float(np.float32(f)), "note_on": on, **(extra or {})}
            song.append(event_cls(p, t=t, note_id=i + 1))
    song.sort(key=lambda e: (e.t, e.note_id))
    return song


def _timelines(notes, polyphony, seconds=2.0, extra=None):
    """The same song compiled by each package: (JAX timelines, port's)."""
    total = int(seconds * SR)
    return (jtl.compile_timelines(_song(JSongEvent, notes, extra), polyphony, SR, total),
            ttl.compile_timelines(_song(TSongEvent, notes, extra), polyphony, SR, total))


NOTES = [(0.1 + 0.23 * i, 0.3 + 0.05 * (i % 3), 440.0 * jtt.rel_freq(n))
         for i, n in enumerate([-9, -5, -2, 0, 3, 7, 0, -5])]


# ---------------------------------------------------------------------------
# planners and elementwise ops, bit for bit


def test_twelve_tet_is_the_same_table():
    names = [f"{n}{o}" for n, _ in jtt._NAMES for o in range(9)]
    assert [getattr(ttt, k) for k in names] == [getattr(jtt, k) for k in names]
    assert [ttt.rel_freq(k) for k in range(-60, 60)] == [jtt.rel_freq(k)
                                                          for k in range(-60, 60)]


def test_freq_to_ifreq_bit_for_bit():
    rng = np.random.default_rng(0)
    freq = np.concatenate([
        rng.uniform(-24000.0, 24000.0, 5000), [0.0, -0.0, 1e-3, -1e-3, 48000.0,
                                               -48000.0, 1e9, -1e9]]).astype(np.float32)
    for sr in (48000.0, 44100.0):
        got = tscan.freq_to_ifreq(torch.from_numpy(freq), sr).numpy()
        want = np.asarray(jscan.freq_to_ifreq(jnp.asarray(freq), sr))
        np.testing.assert_array_equal(got, want.astype(np.int64))
    # a negative frequency is the two's complement of its magnitude's
    mag = tscan.freq_to_ifreq(torch.from_numpy(np.abs(freq)), sr).numpy()
    neg = freq < 0
    assert ((got[neg] + mag[neg]) % 2 ** 32 == 0).all() and neg.sum() > 2000


def test_sine_osc_counters_bit_for_bit():
    """Counters chained over two calls, with a mask and a phase offset: the
    u32 counters bit for bit, the values within 2^-23 (torch's sin and XLA's
    differ by an ulp on a few per cent of the angles)."""
    rng = np.random.default_rng(1)
    V, n = 3, 3000
    t_cnt = torch.zeros(V, dtype=torch.int64)
    j_cnt = jnp.zeros(V, jnp.uint32)
    for _ in range(2):
        freq = rng.uniform(-900.0, 5000.0, (V, n)).astype(np.float32)
        act = rng.uniform(size=(V, n)) > 0.2
        t_cnt, to = tosc.sine_osc(t_cnt, torch.from_numpy(freq), 0.25, SR,
                                  torch.from_numpy(act))
        j_cnt, jo = josc.sine_osc(j_cnt, jnp.asarray(freq), 0.25, SR, jnp.asarray(act))
        np.testing.assert_array_equal(t_cnt.numpy(), np.asarray(j_cnt).astype(np.int64))
        assert np.abs(to.numpy() - np.asarray(jo)).max() <= 2.0 ** -23
        assert _rms_db(to.numpy(), jo) < -150.0


def test_trisaw_wave_bit_for_bit():
    rng = np.random.default_rng(2)
    n = 200000
    ifreq = rng.integers(1 << 20, 1 << 27, n).astype(np.uint32)
    cnt = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    cnt[:2000] = ifreq[:2000] // 3  # the samples just after a wrap
    valid = rng.uniform(size=n) > 0.1
    for color in (0.0, 0.3):
        got = tosc.trisaw_wave(torch.from_numpy(cnt.astype(np.int64)),
                               torch.from_numpy(ifreq.astype(np.int64)), color,
                               torch.from_numpy(valid)).numpy()
        want = np.asarray(josc.trisaw_wave(jnp.asarray(cnt), jnp.asarray(ifreq), color,
                                           jnp.asarray(valid)))
        np.testing.assert_array_equal(got, want)


def test_compile_gate_bit_for_bit():
    jtls, ttls = _timelines(NOTES, 3)
    for jt, tt in zip(jtls, ttls):
        assert tctl.compile_gate(tt) == jctl.compile_gate(jt)
    _assert_same(jctl.painter_program([jctl.compile_gate(t) for t in jtls], jtls[0].total),
                 tctl.painter_program([tctl.compile_gate(t) for t in ttls], ttls[0].total))


@pytest.mark.parametrize("kind", ["linear", "squared", "cubed"])
def test_paint_table_bit_for_bit(kind):
    for duration, t0 in ((0.1, 0.0), (0.5, 0.37), (0.0123, 0.9)):
        got = tctl.paint_table(kind, duration, SR, t0)
        want = jctl.paint_table(kind, duration, SR, t0)
        for g, w in zip(got, want):
            assert np.asarray(g).dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g, w)


def _porta_fn(k, p):
    from zang_tpu_torch.core.curves import PaintCurve

    return {"curve": PaintCurve.cubed(0.5), "goal": np.float32(p["freq"]),
            "note_on": bool(p["note_on"]), "prev_note_on": bool(p["prev_note_on"])}


def _jporta_fn(k, p):
    from zang_tpu.core.curves import PaintCurve

    return {"curve": PaintCurve.cubed(0.5), "goal": np.float32(p["freq"]),
            "note_on": bool(p["note_on"]), "prev_note_on": bool(p["prev_note_on"])}


def test_compile_portamento_bit_for_bit():
    """The portamento example's glide program, legato moves included."""
    moves = [(0.2, 130.8), (0.8, 196.0), (1.4, 164.8), (2.0, None), (2.4, 220.0),
             (2.5, 230.0), (3.2, None)]
    songs = {JSongEvent: [], TSongEvent: []}
    for cls, song in songs.items():
        nid, prev_on = 0, False
        for t, f in moves:
            if f is not None:
                nid += 1
                song.append(cls({"freq": float(np.float32(f)), "note_on": True,
                                 "prev_note_on": prev_on}, t=t, note_id=nid))
                prev_on = True
            else:
                song.append(cls({"freq": song[-1].params["freq"], "note_on": False,
                                 "prev_note_on": prev_on}, t=t, note_id=nid))
                prev_on = False
    total = int(4.0 * SR)
    jt = jtl.compile_timelines(songs[JSongEvent], 1, SR, total)[0]
    tt = ttl.compile_timelines(songs[TSongEvent], 1, SR, total)[0]
    got = tctl.compile_portamento(tt, SR, _porta_fn)
    assert got == jctl.compile_portamento(jt, SR, _jporta_fn)
    assert len(got) > 5


@pytest.mark.parametrize("mode", [0, 1])
def test_mouse_controller_programs_bit_for_bit(mode):
    """Pointer moves (same-frame moves too) into the ratio and multiplier
    glides, in both modulator modes."""
    ctl = {"x": [(0, 0.3), (24000, 0.5), (48000, 0.8), (48000, 0.1), (72000, 0.4)],
           "y": [(0, 0.5), (30000, 0.6), (60000, 0.3)]}
    jtls, ttls = _timelines(NOTES[:3], 1)
    _assert_same(jti.MousePMInstrument(mode, controllers=ctl).plan(jtls, SR),
                 tti.MousePMInstrument(mode, controllers=ctl).plan(ttls, SR))


FM_CONFIGS = [{}, {"mod_waveform": 2, "algorithm": 0, "mod_vibrato": 1,
                   "car_tremolo": 1, "tremolo_depth": 0, "mod_adr": (3, 9, 5, 12)}]


@pytest.mark.parametrize("cfg", FM_CONFIGS, ids=["default", "additive"])
def test_fmsynth_plan_bit_for_bit(cfg):
    jtls, ttls = _timelines(NOTES, 8)
    j, t = jti.FMSynthInstrument(**cfg), tti.FMSynthInstrument(**cfg)
    assert (t.mod, t.car, t.algorithm) == (j.mod, j.car, j.algorithm)
    _assert_same(j.plan(jtls, SR), t.plan(ttls, SR))


@pytest.mark.parametrize("name", ["FilteredSawtoothInstrument", "HardSquareInstrument",
                                  "SquareWithEnvelope"])
def test_instrument_plan_bit_for_bit(name):
    jtls, ttls = _timelines(NOTES, 2)
    _assert_same(getattr(jti, name)().plan(jtls, SR), getattr(tti, name)().plan(ttls, SR))


# ---------------------------------------------------------------------------
# the examples through their public entries, against the JAX package


@functools.lru_cache(maxsize=None)
def _pair(name):
    s = SECONDS[name]
    ja, jsr = jex.EXAMPLES[name](seconds=s)
    ta, tsr = tex.EXAMPLES[name](seconds=s, device="cpu")
    return np.asarray(ja), jsr, ta.numpy(), tsr


def test_registry_is_the_ten_examples():
    """All twenty by now: the ten, stereo, detuned and the eight zangscript
    examples, in the JAX package's order."""
    assert sorted(tex.EXAMPLES) == sorted([*SECONDS, "detuned"])
    assert list(tex.EXAMPLES) == list(jex.EXAMPLES)


# ---------------------------------------------------------------------------
# stereo and detuned: the threefry noise tape, the pan counter, the warble


@pytest.mark.parametrize("freq", [320.0, 380.0, 4.0, 880.0 * 8.0])
def test_example_cutoffs_are_the_jax_packages_bits(freq):
    """The stereo and detuned filters' cutoffs. At 4 Hz, 1 - cos is one
    ulp of 1: a cos one ulp off would make the cutoff 0."""
    want = np.asarray(jfilt.cutoff_from_frequency(jnp.float32(freq), jnp.float32(SR)))
    got = tfilt.cutoff_from_frequency(freq, SR)
    assert got == want and got > 0.0 and got.dtype == np.float32


def _step_both(jperf, tperf, n_chunks, chunk, resume_at=0):
    """Step both packages chunk by chunk; after chunk `resume_at` the port
    takes the JAX package's state (convert.from_jax_state). Yields (i, JAX
    state, port state, JAX out, port out)."""
    total = n_chunks * chunk
    jxs, _ = jperf.chunk_xs(total, chunk)
    txs, _ = trender.host_slices(tperf, total, chunk)
    jstep = jrender.make_stream_step(jperf, chunk)
    jstate, tstate = jperf.init_state(), tperf.init_state("cpu")
    static = arrays_to_device(tperf.programs, "cpu")
    for i in range(n_chunks):
        jstate, jout = jstep(jstate, jnp.int32(i * chunk),
                             jax.tree_util.tree_map(lambda a, i=i: a[i], jxs))
        ctx = trender.RenderCtx(tperf.sample_rate,
                                torch.arange(chunk, dtype=torch.int32) + i * chunk,
                                i * chunk, chunk)
        tstate, tout = tperf.render_chunk(
            tstate, arrays_to_device(trender.chunk_slice(txs, i), "cpu"),
            ctx, static)
        yield i, jstate, tstate, np.asarray(jout), tout.numpy()
        if i == resume_at:
            tstate = convert.from_jax_state(jstate, "cpu")


def test_stereo_state_across_calls():
    """Three chunks of the stereo part in both packages: the 0.1 Hz pan
    counter bit for bit, the filter state within 1e-5, and the port resumes
    from the JAX state (the u32 counter carried as int64)."""
    jtls, ttls = _timelines([(0.0, 1.0, 1.0)], 1, seconds=1.0)
    jperf = jrender.Performance([(jex._StereoNoise(), jtls)], SR, num_channels=2)
    tperf = convert.from_jax_performance(jperf, "cpu")
    assert isinstance(tperf.parts[0][0], tex.StereoNoise)
    for i, jstate, tstate, jout, tout in _step_both(jperf, tperf, 3, 16384):
        (js,), (ts,) = jstate[0], tstate[0]
        assert ts["pan_cnt"].dtype == torch.int64 and ts["pan_cnt"].dim() == 0
        assert int(ts["pan_cnt"]) == int(js["pan_cnt"]) > 0
        for k in ("l0", "b0"):
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), rtol=0, atol=1e-5)
        assert tout.shape == (2, 16384) and _rms_db(tout, jout) < -120.0
        assert np.abs(jout).max() > 0.3


def test_detuned_warble_multiplier_matches_jax():
    """Part (a): exp2(4 * lowpass(white, 4 Hz)), a chunk at a time from the
    JAX package's carried filter state, against the JAX ops of
    oracle.examples.detuned_warble: largest relative deviation under 1e-5
    (measured 1.2e-7), end states within 1e-5."""
    V, chunk, n_chunks = 2, tex.DEFAULT_CHUNK, 4
    want_all = joex.detuned_warble(V, n_chunks * chunk, SR, chunk)
    cut = jfilt.cutoff_from_frequency(jnp.float32(4.0), jnp.float32(SR))
    nl = nb = jnp.zeros((V,), jnp.float32)
    worst = 0.0
    for i in range(n_chunks):
        c0 = i * chunk
        ctx = trender.RenderCtx(SR, torch.arange(chunk, dtype=torch.int32) + c0, c0, chunk)
        tl, tb, mul = tex.DetunedInstrument.warble(
            torch.from_numpy(np.array(nl)), torch.from_numpy(np.array(nb)), ctx)
        white, _ = jnoise.white_noise(
            jax.random.fold_in(jax.random.PRNGKey(tex.DETUNED_SEED), c0), (V, chunk))
        nl, nb, w = jfilt.svf_filter(nl, nb, white, "low_pass", cut, 0.0)
        want = np.asarray(jnp.exp2(w * jnp.float32(4.0)))
        np.testing.assert_array_equal(want, want_all[:, c0:c0 + chunk])
        worst = max(worst, float(np.abs(mul.numpy() / want - 1.0).max()))
        assert np.abs(tl.numpy() - np.asarray(nl)).max() < 1e-5
        assert np.abs(tb.numpy() - np.asarray(nb)).max() < 1e-5
    print(f"warble multiplier: largest relative deviation {worst:.3e}")
    assert worst < 1e-5 and want_all.max() - want_all.min() > 0.01


@functools.lru_cache(maxsize=None)
def _detuned_jax():
    ja, jsr = jex.ex_detuned(seconds=DETUNED_SECONDS)
    total = int(DETUNED_SECONDS * jsr)
    return np.asarray(ja), jsr, joex.detuned_warble(2, total, jsr, jex.DEFAULT_CHUNK)


def test_detuned_cascade_matches_jax_on_its_trajectory():
    """Part (b): trisaw, envelope, final lowpass and echoes on the JAX
    warble trajectory < -90 dBFS on both channels; the free-running render
    (the port's own warble) is reported, not bounded."""
    ja, jsr, warble = _detuned_jax()
    ta, tsr = tex.ex_detuned(seconds=DETUNED_SECONDS, device="cpu", warble_mul=warble)
    assert ta.shape == ja.shape and tsr == jsr and np.abs(ja).max() > 0.1
    assert not np.array_equal(ja[0], ja[1])
    for ch in range(2):
        assert _rms_db(ta[ch].numpy(), ja[ch]) < BUDGET_DB
    free, _ = tex.ex_detuned(seconds=DETUNED_SECONDS, device="cpu")
    print("detuned free-running vs JAX: "
          + ", ".join(f"{_rms_db(free[ch].numpy(), ja[ch]):.1f}" for ch in range(2))
          + " dBFS")
    assert free.shape == ta.shape and bool(torch.isfinite(free).all())
    assert not torch.equal(free, ta)


def test_detuned_state_across_calls():
    """The detuned part planned by the JAX package, carried across
    (convert): the u32 phase counter and the four filter states after each
    chunk, the port resuming from the JAX state after the first."""
    notes = [(0.05, 0.3, 130.8), (0.2, 0.4, 196.0), (0.5, 0.3, 261.6)]
    jtls, _ = _timelines(notes, 2, seconds=1.0)

    def jpost(state, mix, ctx):
        from zang_tpu.ops import delay as jdelay

        return jdelay.stereo_echoes(state, mix, 0.6, 0.7)

    def jpost_init():
        from zang_tpu.ops import delay as jdelay

        return jdelay.stereo_echoes_init(3000)

    jperf = jrender.Performance([(jex._DetunedInstrument(), jtls)], SR, num_channels=2,
                                post_fn=jpost, post_init_state=jpost_init)
    tperf = convert.from_jax_performance(
        jperf, "cpu", post=(lambda st, mix, ctx: tdelay.stereo_echoes(st, mix, 0.6, 0.7),
                            lambda device: tdelay.stereo_echoes_init(3000, device)))
    assert isinstance(tperf.parts[0][0], tex.DetunedInstrument)
    _assert_same(jperf.programs[0], tex.DetunedInstrument().plan(
        _timelines(notes, 2, seconds=1.0)[1], SR))
    for i, jstate, tstate, jout, tout in _step_both(jperf, tperf, 2, 16384):
        (js,), (ts,) = jstate[0], tstate[0]
        # the u32 phase: a last-place difference of the warble moves a
        # sample's step by a count or so, so after a chunk the two counters
        # differ by under 2^18 of 2^32 (measured: under 2^13)
        d = (ts["cnt"].numpy() - np.asarray(js["cnt"]).astype(np.int64)) % 2 ** 32
        print(f"detuned phase counters after chunk {i}: differ by "
              f"{np.minimum(d, 2 ** 32 - d).max()} of 2^32")
        assert np.minimum(d, 2 ** 32 - d).max() < 2 ** 18
        for k in ("nl", "nb", "l", "b"):
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), rtol=0, atol=1e-5)
        assert ts["cnt"].dtype == torch.int64 and _rms_db(tout, jout) < BUDGET_DB
    assert np.abs(jout).max() > 0.05


def test_arpeggiator_is_exact_but_at_the_pulse_corners():
    """HardSquare's pulse and gate are exact in both packages: the renders
    agree bit for bit except at the anti-aliasing corner samples, where
    XLA's fused kernels round the corner terms otherwise (the port equals
    the JAX ops run one by one, test_trisaw_wave_bit_for_bit and
    tests/test_torch_ops.py)."""
    ja, _, ta, _ = _pair("arpeggiator")
    diff = ta != ja
    assert diff.sum() < 0.01 * ja.size
    assert np.abs(ta - ja).max() < 1e-6


def test_example_runs_from_converted_jax_parts():
    """convert carries the new instruments across: an FM synth with a
    non-default config and a NiceInstrument subclass (matched on the MRO),
    planned by the JAX package, render on the port within the budget."""
    class JDecimatedNice(jti.NiceInstrument):
        def __init__(self):
            super().__init__(0.3)

    jtls, _ = _timelines(NOTES, 4, seconds=0.5)
    total = jtls[0].total
    jperf = jrender.Performance(
        [(jti.FMSynthInstrument(**FM_CONFIGS[1]), jtls), (JDecimatedNice(), jtls),
         (jti.FilteredSawtoothInstrument(), jtls[:1]),
         (jti.HardSquareInstrument(), jtls[1:2])], SR)
    want = np.asarray(jrender.render_performance(jperf, total, chunk_size=4096))
    tperf = convert.from_jax_performance(jperf, "cpu")
    assert isinstance(tperf.parts[1][0], tti.NiceInstrument)
    assert tperf.parts[0][0].mod == jperf.parts[0][0].mod
    state = convert.from_jax_state(jperf.init_state(), "cpu")
    assert state[0][0]["mod_cnt"].dtype == torch.int64
    assert state[0][0]["mod_fb1"].dtype == torch.float32
    got = render_performance(tperf, total, 4096, device="cpu", state=state).numpy()
    assert _rms_db(got, want) < BUDGET_DB


def test_cli_writes_the_jax_clis_wav(tmp_path):
    """python -m zang_tpu_torch.host.examples NAME out.wav --seconds S
    --device cpu: the WAV of zang-examples (s16 at volume 0.25)."""
    from zang_tpu.core.mixdown import mixdown_s16_np

    out = tmp_path / "porta.wav"
    tex.main(["portamento", str(out), "--seconds", "2", "--device", "cpu"])
    w = read_wav(str(out))
    ja, jsr, _, _ = _pair("portamento")
    want = mixdown_s16_np(ja, 0.25)[0]
    assert w.sample_rate == int(jsr) and w.num_channels == 1
    got = np.frombuffer(w.data, np.int16)
    assert got.shape == want.shape and np.abs(got.astype(int) - want).max() <= 1


# ---------------------------------------------------------------------------
# the golden windows chip_smoke.py holds the card to


# ---------------------------------------------------------------------------
# the zangscript examples


def test_demo_script_is_the_jax_packages():
    """zang_tpu_torch/data/demo_synth.txt is the JAX package's DEMO_SCRIPT,
    byte for byte (the script and midi_script paths read the file)."""
    assert tex.DEMO_SCRIPT == jex.DEMO_SCRIPT
