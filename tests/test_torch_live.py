"""The port's live tier on the CPU against the JAX package's.

zang_tpu_torch.host.live (LiveSession), host/liveplan.py and
script/liveplan.py (the incremental planners), host/snapshot.py and
convert.from_jax_live_session, each fed the same events as its JAX
counterpart (numpy-seeded key streams, the Toccata's first seconds):

- planner windows: array for array, bit for bit, over a random event
  stream, for every instrument's live_planner and DemoSynth's
  ScriptLivePlanner; the incremental path renders the full re-plan's bits;
- a session's audio within TOL_DB (-110 dBFS, tests/test_live.py's bound)
  of the JAX session's, and of the port's own offline render;
- snapshot and restore continue bit for bit; a mismatched spec is refused;
- a JAX session carried across mid-play continues within TOL_DB.

On the CPU the JAX side runs its Pallas K2 and K5 in interpret mode (the
JAX package's own CPU setting) and the port its plain versions.
"""

import os

import numpy as np
import pytest
import torch

from zang_tpu.core.notes import NoteTracker as JNoteTracker
from zang_tpu.host import instruments as ji
from zang_tpu.host.live import LiveSession as JLiveSession
from zang_tpu.ops import delay as jdelay
from zang_tpu.script import compile_script as jcompile
from zang_tpu.script.jax_backend import ScriptInstrument as JScript
from zang_tpu_torch import convert
from zang_tpu_torch.core.notes import NoteTracker
from zang_tpu_torch.core.timeline import compile_timelines
from zang_tpu_torch.graph.render import Performance, render_performance
from zang_tpu_torch.host import instruments as ti
from zang_tpu_torch.host import liveplan as tlp
from zang_tpu_torch.host.live import LiveSession, push_tracked
from zang_tpu_torch.host.song import live_events
from zang_tpu_torch.ops import delay as tdelay
from zang_tpu_torch.script.compile import compile_script as tcompile
from zang_tpu_torch.script.torch_backend import ScriptInstrument as TScript

torch.set_num_threads(1)  # xdist workers share the cores (see PERF.md §7)

SR = 48000.0
BLOCK = 1024
TOL_DB = -110.0  # live vs reference (tests/test_live.py:24-54)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = open(os.path.join(ROOT, "zang_tpu_torch", "data", "demo_synth.txt")).read()
KEYS = "zxcvbnmqwertyu"


def _rms_db(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return 20 * np.log10(np.sqrt((d ** 2).mean()) + 1e-30)


def _demo(mod):
    return (JScript(jcompile(DEMO), "DemoSynth") if mod is ji
            else TScript(tcompile(DEMO), "DemoSynth"))


# instrument name -> maker over a module (ji or ti), polyphony
INSTRUMENTS = {
    "pmosc": (lambda m: m.PMOscInstrument(1.0), 2),
    "nice": (lambda m: m.NiceInstrument(0.3), 2),
    "hardsquare": (lambda m: m.HardSquareInstrument(), 2),
    "filteredsaw": (lambda m: m.FilteredSawtoothInstrument(), 2),
    "weirdsquare": (lambda m: m.SquareWithEnvelope(weird=True), 2),
    "fmsynth": (lambda m: m.FMSynthInstrument(), 3),
    "mousepm": (lambda m: m.MousePMInstrument(), 2),
    "demosynth": (_demo, 2),
}


def _key_stream(seed, blocks, n_keys=2):
    """[(key, down)] a block: random presses and releases (a polyphony of 2
    steals voices)."""
    rng = np.random.default_rng(seed)
    return [[(KEYS[rng.integers(0, len(KEYS))], bool(rng.integers(0, 2)))
             for _ in range(rng.integers(0, n_keys + 1))] for _ in range(blocks)]


def _actions(name):
    """Between-block changes: device- and plan-kind parameters (FMSynth),
    controller moves (MousePM)."""
    if name == "fmsynth":
        changes = {2: ("mod_waveform", 2), 3: ("mod_feedback", 2), 4: ("mod_attack", 3),
                   6: ("car_waveform", 3), 7: ("algorithm", 0), 8: ("mod_vibrato", 1)}
        return lambda s, b: s.set_param(0, *changes[b]) if b in changes else None
    if name == "mousepm":
        moves = {1: ("x", 0.9), 3: ("y", 0.1), 5: ("x", 0.2)}
        return lambda s, b: s.push_controller(0, *moves[b]) if b in moves else None
    return None


def _play(session, stream, actions=None, part=0):
    out = []
    for b, keys in enumerate(stream):
        for k, down in keys:
            session.key_event(part, k, down)
        if actions is not None:
            actions(session, b)
        out.append(session.render_block())
    return np.concatenate(out, axis=-1)


def _pair(name, blocks=10, seed=0):
    make, poly = INSTRUMENTS[name]
    stream = _key_stream(seed, blocks)
    port = _play(LiveSession([(make(ti), poly)], SR, BLOCK, device="cpu"), stream,
                 _actions(name))
    ref = _play(JLiveSession([(make(ji), poly)], SR, BLOCK), stream, _actions(name))
    return port, ref


# -- planner windows ----------------------------------------------------------


def _assert_tree_equal(got, want, path="window"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{path}[{i}]")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=path)


def _events(seed, V, blocks):
    """Per block: sorted (v, start, reset, params) note on/off pairs a voice."""
    rng = np.random.default_rng(seed)
    held = [None] * V
    per_block = []
    for b in range(blocks):
        evs = []
        for v in range(V):
            if rng.uniform() < 0.4:
                start = b * BLOCK + int(rng.integers(0, BLOCK))
                if held[v] is None:
                    f = float(np.float32(110.0 * 2 ** (rng.integers(0, 24) / 12.0)))
                    evs.append((v, start, True, {"freq": f, "note_on": True}))
                    held[v] = f
                else:
                    evs.append((v, start, False, {"freq": held[v], "note_on": False}))
                    held[v] = None
        per_block.append(sorted(evs, key=lambda e: (e[1], e[0])))
    return per_block


@pytest.mark.parametrize("name", ["pmosc", "nice", "hardsquare", "filteredsaw", "mousepm",
                                  "fmsynth", "demosynth"])
def test_planner_windows_match_jax(name):
    """Each live_planner's windows equal the JAX package's, array for array,
    over a random event stream (and controller moves for MousePM)."""
    make, _ = INSTRUMENTS[name]
    V, blocks, KP = 3, 12, 8
    jp = make(ji).live_planner(V, SR)
    tp = make(ti).live_planner(V, SR)
    if name == "demosynth":
        assert type(tp).__module__ == "zang_tpu_torch.script.liveplan"
    for b, evs in enumerate(_events(7, V, blocks)):
        for v, start, reset, params in evs:
            jp.extend(v, start, reset, dict(params))
            tp.extend(v, start, reset, dict(params))
        if name == "mousepm" and b % 3 == 1:
            for p in (jp, tp):
                p.extend_controller("x", b * BLOCK + 100, 0.1 * b)
        f0 = b * BLOCK
        _assert_tree_equal(tp.window(f0, f0 + BLOCK, KP), jp.window(f0, f0 + BLOCK, KP))


@pytest.mark.parametrize("name", ["nice", "fmsynth", "mousepm", "demosynth"])
def test_incremental_equals_replan(name, monkeypatch):
    """The incremental planners render the full re-plan path's bits
    (ZANG_LIVE_INC=0 re-plans every block with instrument.plan)."""
    make, poly = INSTRUMENTS[name]
    stream = _key_stream(3, 10)
    inc = LiveSession([(make(ti), poly)], SR, BLOCK, device="cpu")
    monkeypatch.setenv("ZANG_LIVE_INC", "0")
    full = LiveSession([(make(ti), poly)], SR, BLOCK, device="cpu")
    assert inc.parts[0].planner is not None and full.parts[0].planner is None
    np.testing.assert_array_equal(_play(inc, stream, _actions(name)),
                                  _play(full, stream, _actions(name)))


# -- sessions against the JAX package ------------------------------------------


@pytest.mark.parametrize("name", list(INSTRUMENTS))
def test_session_matches_jax(name):
    """A session against the JAX session on the same key stream (polyphony
    2 steals voices; FMSynth changes device- and plan-kind parameters
    between blocks; MousePM moves its controllers)."""
    port, ref = _pair(name)
    assert port.shape == ref.shape == (1, 10 * BLOCK)
    assert np.abs(ref).max() > 0.01
    assert _rms_db(port, ref) < TOL_DB


def test_two_parts_mix_matches_jax():
    stream = _key_stream(11, 10)
    sessions = [S([(m.PMOscInstrument(1.0), 1), (m.FilteredSawtoothInstrument(), 2)], SR,
                  BLOCK, **kw)
                for S, m, kw in ((LiveSession, ti, {"device": "cpu"}), (JLiveSession, ji, {}))]
    outs = []
    for s in sessions:
        out = []
        for b, keys in enumerate(stream):
            for k, down in keys:
                s.key_event(b % 2, k, down)
            out.append(s.render_block())
        outs.append(np.concatenate(out, axis=-1))
    assert np.abs(outs[1]).max() > 0.01
    assert _rms_db(*outs) < TOL_DB


def test_stereo_echoes_post_chain_matches_jax():
    """example_delay.zig's interactive flow: a keyboard voice through
    StereoEchoes(15000), the post chain a session carries across blocks."""
    port = LiveSession([(ti.HardSquareInstrument(), 1)], SR, BLOCK, num_channels=2,
                       post_fn=lambda st, mix, ctx: tdelay.stereo_echoes(st, mix, 0.6, 0.7),
                       post_init_state=lambda dev: tdelay.stereo_echoes_init(15000, dev),
                       device="cpu")
    ref = JLiveSession([(ji.HardSquareInstrument(), 1)], SR, BLOCK, num_channels=2,
                       post_fn=lambda st, mix, ctx: jdelay.stereo_echoes(st, mix, 0.6, 0.7),
                       post_init_state=lambda: jdelay.stereo_echoes_init(15000))
    outs = []
    for s in (port, ref):
        s.key_event(0, "z", True)
        on = s.render_blocks(3)
        s.key_event(0, "z", False)
        outs.append(np.concatenate([on, s.render_blocks(16)], axis=1))
    assert outs[0].shape == (2, 19 * BLOCK)
    assert np.abs(outs[1][:, 14 * BLOCK:]).max() > 1e-4  # the echoes' tail
    assert _rms_db(*outs) < TOL_DB


def _toccata(session_cls, mod, blocks, device_kw):
    s = session_cls([(mod.NiceInstrument(0.3), 4)], SR, BLOCK, **device_kw)
    tracker = (NoteTracker if mod is ti else JNoteTracker)(live_events(blocks * BLOCK / SR))
    out = []
    for _ in range(blocks):
        push_tracked(lambda params, **kw: s.push_event(0, params, **kw), tracker, SR, BLOCK)
        out.append(s.render_block())
    return np.concatenate(out, axis=-1)


def test_toccata_session_matches_jax_and_offline():
    """The Toccata's first second through a NoteTracker (nice, polyphony 4,
    voices stolen) against the JAX session, and against the port's own
    offline render of the same events (tests/test_live.py's hold on the
    JAX package)."""
    blocks = 47
    port = _toccata(LiveSession, ti, blocks, {"device": "cpu"})
    assert _rms_db(port, _toccata(JLiveSession, ji, blocks, {})) < TOL_DB
    total = blocks * BLOCK
    tls = compile_timelines(live_events(total / SR), 4, SR, total)
    offline = render_performance(Performance([(ti.NiceInstrument(0.3), tls)], SR), total,
                                 chunk_size=16384, device="cpu").numpy()
    assert np.abs(offline).max() > 0.01
    assert _rms_db(port, offline) < TOL_DB


# -- snapshot / restore ----------------------------------------------------------


@pytest.mark.parametrize("name", ["nice", "fmsynth", "demosynth"])
def test_snapshot_restore_continues_bit_for_bit(name):
    make, poly = INSTRUMENTS[name]
    first, then = _key_stream(5, 6), _key_stream(6, 6)
    a = LiveSession([(make(ti), poly)], SR, BLOCK, device="cpu")
    _play(a, first, _actions(name))
    b = LiveSession([(make(ti), poly)], SR, BLOCK, device="cpu")
    b.restore(a.snapshot())
    assert b.frame == a.frame
    np.testing.assert_array_equal(_play(b, then), _play(a, then))


def test_restore_refuses_a_mismatched_spec():
    a = LiveSession([(ti.NiceInstrument(0.3), 2)], SR, BLOCK, device="cpu")
    a.key_event(0, "z", True)
    a.render_block()
    blob = a.snapshot()
    for other in ([(ti.NiceInstrument(0.7), 2)], [(ti.NiceInstrument(0.3), 3)],
                  [(ti.PMOscInstrument(1.0), 2)]):
        s = LiveSession(other, SR, BLOCK, device="cpu")
        with pytest.raises(ValueError, match="spec mismatch"):
            s.restore(blob)
        assert s.frame == 0
    played = LiveSession([(ti.NiceInstrument(0.3), 2)], SR, BLOCK, device="cpu")
    played.render_block()
    with pytest.raises(ValueError, match="fresh session"):
        played.restore(blob)


# -- a JAX session carried across ---------------------------------------------------


@pytest.mark.parametrize("name", ["nice", "fmsynth", "mousepm", "demosynth"])
def test_jax_session_carried_across_continues(name):
    """A JAX session played for k blocks (events still queued), carried
    across with from_jax_live_session, continues within TOL_DB of the JAX
    session itself."""
    make, poly = INSTRUMENTS[name]
    first, then = _key_stream(8, 5), _key_stream(9, 6)
    js = JLiveSession([(make(ji), poly)], SR, BLOCK)
    _play(js, first, _actions(name))
    js.key_event(0, "q", True)  # queued, not yet rendered
    ts = convert.from_jax_live_session(js, device="cpu")
    assert ts.frame == js.frame and ts.idgen.next_id == js.idgen.next_id
    port, ref = _play(ts, then, _actions(name)), _play(js, then, _actions(name))
    assert np.abs(ref).max() > 0.01
    assert _rms_db(port, ref) < TOL_DB


def test_liveplan_truncate_switch_is_the_jax_default():
    from zang_tpu.host import liveplan as jlp

    assert tlp.TRUNCATE_OVERFLOW is jlp.TRUNCATE_OVERFLOW is False


def test_dense_block_grows_slot_capacity():
    """A block with more segments than slot_capacity grows the capacity
    (the packed upload is laid out again) and keeps every event."""
    s = LiveSession([(ti.HardSquareInstrument(), 1)], SR, BLOCK, slot_capacity=2,
                    device="cpu")
    j = JLiveSession([(ji.HardSquareInstrument(), 1)], SR, BLOCK, slot_capacity=2)
    for sess in (s, j):
        for i in range(6):
            sess.push_event(0, {"freq": 220.0 + 10 * i, "note_on": i % 2 == 0}, note_id=1 + i // 2,
                            impulse_frame=100 * i)
    a, b = s.render_block(), j.render_block()
    assert s.slot_capacity == j.slot_capacity > 2
    assert _rms_db(a, b) < TOL_DB
