"""MIDI and tracker-text input in the port (zang_tpu_torch/host/midi.py,
host/songparse.py, tools/toccata_smf.py) against zang_tpu's, on the CPU.

The SMF builders are copies of tests/test_midi.py's (stdlib byte packing),
so both packages read the same known bytes.

- parse_smf and midi_songs: equal fields and events (exact: host data).
- Every MidiError case raises in both packages.
- render_midi with each of the five stock instruments, on a file shorter
  than one chunk (one flat chunk of 14,400 frames) and a longer one (tiled
  chunks of 16,384), within -90 dBFS of the JAX render (the parity budget).
  A zangscript instrument (zang_tpu_torch/data/demo_synth.txt:DemoSynth)
  through render_midi, tiled and flat, within the same budget; the card
  asked for without one raises.
- The CLI writes the WAV with --device cpu, the JAX CLI's to within one
  s16 step; with a zangscript instrument, the JAX render's mixdown to
  within one step.
- tools/toccata_smf.py regenerates zang_tpu_torch/data/toccata.mid byte for
  byte, and both packages read the same parts from it.
- parse_song on tests/test_song.py's FIXTURE and its error cases.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from zang_tpu.host import midi as jmidi
from zang_tpu.host import songparse as jparse
from zang_tpu_torch.core.wav import read_wav
from zang_tpu_torch.host import midi as tmidi
from zang_tpu_torch.host import songparse as tparse
from zang_tpu_torch.tools import toccata_smf

torch.set_num_threads(1)  # xdist workers share the cores (see PERF.md §7)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUDGET_DB = -90.0
SCRIPT = os.path.join(ROOT, "zang_tpu_torch", "data", "demo_synth.txt")


# ---------------------------------------------------------------------------
# SMF builders (tests/test_midi.py:19-47)


def varlen(v: int) -> bytes:
    out = [v & 0x7F]
    v >>= 7
    while v:
        out.append(0x80 | (v & 0x7F))
        v >>= 7
    return bytes(reversed(out))


def track(events: bytes) -> bytes:
    body = events + bytes([0x00, 0xFF, 0x2F, 0x00])  # end of track
    return b"MTrk" + len(body).to_bytes(4, "big") + body


def smf(tracks, fmt=1, division=480) -> bytes:
    head = (b"MThd" + (6).to_bytes(4, "big") + fmt.to_bytes(2, "big")
            + len(tracks).to_bytes(2, "big") + division.to_bytes(2, "big"))
    return head + b"".join(track(t) for t in tracks)


def note_on(dt, key, vel=100, ch=0) -> bytes:
    return varlen(dt) + bytes([0x90 | ch, key, vel])


def note_off(dt, key, ch=0) -> bytes:
    return varlen(dt) + bytes([0x80 | ch, key, 64])


def tempo(dt, uspq) -> bytes:
    return varlen(dt) + bytes([0xFF, 0x51, 0x03]) + uspq.to_bytes(3, "big")


# the files of tests/test_midi.py's cases, and two of chords and tempo maps
FILES = {
    "running_status": smf([note_on(0, 60) + varlen(480) + bytes([62, 100])
                           + varlen(200) + bytes([60, 0]) + note_off(40, 62)]),
    "long_delta": smf([note_on(0, 60) + note_off(100000, 60)]),
    "other_messages": smf([varlen(0) + bytes([0xB0, 7, 100]) + varlen(0) + bytes([0xC0, 5])
                           + varlen(0) + bytes([0xF0, 0x02, 1, 0xF7])
                           + varlen(0) + bytes([0xFF, 0x03, 0x03]) + b"abc"
                           + note_on(10, 64) + note_off(10, 64)]),
    "dense_tempo": smf([b"".join(tempo(10, 500000 - i * 100) for i in range(500))
                        + note_on(0, 60) + note_off(480, 60)]),
    "tempo_track": smf([tempo(0, 250000), note_on(0, 60) + note_off(480, 60)]),
    "retrigger": smf([note_on(0, 60) + note_on(480, 60) + note_off(480, 60)]),
    "same_tick": smf([note_on(0, 60) + note_on(480, 62) + note_off(0, 60)
                      + note_off(480, 62)]),
    "drums": smf([note_on(0, 60, ch=0) + note_on(0, 40, ch=9) + note_off(480, 60, ch=0)
                  + note_off(0, 40, ch=9)]),
    "chords": smf([tempo(0, 400000),
                   note_on(0, 60) + note_on(0, 64) + note_off(480, 60) + note_off(0, 64)
                   + note_on(0, 67) + note_off(480, 67),
                   note_on(0, 36, ch=1) + note_off(960, 36, ch=1)]),
    "format0": smf([tempo(0, 600000) + note_on(0, 57, vel=90) + note_on(120, 69, ch=2)
                    + tempo(240, 300000) + note_off(120, 57) + note_off(60, 69, ch=2)
                    + note_on(0, 81, vel=127, ch=2) + note_off(700, 81, ch=2)], fmt=0),
}


def _songs_fields(parts):
    return [(label, poly, [(dict(e.params), e.t, e.note_id) for e in song])
            for label, song, poly in parts]


@pytest.mark.parametrize("name", sorted(FILES))
def test_parse_smf_fields(name):
    ref, got = jmidi.parse_smf(FILES[name]), tmidi.parse_smf(FILES[name])
    assert (got.fmt, got.division, got.notes, got.tempos) == \
        (ref.fmt, ref.division, ref.notes, ref.tempos)
    for tick in (0, 5, 479, 480, 960, 2501, 100000):
        assert got.seconds(tick) == ref.seconds(tick)


@pytest.mark.parametrize("kw", [{}, {"group": "track"}, {"include_velocity": True},
                                {"transpose": 7, "a4": 432.0}, {"skip_channels": (9,)}],
                         ids=["channel", "track", "velocity", "transpose", "skip"])
@pytest.mark.parametrize("name", sorted(FILES))
def test_midi_songs_events(name, kw):
    assert _songs_fields(tmidi.midi_songs(FILES[name], **kw)) == \
        _songs_fields(jmidi.midi_songs(FILES[name], **kw))


def _cut(data: bytes, keep: int) -> bytes:
    head, hdr, body = data[:14], data[14:22], data[22:]
    return head + hdr[:4] + keep.to_bytes(4, "big") + body[:keep]


_WHOLE = smf([note_on(0, 60) + note_off(480, 60)])
_T1 = varlen(0) + bytes([0x90])  # a note-on missing key and velocity
BAD = {
    "garbage": b"RIFFxxxx",
    "format2": smf([note_on(0, 60)], fmt=2),
    "smpte": smf([note_on(0, 60)], division=0xE250),
    "zero_division": smf([note_on(0, 60)], division=0),
    "next_track_bytes": (b"MThd" + (6).to_bytes(4, "big") + (1).to_bytes(2, "big")
                         + (2).to_bytes(2, "big") + (480).to_bytes(2, "big")
                         + b"MTrk" + len(_T1).to_bytes(4, "big") + _T1
                         + track(note_on(0, 72) + note_off(10, 72))),
    "no_status": smf([varlen(0) + bytes([60, 100])]),
    "long_varlen": smf([bytes([0x81, 0x81, 0x81, 0x81, 0x01]) + bytes([0x90, 60, 100])]),
    "track_past_end": _WHOLE[:-3],
    **{f"cut_{k}": _cut(_WHOLE, k)
       for k in sorted(set(range(1, int.from_bytes(_WHOLE[18:22], "big"))) - {4, 9})},
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_midi_errors_raise_in_both(name):
    for mod in (jmidi, tmidi):
        with pytest.raises(mod.MidiError):
            mod.midi_songs(BAD[name])


def test_render_refusals_raise_in_both():
    data = smf([note_on(0, 60 + i % 12) + note_off(10, 60 + i % 12) for i in range(20)])
    for mod, kw in ((jmidi, {}), (tmidi, {"device": "cpu"})):
        with pytest.raises(mod.MidiError, match="no notes"):
            mod.render_midi(smf([b""]), lambda pi, label: None, **kw)
        with pytest.raises(mod.MidiError, match="parts"):
            mod.render_midi(data, lambda pi, label: None, group="track", max_parts=16, **kw)
        with pytest.raises(mod.MidiError, match="events"):
            mod.render_midi(data, lambda pi, label: None, group="track", max_events=30,
                            **kw)
        with pytest.raises(mod.MidiError, match="group"):
            mod.midi_songs(data, group="key")


# ---------------------------------------------------------------------------
# renders


def _rms_db(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return 20 * np.log10(np.sqrt(np.mean(d * d)) + 1e-30)


# "chords" is 1.2 s + 0.5 s of tail at 24 kHz: 40,800 frames, three tiled
# chunks of 16,384; cut to 0.6 s, 14,400 frames: one chunk, the flat format
RENDERS = {"tiled": dict(seconds=None), "flat": dict(seconds=0.6)}


@pytest.mark.parametrize("kind", sorted(RENDERS))
@pytest.mark.parametrize("inst", sorted(tmidi.stock_instruments()))
def test_render_midi_matches_jax(inst, kind):
    kw = dict(sample_rate=24000.0, tail=0.5, **RENDERS[kind])
    ref = np.asarray(jmidi.render_midi(
        FILES["chords"], lambda pi, label: jmidi.stock_instruments()[inst](), **kw))
    got = tmidi.render_midi(FILES["chords"],
                            lambda pi, label: tmidi.stock_instruments()[inst](),
                            device="cpu", **kw)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    got = got.numpy()
    assert got.shape == ref.shape and np.abs(ref).max() > 1e-3
    chunk = tmidi.midi_chunk(got.shape[1])
    assert (chunk % 512 != 0) == (kind == "flat")
    db = _rms_db(got, ref)
    print(f"{inst} {kind} (chunk {chunk}): {db:.1f} dBFS from the JAX render")
    assert db < BUDGET_DB


def test_script_instrument_raises(tmp_path):
    """Inverted since the port has its script backend: FILE.txt[:Module]
    loads through the port's compile_script and ScriptInstrument (the last
    exported module when none is named), as the JAX package's maker does.
    What raises in both: a module the script does not export, a script that
    exports none, a script that does not compile, an unknown name."""
    from zang_tpu_torch.script import ScriptError
    from zang_tpu_torch.script.torch_backend import ScriptInstrument

    for name, module in ((SCRIPT, "DemoSynth"), (f"{SCRIPT}:DemoSynth", "DemoSynth"),
                         (f"{SCRIPT}:SweepVoice", "SweepVoice")):
        inst = tmidi._instrument_maker(name)()
        assert isinstance(inst, ScriptInstrument) and inst.module_name == module
        assert jmidi._instrument_maker(name)().module_name == module
    empty, bad = tmp_path / "empty.txt", tmp_path / "bad.txt"
    empty.write_text("f = 0.5\n")
    bad.write_text("def Synth: Module { }\n")
    for mod in (jmidi, tmidi):
        with pytest.raises(mod.MidiError, match="no exported module"):
            mod._instrument_maker(f"{SCRIPT}:Nope")
        with pytest.raises(mod.MidiError, match="exports no modules"):
            mod._instrument_maker(str(empty))
        with pytest.raises(mod.MidiError, match="unknown instrument"):
            mod._instrument_maker("nosuch")
    with pytest.raises(ScriptError):
        tmidi._instrument_maker(str(bad))
    assert tmidi._instrument_maker("nice")().__class__.__name__ == "NiceInstrument"


@pytest.mark.parametrize("kind", sorted(RENDERS))
def test_render_midi_script_matches_jax(kind):
    """DemoSynth on every part of "chords": tiled chunks, where the delay of
    11,025 halves each 16,384 chunk, and one flat chunk of 14,400 (two
    sub-chunks of 7,200)."""
    kw = dict(sample_rate=24000.0, tail=0.5, **RENDERS[kind])
    jmake, tmake = jmidi._instrument_maker(SCRIPT), tmidi._instrument_maker(SCRIPT)
    ref = np.asarray(jmidi.render_midi(FILES["chords"], lambda pi, label: jmake(), **kw))
    got = tmidi.render_midi(FILES["chords"], lambda pi, label: tmake(), device="cpu",
                            **kw).numpy()
    assert got.shape == ref.shape and np.abs(ref).max() > 1e-2
    db = _rms_db(got, ref)
    print(f"DemoSynth {kind}: {db:.1f} dBFS from the JAX render")
    assert db < BUDGET_DB


def test_render_on_the_card_without_one_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tmidi.render_midi(FILES["chords"], lambda pi, label: None, device="cuda")


def test_cli_writes_the_wav(tmp_path):
    mid = tmp_path / "chords.mid"
    mid.write_bytes(FILES["chords"])
    out, ref = tmp_path / "port.wav", tmp_path / "jax.wav"
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    for mod, path, extra in (("zang_tpu_torch.host.midi", out, ["--device", "cpu"]),
                             ("zang_tpu.host.midi", ref, [])):
        proc = subprocess.run(
            [sys.executable, "-m", mod, str(mid), str(path), "--instrument",
             "nice,filteredsaw", "--sample-rate", "24000", *extra],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
    a, b = read_wav(str(out)), read_wav(str(ref))
    assert (a.num_channels, a.sample_rate, a.bits_per_sample) == (1, 24000, 16)
    assert (b.num_channels, b.sample_rate, len(b.data)) == (1, 24000, len(a.data))
    pa, pb = (np.frombuffer(w.data, np.int16).astype(np.int32) for w in (a, b))
    assert np.abs(pa).max() > 100 and np.abs(pa - pb).max() <= 1


def test_cli_script_instrument(tmp_path):
    """--instrument FILE.txt:Module with --device cpu: the WAV is the JAX
    render's mixdown to within one s16 step."""
    from zang_tpu.core.mixdown import mixdown_s16_np

    mid, out = tmp_path / "chords.mid", tmp_path / "port.wav"
    mid.write_bytes(FILES["chords"])
    proc = subprocess.run(
        [sys.executable, "-m", "zang_tpu_torch.host.midi", str(mid), str(out),
         "--instrument", f"{SCRIPT}:DemoSynth", "--sample-rate", "24000", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    jmake = jmidi._instrument_maker(f"{SCRIPT}:DemoSynth")
    ref = np.asarray(jmidi.render_midi(FILES["chords"], lambda pi, label: jmake(),
                                       sample_rate=24000.0))
    want = mixdown_s16_np(ref, 0.25).reshape(-1).astype(np.int32)
    w = read_wav(str(out))
    got = np.frombuffer(w.data, np.int16).astype(np.int32)
    assert (w.num_channels, w.sample_rate) == (1, 24000) and got.shape == want.shape
    assert np.abs(got).max() > 100 and np.abs(got - want).max() <= 1


# ---------------------------------------------------------------------------
# the Toccata as an SMF


def test_toccata_smf_regenerates_the_file(tmp_path):
    out = tmp_path / "toccata.mid"
    assert toccata_smf.main(["--out", str(out)]) == 0
    with open(toccata_smf.OUT, "rb") as f:
        assert out.read_bytes() == f.read()


def test_toccata_smf_reads_the_same_in_both():
    with open(toccata_smf.OUT, "rb") as f:
        data = f.read()
    m = tmidi.parse_smf(data)
    assert (m.fmt, m.division, len(m.notes)) == (1, 480, 3) and len(m.tempos) == 2
    parts = tmidi.midi_songs(data)
    assert _songs_fields(parts) == _songs_fields(jmidi.midi_songs(data))
    # the npz's notes: each note-on at its equal-tempered key and within half
    # a tick of its time (a retriggered key's note-off moves to the retrigger)
    z = np.load(toccata_smf.NPZ)
    by_channel = {int(label.split()[1]): song for label, song, _p in parts}
    for i in range(3):
        song, on = by_channel[i], z[f"on_{i}"]
        assert len(song) == len(on)
        ons = sorted((e.t, float(e.params["freq"])) for e in song if e.params["note_on"])
        want = sorted(zip(z[f"t_{i}"][on].astype(np.float64), z[f"freq_{i}"][on]))
        t, f = np.array(ons).T
        t_want, f_want = np.array(want).T
        assert np.abs(t - t_want).max() < 1e-3
        np.testing.assert_allclose(f, f_want, rtol=1e-6)


# ---------------------------------------------------------------------------
# tracker text (tests/test_song.py)

FIXTURE = """
# tiny test song
rate 2.0
|C-4 E-4|A-5
|off    |
tempo 0.5  |G-4    |off
|off off|
"""


def _events(events):
    return [[(dict(e.params), e.t, e.note_id) for e in ev] for ev in events]


@pytest.mark.parametrize("text,columns,kw", [
    (FIXTURE, [2, 1], {"note_duration": 0.15, "a4": 440.0}),
    (FIXTURE, [1, 2], {"note_duration": 0.1, "a4": 432.0}),
    ("|C-4\n|D-4\n", [1], {}),
    ("|C-4\nstart\n|D-4\n", [1], {}),
    ("rate 3\n|C#4 B-2\n|    off\ntempo 1.25\n|A#7\n", [1, 1], {}),
], ids=["fixture", "fixture_columns", "retrigger", "start", "sharps"])
def test_parse_song_matches(text, columns, kw):
    assert _events(tparse.parse_song(text, columns, **kw)) == \
        _events(jparse.parse_song(text, columns, **kw))


@pytest.mark.parametrize("text,columns", [
    ("|C-4 D-4 E-4\n", [1]),  # too many columns
    ("|C-4 x\n", [2]),  # a bad cell ends the row mid-line
    ("rate\n|C-4\n", [1]),  # expected number
    ("?\n", [1]),
    ("tempo |C-4\n", [1]),
    ("12 |C-4\n", [1]),  # a number where a word or a row goes
], ids=["columns", "cell", "rate", "token", "tempo", "number"])
def test_parse_song_errors_raise_in_both(text, columns):
    for mod in (jparse, tparse):
        with pytest.raises(mod.SongParseError) as e:
            mod.parse_song(text, columns)
        assert isinstance(e.value, ValueError)
    msgs = []
    for mod in (jparse, tparse):
        try:
            mod.parse_song(text, columns)
        except mod.SongParseError as err:
            msgs.append((str(err), err.line_index))
    assert msgs[0] == msgs[1]
