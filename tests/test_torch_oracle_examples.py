"""Every example's oracle twin in the port (ex_*(backend="oracle"),
zang_tpu_torch/oracle/examples.py and script.py) against the JAX
package's, on the CPU.

- The twenty twins at tools/oracle_fingerprints.py's windows, bit for bit
  with the JAX package's backend="oracle" renders, and 19 of their SHA-256
  fingerprints (taken as that tool takes them) equal to
  tests/oracle_fingerprints.json, read as data. `detuned` is held in two
  parts, as tests/test_examples_golden.py holds it: its warble trajectory,
  drawn by the port's threefry and plain ops on the CPU, within 1e-5
  relative of the JAX trajectory (so its fingerprint may differ); fed the
  JAX trajectory, the twin is the JAX twin's bits.
- render_script_oracle on the eight script examples' sources in both
  modes, bit for bit with the JAX package's.
- The port's own render of each example on the CPU (the plain path) within
  -90 dBFS of its twin, every channel (the parity budget; chip_smoke.py
  phase 15 holds the card's renders to the same twins).

~20 s alone.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from zang_tpu.host import examples as jex
from zang_tpu.oracle import examples as joex
from zang_tpu.oracle import script as jscript_oracle
from zang_tpu.script import compile_script as jcompile
from zang_tpu_torch.graph.fidelity import deviation_dbfs
from zang_tpu_torch.host import examples as tex
from zang_tpu_torch.oracle import examples as toex
from zang_tpu_torch.oracle import script as tscript_oracle
from zang_tpu_torch.script import compile_script as tcompile

torch.set_num_threads(1)  # xdist workers share the cores (see PERF.md §7)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARITY_DB = -90.0
TOL_WARBLE = 1e-5  # detuned's trajectory, relative (tests/test_torch_examples.py)
# tools/oracle_fingerprints.py's render windows (seconds), copied: that tool
# imports jax at its top to pin the JAX package's environment
WINDOW = {
    "play": 2.0, "envelope": 2.0, "vibrato": 2.0, "curve": 2.0,
    "laser": 2.0, "subsong": 3.0, "two": 2.5, "arpeggiator": 2.0,
    "polyphony": 2.0, "stereo": 2.0, "detuned": 2.0, "portamento": 2.0,
    "mouse": 2.0, "fmsynth": 2.0, "sampler": 2.0, "polyphony2": 2.0,
    "delay": 2.5, "script": 2.0, "script_runtime": 2.0, "song": 4.0,
}
NAMES = sorted(WINDOW)
with open(os.path.join(ROOT, "tests", "oracle_fingerprints.json")) as _f:
    MANIFEST = json.load(_f)


def fingerprint(audio, sr) -> str:
    """tools/oracle_fingerprints.py fingerprint's digest of a render."""
    a = np.ascontiguousarray(np.asarray(audio, dtype=np.float32))
    h = hashlib.sha256()
    h.update(repr((a.shape, float(sr))).encode())
    h.update(a.tobytes())
    return h.hexdigest()


_cache = {}


def _oracle(name):
    """(the port's twin, its sample rate) at the fingerprint window."""
    if name not in _cache:
        _cache[name] = tex.EXAMPLES[name](seconds=WINDOW[name], backend="oracle")
    return _cache[name]


def test_windows_are_the_fingerprint_tool_s():
    src = open(os.path.join(ROOT, "tools", "oracle_fingerprints.py")).read()
    body = src[src.index("WINDOW = {"):]
    body = body[:body.index("}") + 1]
    assert eval(body[len("WINDOW = "):]) == WINDOW
    assert sorted(WINDOW) == sorted(tex.EXAMPLES) == sorted(MANIFEST)


@pytest.mark.parametrize("name", NAMES)
def test_oracle_twin_bit_for_bit(name):
    got, sr = _oracle(name)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    if name == "detuned":  # held in two parts below
        return
    want, jsr = jex.EXAMPLES[name](seconds=WINDOW[name], backend="oracle")
    assert float(sr) == float(jsr)
    assert got.shape == np.asarray(want).shape
    assert got.tobytes() == np.asarray(want, np.float32).tobytes()


def test_fingerprints_19_of_20():
    matches = {n: fingerprint(*_oracle(n)) == MANIFEST[n] for n in NAMES}
    missed = sorted(n for n, ok in matches.items() if not ok)
    print(f"{len(NAMES) - len(missed)} of {len(NAMES)} match; mismatches: {missed}")
    assert set(missed) <= {"detuned"}
    assert sum(matches.values()) >= 19


def test_detuned_warble_within_1e5_of_the_jax_trajectory():
    """Part (a): the port's trajectory (threefry and the plain SVF and exp2
    on the CPU) against the JAX package's detuned_warble."""
    sr, total = 48000.0, int(WINDOW["detuned"] * 48000.0)
    got = toex.detuned_warble(2, total, sr, tex.DEFAULT_CHUNK)
    want = joex.detuned_warble(2, total, sr, jex.DEFAULT_CHUNK)
    assert got.shape == want.shape == (2, total) and got.dtype == np.float32
    worst = float(np.abs(got / want - 1.0).max())
    print(f"detuned warble: largest relative deviation {worst:.3e}")
    assert worst < TOL_WARBLE
    assert want.max() - want.min() > 0.01


def test_detuned_twin_on_the_jax_trajectory_bit_for_bit():
    """Part (b): fed the JAX trajectory, the port's twin is the JAX twin's
    bits, and its fingerprint is the manifest's."""
    sr, total = 48000.0, int(WINDOW["detuned"] * 48000.0)
    warble = joex.detuned_warble(2, total, sr, jex.DEFAULT_CHUNK)
    got, tsr = tex.ex_detuned(seconds=WINDOW["detuned"], backend="oracle",
                              warble_mul=warble)
    want, jsr = jex.ex_detuned(seconds=WINDOW["detuned"], backend="oracle")
    assert tsr == jsr and got.shape == (2, total)
    assert got.tobytes() == np.asarray(want, np.float32).tobytes()
    assert fingerprint(got, tsr) == MANIFEST["detuned"]


def test_detuned_warble_from_the_golden_file():
    """The stored JAX trajectory (examples_golden_jax.npz, which chip_smoke.py
    feeds the card's render and the twin) is the JAX package's detuned_warble
    at the example's default length."""
    gold = np.load(os.path.join(ROOT, "zang_tpu_torch", "data", "examples_golden_jax.npz"))
    stored = gold["detuned_warble"]
    total = stored.shape[1]
    assert stored.tobytes() == joex.detuned_warble(
        2, total, 48000.0, jex.DEFAULT_CHUNK).tobytes()


SCRIPTS = {  # name: (source, module, song, seconds, sample rate, polyphony)
    "envelope": (tex.ENVELOPE_SCRIPT, "EnvDemo", [(0.1, 1.0, 65.4)], 1.5, 48000.0, 1),
    "vibrato": (tex.VIBRATO_SCRIPT, "Vib", [(0.1, 0.6, 220.0), (0.9, 0.4, 293.7)],
                1.5, 48000.0, 1),
    "laser": (tex.LASER_SCRIPT, "Laser", None, 1.5, 44100.0, 1),
    "subsong": (tex.SUBSONG_SCRIPT, "SubtrackPlayer", [(0.0, 1.5, 261.6), (1.7, 0.5, 329.6)],
                2.5, 44100.0, 1),
    "script": (tex.DEMO_SCRIPT, "DemoSynth",
               [(0.1 + 0.3 * i, 0.25, 220.0 * 1.1 ** i) for i in range(5)], 2.0, 44100.0, 2),
}


def _script_song(song_event, name):
    src, module, notes, seconds, sr, poly = SCRIPTS[name]
    song = []
    if notes is None:  # laser's note params
        for i in range(4):
            p = {"freq_mul": 1.0 + 0.02 * i, "carrier_mul": 2.0, "modulator_mul": 0.5,
                 "modulator_rad": 1.0}
            song.append(song_event({**p, "note_on": True}, t=0.1 + 0.3 * i, note_id=i + 1))
            song.append(song_event({**p, "note_on": False}, t=0.35 + 0.3 * i, note_id=i + 1))
        return song
    for i, (t0, dur, f) in enumerate(notes):
        song.append(song_event({"freq": f, "note_on": True}, t=t0, note_id=i + 1))
        song.append(song_event({"freq": f, "note_on": False}, t=t0 + dur, note_id=i + 1))
    song.sort(key=lambda e: (e.t, e.note_id))
    return song


@pytest.mark.parametrize("mode", ["parity", "exact"])
@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_render_script_oracle_bit_for_bit(name, mode):
    """The script interpreter itself, called as a user would, on the
    example scripts (the other three script examples' sources are inline in
    their ex_* and reach it through test_oracle_twin_bit_for_bit)."""
    from zang_tpu.core.notes import SongEvent as JSongEvent
    from zang_tpu_torch.core.notes import SongEvent as TSongEvent

    src, module, _notes, seconds, sr, poly = SCRIPTS[name]
    total = int(seconds * sr)
    got = tscript_oracle.render_script_oracle(tcompile(src), module,
                                              _script_song(TSongEvent, name), total, sr,
                                              polyphony=poly, mode=mode)
    want = jscript_oracle.render_script_oracle(jcompile(src), module,
                                               _script_song(JSongEvent, name), total, sr,
                                               polyphony=poly, mode=mode)
    assert got.shape == (1, total) and got.dtype == np.float32
    assert got.tobytes() == np.asarray(want).tobytes()
    assert np.abs(got).max() > 1e-3


@pytest.mark.parametrize("name", NAMES)
def test_port_render_within_budget_of_its_twin(name):
    """The port's render on the CPU against the port's twin, every channel;
    detuned on one trajectory (the twin's: the port's own on the CPU)."""
    audio, sr = tex.EXAMPLES[name](seconds=WINDOW[name], device="cpu")
    twin, tsr = _oracle(name)
    audio = audio.numpy()
    assert float(sr) == float(tsr) and audio.shape == twin.shape
    for ch in range(audio.shape[0]):
        db, _ = deviation_dbfs(audio[ch], twin[ch])
        assert db < PARITY_DB, f"{name} channel {ch}: {db:.1f} dBFS from the oracle"
