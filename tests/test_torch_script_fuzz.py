"""Differential fuzz of the port's script backend against the JAX engine.

tests/test_script_fuzz.py's generators (the same seeds, the same scripts,
songs and polyphony) render through the port's ScriptInstrument on the CPU
and through the JAX package's (zang_tpu/script/jax_backend.py), at render
chunk 8192:

- tier 1 (ScriptGen: oscillator frequencies only from bit-exact
  trajectories, division by constants, at most one Noise site): within
  -90 dBFS, the parity budget;
- tier 2 (ScriptGenWild: module outputs into frequencies, division by
  buffers, up to three Noise sites, polyphony up to 4): within -50 dBFS,
  the JAX file's gross-miscompile budget (last-place differences of a
  filter or sin feeding a phase accumulator grow by design).

Noise needs no injected tape here: both engines draw the same threefry
stream from crc32(site) and the (sub-)chunk's first frame. Seed counts are
the JAX file's defaults (ZANG_FUZZ_SEEDS, ZANG_FUZZ2_SEEDS: 24 and 24).
The JAX file's directed regression (a constant-fed delay must respect the
active window) is carried over against the oracle and the JAX engine.
"""

import importlib.util
import os
import random

import numpy as np
import pytest
import torch

from zang_tpu.core.timeline import compile_timelines as jcompile_timelines
from zang_tpu.graph.render import Performance as JPerformance
from zang_tpu.graph.render import render_performance as jrender_performance
from zang_tpu.script import compile_script as jcompile
from zang_tpu.script.jax_backend import ScriptInstrument as JScriptInstrument
from zang_tpu_torch.core.notes import SongEvent as TSongEvent
from zang_tpu_torch.core.timeline import compile_timelines as tcompile_timelines
from zang_tpu_torch.graph.render import Performance as TPerformance
from zang_tpu_torch.graph.render import render_performance as trender_performance
from zang_tpu_torch.script import compile_script as tcompile
from zang_tpu_torch.script.torch_backend import ScriptInstrument as TScriptInstrument

torch.set_num_threads(1)  # xdist workers share the cores (see PERF.md §7)

_spec = importlib.util.spec_from_file_location(
    "_torch_fuzz_generators",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_script_fuzz.py"))
_JF = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_JF)

CHUNK = 8192
TIER1_BUDGET_DBFS = -90.0
TIER2_BUDGET_DBFS = _JF.TIER2_BUDGET_DBFS  # -50


def _dbfs(a, b) -> float:
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return 20.0 * np.log10(float(np.sqrt(np.mean(d * d))) + 1e-30)


def _render_port(src, song, polyphony, total, sr):
    inst = TScriptInstrument(tcompile(src), "Root")
    tsong = [TSongEvent(dict(e.params), t=e.t, note_id=e.note_id) for e in song]
    tls = tcompile_timelines(tsong, polyphony, sr, total)
    return trender_performance(TPerformance([(inst, tls)], sr), total, CHUNK,
                               device="cpu").numpy()


def run_port_vs_jax(src, song, polyphony, seconds, sr=44100.0):
    """(deviation dBFS of the port from the JAX engine, JAX rms)."""
    total = int(seconds * sr)
    inst = JScriptInstrument(jcompile(src), "Root")
    tls = jcompile_timelines(song, polyphony, sr, total)
    want = np.asarray(jrender_performance(JPerformance([(inst, tls)], sr), total,
                                          chunk_size=CHUNK))
    got = _render_port(src, song, polyphony, total, sr)
    assert got.shape == want.shape and got.dtype == np.float32
    ref = float(np.sqrt(np.mean(want.astype(np.float64) ** 2)))
    return _dbfs(got, want), ref


def _tier1_case(seed):
    """tests/test_script_fuzz.py run_differential_seed's draws."""
    rng = random.Random(777000 + seed)
    gen = _JF.ScriptGen(rng)
    gen.allow_noise = rng.random() < 0.5
    src = gen.script()
    song = _JF._fuzz_song(rng)
    return src, song, rng.choice([1, 1, 2])


def _tier2_case(seed):
    """tests/test_script_fuzz.py run_differential_seed_tier2's draws."""
    rng = random.Random(888000 + seed)
    src = _JF.ScriptGenWild(rng).script()
    polyphony = rng.choice([1, 2, 3, 4])
    return src, _JF._fuzz_song_wild(rng, polyphony), polyphony


@pytest.mark.parametrize("seed", range(_JF.FUZZ_SEEDS))
def test_random_script_parity(seed):
    src, song, polyphony = _tier1_case(seed)
    dev, ref = run_port_vs_jax(src, song, polyphony, seconds=1.2)
    assert ref > 1e-5, f"seed {seed}: near-silent render\n{src}"
    assert dev < TIER1_BUDGET_DBFS, (
        f"seed {seed}: port vs JAX {dev:.1f} dBFS\n--- script ---\n{src}")


@pytest.mark.parametrize("seed", range(_JF.FUZZ2_SEEDS))
def test_unrestricted_script_parity(seed):
    src, song, polyphony = _tier2_case(seed)
    dev, ref = run_port_vs_jax(src, song, polyphony, seconds=1.0)
    assert ref > 1e-5, f"seed {seed}: near-silent render\n{src}"
    assert dev < TIER2_BUDGET_DBFS, (
        f"seed {seed}: port vs JAX {dev:.1f} dBFS (polyphony {polyphony})\n"
        f"--- script ---\n{src}")


def test_const_fed_delay_respects_active_window():
    """The JAX file's tier-2 seed 675 repro: a delay body CONSTANT must not
    reach the feedback line before the voice's first note, or every echo
    lands delay-length early against the sequential reference. The port
    masks the feedback write and the body output by the active window as
    the JAX engine does: within -90 dBFS of the oracle and of the JAX
    engine."""
    from zang_tpu.core.notes import SongEvent
    from zang_tpu.oracle.script import render_script_oracle

    src = """Root = defmodule freq: cob, note_on: boolean, begin
    a3 = 1.0
    a4 = delay 4410 begin
        fb = feedback * 0.580
        feedback a3 + fb
        out fb + a3
    end
    a5 = SineOsc(freq=(64.3 + 649.4), phase=a4)
    out (a5 * 0.3)
end
"""
    song = [SongEvent({"freq": 440.0, "note_on": True}, t=0.05, note_id=1),
            SongEvent({"freq": 440.0, "note_on": False}, t=0.6, note_id=1)]
    sr, total = 44100.0, 44100
    oracle = np.asarray(render_script_oracle(jcompile(src), "Root", song, total, sr,
                                             polyphony=1))
    got = _render_port(src, song, 1, total, sr)
    assert float(np.sqrt(np.mean(oracle.astype(np.float64) ** 2))) > 1e-5
    assert _dbfs(got, oracle) < TIER1_BUDGET_DBFS
    dev, _ = run_port_vs_jax(src, song, 1, seconds=1.0, sr=sr)
    assert dev < TIER1_BUDGET_DBFS
