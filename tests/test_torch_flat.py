"""The flat chunk format in the port (zang_tpu_torch/ops/segprog.py chunkify,
eval_chunk; ops/scan.py pconst_multi; graph/render.py Performance.chunk_xs)
against zang_tpu's, on the CPU.

A chunk that is not a whole number of 512-frame tiles is sliced flat:
{"starts": [V, Kc], name: [V, Kc]}, evaluated by masked delta sums.

- chunkify and pconst_multi: bit for bit (f32, int32 and u32 values; random
  programs with padding at `total` and boundaries past it). pconst_multi is
  compared with the JAX function run op by op (not under jit, where XLA
  fuses).
- Every instrument of the port and the sampler and poly_echo configs
  rendered at a flat chunk, against the JAX package at the same chunk:
  < -90 dBFS RMS on every channel (the parity budget; the readings are
  -140 dBFS and below); the examples are in test_torch_flat_examples.py.
  NiceInstrument's flat branch is the dense-cut SVF (filters.svf_filter,
  never the table path) on both sides.
- On the card, tests/test_torch_cuda_paths.py (marker `cuda`): the flat
  NiceInstrument reaches K2, the dense-cut kernel, once a chunk, and never
  the plain SVF.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zang_tpu.core import timeline as jtl
from zang_tpu.core.notes import SongEvent as JSongEvent
from zang_tpu.graph import render as jrender
from zang_tpu.host import configs as jconfigs
from zang_tpu.host import instruments as jti
from zang_tpu.host import song as jsong
from zang_tpu.ops import filters as jfilt
from zang_tpu.ops import scan as jscan
from zang_tpu.ops import segprog as jseg
from zang_tpu_torch.core import timeline as ttl
from zang_tpu_torch.core.notes import SongEvent as TSongEvent
from zang_tpu_torch.graph import render as trender
from zang_tpu_torch.host import configs as tconfigs
from zang_tpu_torch.host import instruments as tti
from zang_tpu_torch.host import song as tsong
from zang_tpu_torch.ops import filters as tfilt
from zang_tpu_torch.ops import scan as tscan
from zang_tpu_torch.ops import segprog as tseg

torch.set_num_threads(1)  # xdist workers share the cores (see PERF.md §7)

BUDGET_DB = -90.0
SR = 48000.0
FLAT = 1000  # frames a chunk: not a multiple of the 512-frame tile
N_CHUNKS = 3


def _rms_db(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return 20 * np.log10(np.sqrt(np.mean(d * d)) + 1e-30)


# ---------------------------------------------------------------------------
# chunkify and pconst_multi, bit for bit


def _program(rng, V, K, total):
    """A random SegProgram: sorted starts per voice, the first at 0, some
    rows padded with start = total (repeating the last value) and some
    boundaries at or past total; f32, int32 and u32 values."""
    starts = np.full((V, K), total, dtype=np.int64)
    values = {"f": np.zeros((V, K), np.float32), "i": np.zeros((V, K), np.int32),
              "u": np.zeros((V, K), np.uint32)}
    for v in range(V):
        k = int(rng.integers(1, K + 1))
        s = np.sort(rng.choice(np.arange(1, total + total // 4), k - 1, replace=False))
        starts[v, :k] = np.concatenate([[0], s])
        values["f"][v, :k] = rng.standard_normal(k).astype(np.float32) * 100
        values["i"][v, :k] = rng.integers(-2 ** 31, 2 ** 31 - 1, k, dtype=np.int32)
        values["u"][v, :k] = rng.integers(0, 2 ** 32, k, dtype=np.uint32)
        for arr in values.values():
            arr[v, k:] = arr[v, k - 1]
    return starts, values


@pytest.mark.parametrize("chunk,total", [(1000, 2900), (777, 7770), (4096, 10000),
                                         (100, 250)])
def test_chunkify_bit_for_bit(chunk, total):
    rng = np.random.default_rng(chunk)
    starts, values = _program(rng, 6, 12, total)
    n_chunks = -(-total // chunk)
    ref = jseg.chunkify(jseg.SegProgram(starts, values), chunk, n_chunks, total)
    got = tseg.chunkify(tseg.SegProgram(starts, values), chunk, n_chunks, total)
    assert got.starts.dtype == ref.starts.dtype == np.int32
    np.testing.assert_array_equal(got.starts, ref.starts)
    assert got.values.keys() == ref.values.keys()
    for k in ref.values:
        assert got.values[k].dtype == ref.values[k].dtype
        np.testing.assert_array_equal(got.values[k], ref.values[k])


@pytest.mark.parametrize("name", ["f", "i", "u"], ids=["f32", "int32", "u32"])
def test_pconst_multi_bit_for_bit(name):
    """Each chunk of a random program, chunkified, through both packages'
    masked delta sums: f32 sums of deltas, int32 and u32 wrapping."""
    rng = np.random.default_rng(7)
    total, chunk = 2900, 1000
    starts, values = _program(rng, 5, 16, total)
    n_chunks = -(-total // chunk)
    ch = tseg.chunkify(tseg.SegProgram(starts, {name: values[name]}), chunk, n_chunks, total)
    for i in range(n_chunks):
        t_idx = np.arange(i * chunk, (i + 1) * chunk, dtype=np.int32)
        vals = ch.values[name][i]
        ref = np.asarray(jscan.pconst_multi(jnp.asarray(ch.starts[i]),
                                            {name: jnp.asarray(vals)},
                                            jnp.asarray(t_idx))[name])
        tv = torch.from_numpy(vals.astype(np.int64) if vals.dtype == np.uint32 else vals)
        got = tscan.pconst_multi(torch.from_numpy(ch.starts[i]), {name: tv},
                                 torch.from_numpy(t_idx))[name].numpy()
        if name == "u":
            assert got.min() >= 0 and got.max() < 2 ** 32
            got = got.astype(np.uint32)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def test_eval_chunk_takes_both_formats():
    """eval_chunk dispatches on "tb": the tiled program of one chunk and the
    flat program of the same chunk give the same values (u32 exactly; the
    f32 sums of deltas here are exact too: integer-valued)."""
    rng = np.random.default_rng(3)
    total, chunk = 4096, 2048
    starts, values = _program(rng, 4, 8, total)
    values["f"] = np.round(values["f"])
    sp = tseg.SegProgram(starts, values)
    flat = tseg.chunkify(sp, chunk, 2, total)
    tiled = tseg.chunkify_tiled(sp, chunk, 2, total)
    t_idx = torch.arange(chunk, 2 * chunk, dtype=torch.int32)

    def dev(a):
        return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a)

    got_flat = tseg.eval_chunk({"starts": dev(flat.starts[1]),
                                **{k: dev(v[1]) for k, v in flat.values.items()}}, t_idx)
    got_tiled = tseg.eval_chunk({k: dev(v[1]) for k, v in tiled.items()}, t_idx)
    for k in values:
        torch.testing.assert_close(got_flat[k], got_tiled[k], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# renders at a flat chunk


def _song(event_cls, extra=None):
    """Eight overlapping notes inside the first 3,000 frames at 48 kHz."""
    notes = [(0.004 * i, 0.012 + 0.006 * (i % 3), 220.0 * 2 ** (i / 7)) for i in range(8)]
    song = []
    for i, (t0, dur, f) in enumerate(notes):
        for t, on in ((t0, True), (t0 + dur, False)):
            p = {"freq": float(np.float32(f)), "note_on": on, **(extra or {})}
            song.append(event_cls(p, t=t, note_id=i + 1))
    song.sort(key=lambda e: (e.t, e.note_id))
    return song


INSTRUMENTS = {
    "pmosc": lambda m: m.PMOscInstrument(0.4),
    "nice": lambda m: m.NiceInstrument(np.array([0.25, 0.1, 0.3, 0.2], np.float32)),
    "hardsquare": lambda m: m.HardSquareInstrument(),
    "filteredsaw": lambda m: m.FilteredSawtoothInstrument(),
    "weirdsquare": lambda m: m.SquareWithEnvelope(weird=True),
    "mouse": lambda m: m.MousePMInstrument(0),
    "fmsynth": lambda m: m.FMSynthInstrument(),
}


def _render_both(name, chunk=FLAT, n_chunks=N_CHUNKS):
    total = chunk * n_chunks - chunk // 3  # the last chunk partial
    jtls = jtl.compile_timelines(_song(JSongEvent), 4, SR, total)
    ttls = ttl.compile_timelines(_song(TSongEvent), 4, SR, total)
    ja = np.asarray(jrender.render_performance(
        jrender.Performance([(INSTRUMENTS[name](jti), jtls)], SR), total, chunk_size=chunk))
    ta = trender.render_performance(trender.Performance([(INSTRUMENTS[name](tti), ttls)], SR),
                                    total, chunk, device="cpu").numpy()
    return ja, ta


@pytest.mark.parametrize("name", sorted(INSTRUMENTS))
def test_instrument_at_a_flat_chunk(name):
    ja, ta = _render_both(name)
    assert ta.shape == ja.shape and ta.dtype == np.float32
    assert np.abs(ja).max() > 0.01  # not silent
    db = _rms_db(ta, ja)
    print(f"{name} at chunk {FLAT}: {db:.1f} dBFS from the JAX render")
    assert db < BUDGET_DB, db


def test_nice_flat_branch_is_the_dense_cut_svf(monkeypatch):
    """Flat: both packages filter through svf_filter with a [V, n] cutoff
    and the activity mask; neither reaches the table path."""
    calls = {"jax": [], "port": []}

    def refuse(*a, **k):
        raise AssertionError("the table-cut SVF at a flat chunk")

    def spy(side, fn):
        def wrapped(l0, b0, x, filter_type, cutoff, res, active=None, *a):
            calls[side].append((tuple(cutoff.shape), tuple(active.shape)))
            return fn(l0, b0, x, filter_type, cutoff, res, active, *a)
        return wrapped

    monkeypatch.setattr(jfilt, "svf_filter_table", refuse)
    monkeypatch.setattr(tfilt, "svf_filter_table", refuse)
    monkeypatch.setattr(jfilt, "svf_filter", spy("jax", jfilt.svf_filter))
    monkeypatch.setattr(tfilt, "svf_filter", spy("port", tfilt.svf_filter))
    ja, ta = _render_both("nice")
    assert _rms_db(ta, ja) < BUDGET_DB
    assert calls["port"] == [((4, FLAT), (4, FLAT))] * N_CHUNKS
    assert len(calls["jax"]) >= 1 and calls["jax"][0] == ((4, FLAT), (4, FLAT))


def test_song_at_a_flat_chunk():
    """The Bach song's first half second at chunk 4,000 (6 chunks)."""
    total = 24000
    ja = np.asarray(jrender.render_performance(jsong.build_performance(total), total,
                                               chunk_size=4000))
    ta = trender.render_performance(tsong.build_performance(total), total, 4000,
                                    device="cpu").numpy()
    db = _rms_db(ta, ja)
    print(f"song at chunk 4000: {db:.1f} dBFS from the JAX render")
    assert np.abs(ja).max() > 0.1 and db < BUDGET_DB


@pytest.mark.parametrize("name", ["sampler", "poly_echo"])
def test_config_at_a_flat_chunk(name):
    """The sampler chain (0.1 s) and poly_echo (8 voices, 0.5 s, stereo
    echoes) at chunk 1,000."""
    if name == "sampler":
        jperf, total = jconfigs.build_sampler_performance(seconds=0.1)
        tperf, _ = tconfigs.build_sampler_performance(seconds=0.1)
    else:
        jperf, total = jconfigs.build_poly_echo_performance(num_voices=8, seconds=0.5)
        tperf, _ = tconfigs.build_poly_echo_performance(num_voices=8, seconds=0.5)
    ja = np.asarray(jrender.render_performance(jperf, total, chunk_size=FLAT))
    ta = trender.render_performance(tperf, total, FLAT, device="cpu").numpy()
    assert ta.shape == ja.shape and np.abs(ja).max() > 0.01
    for ch in range(ja.shape[0]):
        db = _rms_db(ta[ch], ja[ch])
        print(f"{name} channel {ch} at chunk {FLAT}: {db:.1f} dBFS")
        assert db < BUDGET_DB, (ch, db)
