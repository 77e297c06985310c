"""The port's batch fleet (zang_tpu_torch/serve/batch.py) against zang_tpu's
(tests/test_serve.py), on the CPU.

- Graph keys: over the JAX test songs, two songs key alike in the port
  exactly where they key alike in the JAX package; a tensor keys by its
  content, as an array does.
- render_song_shared (f32 and s16, segment_chunks 2, chunk 2048): within
  -90 dBFS RMS (f32) and 1 LSB (s16) of the JAX package's on the same
  programs (carried across with convert), and the port's own
  render_performance bit for bit (f32), and its mixdown bit for bit (s16).
  The port renders only the real chunks (no chunk-axis padding), and the
  slot axis is padded as the JAX package pads it, bit for bit.
- The scheduler as tests/test_serve.py holds the JAX one: one build per
  graph key and device (`traces`), shared_compile, retry, max attempts,
  duplicate names, cache eviction, the WAV written segment by segment,
  script instruments sharing one entry; devices=["cpu", "cpu"] runs two
  worker groups at once; devices=None without CUDA raises.
- On the card, tests/test_torch_cuda_paths.py (marker `cuda`): a batch of
  songs launches K1 once a real chunk, never the plain SVF.
"""

import threading

import numpy as np
import pytest
import torch

from zang_tpu.core.notes import SongEvent as JSongEvent
from zang_tpu.core.timeline import compile_timelines as jcompile
from zang_tpu.graph.render import Performance as JPerformance
from zang_tpu.host import instruments as jti
from zang_tpu.serve import batch as jbatch
from zang_tpu_torch import convert
from zang_tpu_torch.core.mixdown import mixdown_s16_np
from zang_tpu_torch.core.notes import SongEvent as TSongEvent
from zang_tpu_torch.core.timeline import compile_timelines as tcompile
from zang_tpu_torch.core.wav import read_wav
from zang_tpu_torch.graph import render as trender
from zang_tpu_torch.graph.render import Performance as TPerformance
from zang_tpu_torch.host import instruments as tti
from zang_tpu_torch.serve import batch as tbatch
from zang_tpu_torch.serve.batch import BatchRenderer, RenderJob, render_song_shared

torch.set_num_threads(1)  # xdist workers share the cores (see PERF.md §7)

SR = 48000.0
CHUNK = 2048  # multiple of the 512 tile; small so tests stay fast
BUDGET_DB = -90.0

# tests/test_serve.py:37-39
SONG_A = [(0.02, 0.3, 440.0), (0.25, 0.6, 550.0), (0.7, 0.9, 660.0)]
SONG_B = [(0.0, 0.5, 220.0), (0.1, 0.4, 330.0)]
SONG_C = [(0.05, 0.2, 880.0), (0.3, 0.5, 770.0), (0.55, 0.8, 440.0),
          (0.85, 1.1, 523.25)]


def _events(cls, notes):
    events, nid = [], 1
    for t_on, t_off, freq in notes:
        events.append(cls({"freq": freq, "note_on": True}, t_on, nid))
        events.append(cls({"freq": freq, "note_on": False}, t_off, nid))
        nid += 1
    events.sort(key=lambda e: e.t)
    return events


def _song(notes, seconds, color=0.3):
    """The port's (Performance, total_frames) of tests/test_serve.py's _song."""
    total = int(seconds * SR)
    tls = tcompile(_events(TSongEvent, notes), 2, SR, total)
    return TPerformance([(tti.NiceInstrument(color), tls)], SR), total


def _jsong(notes, seconds, color=0.3):
    total = int(seconds * SR)
    tls = jcompile(_events(JSongEvent, notes), 2, SR, total)
    return JPerformance([(jti.NiceInstrument(color), tls)], SR), total


def _rms_db(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return 20 * np.log10(np.sqrt(np.mean(d * d)) + 1e-30)


def _cpu(**kw):
    return BatchRenderer(chunk_size=CHUNK, segment_chunks=2, devices=["cpu"], **kw)


# ---------------------------------------------------------------------------
# graph keys


def test_graph_keys_equal_where_the_jax_keys_are():
    songs = [(SONG_A, 1.0, 0.3), (SONG_B, 0.7, 0.3), (SONG_C, 1.3, 0.3),
             (SONG_A, 0.5, 0.9), (SONG_B, 0.5, 0.9)]
    jkeys, tkeys = [], []
    for notes, seconds, color in songs:
        jperf, _ = _jsong(notes, seconds, color)
        tperf, _ = _song(notes, seconds, color)
        jkeys.append(jbatch.graph_key(jperf, jbatch._split_programs(jperf.programs)[0],
                                      CHUNK, 2))
        tkeys.append(tbatch.graph_key(tperf, tbatch._split_programs(tperf.programs)[0],
                                      CHUNK, 2))
    jeq = [[a == b for b in jkeys] for a in jkeys]
    teq = [[a == b for b in tkeys] for a in tkeys]
    assert teq == jeq
    assert jeq[0][1] and jeq[0][2] and not jeq[0][3] and jeq[3][4]  # the songs' claims


def test_leaf_key_takes_a_tensor_by_content():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    t = torch.from_numpy(a.copy())
    assert tbatch._leaf_key(t) == tbatch._leaf_key(a) == jbatch._leaf_key(a)
    assert tbatch._leaf_key(t.clone()) == tbatch._leaf_key(t)
    assert tbatch._leaf_key(t + 1) != tbatch._leaf_key(t)
    assert tbatch._leaf_key({"x": [t, 2, 0.5]}) == tbatch._leaf_key({"x": [a, 2, 0.5]})
    for v in (np.float32(0.25), 3, "s", None, (1, 2.0)):
        assert tbatch._leaf_key(v) == jbatch._leaf_key(v)


def test_pad_slot_axes_is_the_jax_packages():
    """Tiled song programs and flat chunks, padded to the power-of-two
    buckets, bit for bit."""
    perf, total = _song(SONG_C, 1.3)
    for chunk in (CHUNK, 1000):
        xs, _ = trender.host_slices(perf, total, chunk)
        for minimum in (1, 4, 8):
            got = tbatch._pad_slot_axes(xs, minimum)
            want = jbatch._pad_slot_axes(xs, minimum)
            for g, w in zip(got, want):
                assert g.keys() == w.keys()
                for k in g:
                    for name in g[k]:
                        assert g[k][name].dtype == w[k][name].dtype
                        np.testing.assert_array_equal(g[k][name], w[k][name])


# ---------------------------------------------------------------------------
# render_song_shared


@pytest.mark.parametrize("emit", ["f32", "s16"])
def test_shared_render_matches_jax_and_the_ports_render(emit):
    """Two songs through one cache in each package, the port's on the JAX
    programs: f32 within -90 dBFS of the JAX package's, s16 within 1 LSB;
    and the port's own render_performance bit for bit."""
    jcache, tcache = jbatch.SharedGraphCache(), tbatch.SharedGraphCache()
    vol = None if emit == "f32" else 0.25
    for notes, seconds in [(SONG_A, 1.0), (SONG_B, 0.7)]:
        jperf, total = _jsong(notes, seconds)
        tperf = convert.from_jax_performance(jperf, "cpu")
        want = jbatch.render_song_shared(jcache, jperf, total, CHUNK, segment_chunks=2,
                                         s16_volume=vol)
        got = render_song_shared(tcache, tperf, total, CHUNK, segment_chunks=2,
                                 s16_volume=vol, device="cpu")
        own = trender.render_performance(tperf, total, CHUNK, device="cpu").numpy()
        assert got.shape == want.shape == own.shape
        if emit == "f32":
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, own)
            assert np.abs(want).max() > 0.01
            assert _rms_db(got, want) < BUDGET_DB
        else:
            assert got.dtype == np.int16
            np.testing.assert_array_equal(got, mixdown_s16_np(own, 0.25))
            assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    assert tcache.traces == 1  # both songs through one build, as the JAX cache


def test_only_real_chunks_render_and_segments_stream(monkeypatch):
    """A 5-chunk song at 2 chunks a segment: 5 steps (the JAX package
    renders 6), the segments trimmed and handed over in order."""
    perf, total = _song(SONG_A, 0.2)  # 9,600 frames: 5 chunks, the last partial
    calls = []
    real = trender.make_stream_step

    def counting(*a, **k):
        step = real(*a, **k)

        def wrapped(state, c0, xs_chunk, programs=None):
            calls.append(c0)
            return step(state, c0, xs_chunk, programs)
        return wrapped

    monkeypatch.setattr(tbatch, "make_stream_step", counting)
    segs = []
    assert render_song_shared(tbatch.SharedGraphCache(), perf, total, CHUNK,
                              segment_chunks=2, on_segment=segs.append,
                              device="cpu") is None
    assert calls == [i * CHUNK for i in range(5)]
    assert [s.shape[1] for s in segs] == [2 * CHUNK, 2 * CHUNK, total - 4 * CHUNK]
    want = trender.render_performance(_song(SONG_A, 0.2)[0], total, CHUNK,
                                      device="cpu").numpy()
    np.testing.assert_array_equal(np.concatenate(segs, axis=1), want)


def test_slot_padding_keeps_the_bits():
    """slot_minimum 8 pads every table to 8 slots: the same bits as the
    unpadded render (edge padding re-selects the same value)."""
    perf, total = _song(SONG_C, 1.3)
    want = trender.render_performance(perf, total, CHUNK, device="cpu").numpy()
    for minimum in (1, 8):
        got = render_song_shared(tbatch.SharedGraphCache(), perf, total, CHUNK,
                                 segment_chunks=3, slot_minimum=minimum, device="cpu")
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the scheduler (tests/test_serve.py)


def test_compile_shared_across_songs():
    br = _cpu()
    jobs = [RenderJob("a", lambda: _song(SONG_A, 1.0)),
            RenderJob("b", lambda: _song(SONG_B, 0.7)),
            RenderJob("c", lambda: _song(SONG_C, 1.3))]
    results = br.run(jobs)
    assert all(r.status == "ok" for r in results), [r.error for r in results]
    assert br.cache.traces == 1, br.cache.traces
    assert sum(r.shared_compile for r in results) >= 1
    for r, (notes, seconds) in zip(results, [(SONG_A, 1.0), (SONG_B, 0.7), (SONG_C, 1.3)]):
        perf, total = _song(notes, seconds)
        np.testing.assert_array_equal(
            r.audio, trender.render_performance(perf, total, CHUNK, device="cpu").numpy())
        assert r.device == "cpu" and r.attempts == 1 and r.rtf > 0
    perf, total = _song(SONG_A, 0.5)
    other = TPerformance([(tti.NiceInstrument(0.9), perf.parts[0][1])], SR)
    render_song_shared(br.cache, other, total, CHUNK, segment_chunks=2, device="cpu")
    assert br.cache.traces == 2


def test_failed_job_requeued():
    calls = {"n": 0}

    def flaky_build():
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected worker failure")
        return _song(SONG_B, 0.5)

    results = _cpu(max_attempts=3).run([RenderJob("flaky", flaky_build)])
    assert results[0].status == "ok"
    assert results[0].attempts == 2


def test_job_fails_after_max_attempts():
    def doomed():
        raise ValueError("always broken")

    results = _cpu(max_attempts=2).run([RenderJob("doomed", doomed)])
    assert results[0].status == "failed"
    assert results[0].error == "ValueError: always broken"
    assert results[0].attempts == 2


def test_script_error_and_public_errors_are_not_retried():
    from zang_tpu_torch.script.compile import compile_script

    calls = []

    class _Public(Exception):
        no_retry = True
        public_error = "bad request body"

    def bad_script():
        calls.append("script")
        compile_script("Bad = defmodule begin out nope end")

    def bad_body():
        calls.append("body")
        raise _Public("internal detail")

    results = _cpu(max_attempts=3).run([RenderJob("s", bad_script),
                                        RenderJob("b", bad_body)])
    assert [r.status for r in results] == ["failed", "failed"]
    assert [r.attempts for r in results] == [1, 1] and sorted(calls) == ["body", "script"]
    assert results[1].error == "bad request body"
    assert results[0].error.startswith("ScriptError")


def test_streamed_wav_output(tmp_path):
    """out_dir mode streams segment WAVs; the bytes are the mixdown of the
    port's render_performance, bit for bit."""
    br = BatchRenderer(out_dir=str(tmp_path), chunk_size=CHUNK, segment_chunks=2,
                       devices=["cpu"])
    results = br.run([RenderJob("s", lambda: _song(SONG_A, 1.0), volume=0.25)])
    assert results[0].status == "ok"
    w = read_wav(results[0].wav_path)
    assert w.sample_rate == int(SR) and w.bits_per_sample == 16
    perf, total = _song(SONG_A, 1.0)
    want = mixdown_s16_np(trender.render_performance(perf, total, CHUNK,
                                                     device="cpu").numpy(), 0.25)
    np.testing.assert_array_equal(np.frombuffer(w.data, dtype="<i2"), want.reshape(-1))


def test_two_devices_schedule_over_both():
    """devices=["cpu", "cpu"], one worker each: both render at once (a
    barrier that only two concurrent builds pass), and every result lands."""
    barrier = threading.Barrier(2, timeout=60)

    def build(notes, seconds):
        barrier.wait()
        return _song(notes, seconds)

    br = BatchRenderer(chunk_size=CHUNK, segment_chunks=2, devices=["cpu", "cpu"],
                       workers_per_device=1)
    jobs = [RenderJob("j0", lambda: build(SONG_A, 0.5)),
            RenderJob("j1", lambda: build(SONG_B, 0.6))]
    results = br.run(jobs)
    assert all(r.status == "ok" for r in results), [r.error for r in results]
    assert br.cache.traces == 1  # one graph, one device
    perf, total = _song(SONG_B, 0.6)
    np.testing.assert_array_equal(
        results[1].audio, trender.render_performance(perf, total, CHUNK,
                                                     device="cpu").numpy())


def test_script_instrument_jobs_share_compile():
    from zang_tpu_torch.script.compile import compile_script
    from zang_tpu_torch.script.torch_backend import ScriptInstrument

    src = """
Voice = defmodule
    freq: constant,
    note_on: boolean,
begin
    out SineOsc(freq, phase=0)
        * Envelope(attack=.cubed(0.02), decay=.cubed(0.1),
                   release=.cubed(0.3), sustain_volume=0.6, note_on)
end
"""
    compiled = compile_script(src, filename="<serve>")

    def song(notes, seconds):
        total = int(seconds * SR)
        tls = tcompile(_events(TSongEvent, notes), 2, SR, total)
        return TPerformance([(ScriptInstrument(compiled, "Voice"), tls)], SR), total

    br = _cpu()
    results = br.run([RenderJob("sa", lambda: song(SONG_A, 1.0)),
                      RenderJob("sb", lambda: song(SONG_B, 0.7))])
    assert all(r.status == "ok" for r in results), [r.error for r in results]
    assert br.cache.traces == 1, br.cache.traces
    perf, total = song(SONG_A, 1.0)
    np.testing.assert_array_equal(
        results[0].audio, trender.render_performance(perf, total, CHUNK,
                                                     device="cpu").numpy())


def test_duplicate_job_names_rejected():
    jobs = [RenderJob("same", lambda: _song(SONG_B, 0.5)),
            RenderJob("same", lambda: _song(SONG_B, 0.5))]
    with pytest.raises(ValueError, match="duplicate job names"):
        _cpu().run(jobs)


def test_graph_cache_eviction_bound():
    """Three graphs (three organ colours) through a cache of two: the
    oldest goes, with its pin, and comes back as a miss."""
    cache = tbatch.SharedGraphCache(max_entries=2)
    perfs = [_song(SONG_B, 0.5, color)[0] for color in (0.1, 0.2, 0.3)]
    for perf in [*perfs, perfs[2], perfs[0]]:
        skeleton, _ = tbatch._split_programs(perf.programs)
        cache.get(perf, skeleton, CHUNK, 2, device="cpu")
        assert len(cache._fns) <= 2 and len(cache._pinned) <= 2
    assert cache.traces == 4  # 3 builds, a hit, then the evicted first again


def test_cli_renders_songs(tmp_path, capsys):
    """python -m zang_tpu_torch.serve.batch --out DIR --songs 2 --seconds S
    --device cpu: two slices of the Toccata through one build, each WAV the
    port's render of the slice mixed down at 0.25."""
    import json

    from zang_tpu_torch.host import song as tsong

    assert tbatch.main(["--out", str(tmp_path), "--songs", "2", "--seconds", "0.3",
                        "--chunk", str(CHUNK), "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.splitlines()[0])
    assert (summary["jobs"], summary["ok"], summary["traces"]) == (2, 2, 1)
    total = int(0.3 * tsong.SAMPLE_RATE)
    want = mixdown_s16_np(trender.render_performance(
        tsong.build_performance(total), total, CHUNK, device="cpu").numpy(), 0.25)
    for i in range(2):
        w = read_wav(str(tmp_path / f"toccata_{i:03d}.wav"))
        np.testing.assert_array_equal(np.frombuffer(w.data, "<i2"), want.reshape(-1))


def test_default_devices_need_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        BatchRenderer(chunk_size=CHUNK).run([RenderJob("a", lambda: _song(SONG_B, 0.5))])
    with pytest.raises(RuntimeError, match="is_available"):
        render_song_shared(tbatch.SharedGraphCache(), *_song(SONG_B, 0.5), CHUNK)
