"""The port's render paths on the card: each launches its kernel as often
as its chunks say, never the plain version (marker `cuda`; each case skips
without CUDA).

This file imports neither jax nor zang_tpu, so it runs where the card is,
without the suite's conftest (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py tests/test_torch_cuda_paths.py

The cases and their bounds are those the JAX-side port tests held them to
(tests/test_torch_{batch,examples,flat,parallel}.py): the batch fleet
launches K1 once a real chunk; the script example K2 34 times; a flat
chunk of NiceInstrument K2 once a chunk; a sharded render at one NCCL rank
is the one-card render's bits, at two gloo ranks on one card within
-120 dBFS of it with K1 once a chunk on each rank.
"""

import functools

import numpy as np
import pytest
import torch

from zang_tpu_torch.core import timeline as ttl
from zang_tpu_torch.core.notes import SongEvent as TSongEvent
from zang_tpu_torch.graph import render as trender
from zang_tpu_torch.graph.render import render_performance
from zang_tpu_torch.host import examples as tex
from zang_tpu_torch.host import instruments as tti
from zang_tpu_torch.host import song
from zang_tpu_torch.ops import filters as tfilt
from zang_tpu_torch.parallel import mesh as pm
from zang_tpu_torch.serve.batch import BatchRenderer, RenderJob

torch.set_num_threads(1)  # xdist workers share the cores (see PERF.md §7)

SR = 48000.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


# ---------------------------------------------------------------------------
# the batch fleet (from tests/test_torch_batch.py)

CHUNK = 2048  # multiple of the 512 tile; small so tests stay fast

# tests/test_serve.py:37-39
SONG_A = [(0.02, 0.3, 440.0), (0.25, 0.6, 550.0), (0.7, 0.9, 660.0)]
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
    tls = ttl.compile_timelines(_events(TSongEvent, notes), 2, SR, total)
    return trender.Performance([(tti.NiceInstrument(color), tls)], SR), total


@pytest.mark.cuda
def test_batch_launches_k1_once_a_real_chunk(cuda_device, monkeypatch):
    from zang_tpu_torch.ops import filters as tfilt

    def refuse(*a, **k):
        raise AssertionError("the plain SVF on a CUDA tensor")

    monkeypatch.setattr(tfilt, "svf_filter_table_ref", refuse)
    before = pm.launch_counts()["svf_table"]
    br = BatchRenderer(chunk_size=CHUNK, segment_chunks=2, devices=[cuda_device])
    results = br.run([RenderJob("a", lambda: _song(SONG_A, 1.0)),
                      RenderJob("c", lambda: _song(SONG_C, 1.3))])
    torch.cuda.synchronize()
    assert all(r.status == "ok" for r in results) and br.cache.traces == 1
    chunks = sum(-(-int(s * SR) // CHUNK) for s in (1.0, 1.3))
    assert pm.launch_counts()["svf_table"] - before == chunks


# ---------------------------------------------------------------------------
# the script example (from tests/test_torch_examples.py)


@pytest.mark.cuda
def test_script_example_counts_k2_launches(cuda_device):
    """The script example at its default 6 s, chunk 16,384: the delay of
    11,025 halves each chunk to two sub-chunks of 8,192, and the feedback
    Filter (scalar res, low-pass) launches K2 once a sub-chunk: 17 chunks,
    34 launches."""
    before = pm.launch_counts()["svf_dense"]
    audio, sr = tex.ex_script(device="cuda")
    torch.cuda.synchronize()
    assert pm.launch_counts()["svf_dense"] - before == 34
    assert audio.shape == (1, int(6.0 * sr)) and bool(torch.isfinite(audio).all())


# ---------------------------------------------------------------------------
# the flat chunk format (from tests/test_torch_flat.py)

FLAT = 1000  # frames a chunk: not a multiple of the 512-frame tile
N_CHUNKS = 3


def _flat_song(event_cls, extra=None):
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
    "nice": lambda m: m.NiceInstrument(np.array([0.25, 0.1, 0.3, 0.2], np.float32)),
}


@pytest.mark.cuda
def test_flat_nice_launches_k2_on_the_card(cuda_device, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the plain SVF on a CUDA tensor")

    monkeypatch.setattr(tfilt, "svf_filter_ref", refuse)
    total = FLAT * N_CHUNKS
    tls = ttl.compile_timelines(_flat_song(TSongEvent), 4, SR, total)
    before = pm.launch_counts()["svf_dense"]
    got = trender.render_performance(
        trender.Performance([(INSTRUMENTS["nice"](tti), tls)], SR), total, FLAT,
        device=cuda_device)
    torch.cuda.synchronize()
    assert pm.launch_counts()["svf_dense"] == before + N_CHUNKS
    assert bool(torch.isfinite(got).all())


# ---------------------------------------------------------------------------
# sharded renders (from tests/test_torch_parallel.py)

SONG_TOTAL = int(2.0 * song.SAMPLE_RATE)
SONG_CHUNK = 16384
TOL_SHARD_DB = -120.0
TIMEOUT = 600.0  # seconds a spawned launch may take


def _db(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return 20 * np.log10(np.sqrt((d * d).mean()) + 1e-30)


@pytest.mark.cuda
def test_nccl_one_rank_is_render_performance(cuda_device):
    """NCCL at W = 1 on cuda:0: the one-card render's bits."""
    build = functools.partial(song.song_build, SONG_TOTAL)
    got = pm.render_performance_sharded(build, SONG_TOTAL, pm.make_mesh(1), SONG_CHUNK,
                                        timeout=TIMEOUT)
    want = render_performance(song.build_performance(SONG_TOTAL), SONG_TOTAL, SONG_CHUNK,
                              device=cuda_device).cpu().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card(cuda_device, tmp_path):
    """Two ranks on cuda:0 through gloo: each launches K1 a chunk at its own
    voices, the mix within -120 dBFS of the one-card render."""
    mesh = pm.make_mesh(devices=[cuda_device, cuda_device])
    assert mesh.backend == "gloo"
    job = pm.RenderJob(functools.partial(song.song_build, SONG_TOTAL, 2), SONG_TOTAL,
                       SONG_CHUNK, str(tmp_path / "mix.npy"))
    stats = pm.run_ranks(pm.render_rank, mesh, [job], timeout=TIMEOUT)
    got = np.load(tmp_path / "mix.npy")
    want = render_performance(song.build_performance(SONG_TOTAL), SONG_TOTAL, SONG_CHUNK,
                              device=cuda_device).cpu().numpy()
    assert _db(got, want) < TOL_SHARD_DB
    n_chunks = -(-SONG_TOTAL // SONG_CHUNK)
    assert [s[0]["launches"]["svf_table"] for s in stats] == [n_chunks, n_chunks]
    assert len({s[0]["digest"] for s in stats}) == 1
