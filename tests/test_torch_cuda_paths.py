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
-120 dBFS of it with K1 once a chunk on each rank; at two and four NCCL
ranks on as many cards every chunk is within -120 dBFS of it, each rank's
chunk step a graph that holds the all-reduce, and at two it is the bits of
two gloo ranks' eager step.

The chunk step as a CUDA graph (graph/render.GraphStep): the graphed
render is Performance.render_chunk called in a loop, bit for bit (the
song, the first 3 chunks of poly_echo at 4096 voices, the song at a flat
chunk); a stream resumed from a held mid-piece state is the straight
render; what a call returned is never overwritten by later calls; the
kernels' launch counts are the eager render's (282 K1 for the song, 6 K3
for poly_echo at 4096 voices x 8 s, and the tile windows' one a program
and chunk: 1,128 and 12); and K1 and K3 given the chunk's first
frame in device memory are their by-value launch bit for bit. The graphed
render sends the programs' tables up once and cuts each chunk's tiles on
the card, one cut a program a chunk ("slice.windows").

The tile windows (ops/tile_windows.py): the kernel's cut of every chunk,
its first frame by value and read from the card, is the plain version's
bit for bit (the song's programs, poly_echo's at 4096 voices, and drawn
edge cases with 40 values of 1 to 8 bytes), one launch a cut of up to 32
values ("launch.tile_windows"); it refuses what it cannot cut, and counts
nothing then.
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
from zang_tpu_torch.ops import tile_windows as twin
from zang_tpu_torch.ops.segprog import SegProgram, plan_windows
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
    job = pm.RenderJob(pm.whole(functools.partial(song.song_build, SONG_TOTAL, 2)), SONG_TOTAL,
                       SONG_CHUNK, str(tmp_path / "mix.npy"))
    stats = pm.run_ranks(pm.render_rank, mesh, [job], timeout=TIMEOUT)
    got = np.load(tmp_path / "mix.npy")
    want = render_performance(song.build_performance(SONG_TOTAL), SONG_TOTAL, SONG_CHUNK,
                              device=cuda_device).cpu().numpy()
    assert _db(got, want) < TOL_SHARD_DB
    n_chunks = -(-SONG_TOTAL // SONG_CHUNK)
    assert [s[0]["launches"]["svf_table"] for s in stats] == [n_chunks, n_chunks]
    assert len({s[0]["digest"] for s in stats}) == 1


@pytest.mark.cuda
def test_nccl_one_rank_renders_through_the_graph(cuda_device):
    """The texture of voice streams at 4096 voices x 3 chunks, two jobs
    through one ShardedRenderer at one NCCL rank on cuda:0: K3 a chunk, the
    chunks after the first two one replay each of a graph that holds the
    all-reduce, render_performance's bits."""
    from zang_tpu_torch.graph.render import Performance
    from zang_tpu_torch.host import configs

    texture = (4096, 3 * 65536 / 44100.0, 44100.0, 15000, 11)
    total = int(texture[1] * texture[2])
    build = functools.partial(configs.texture_block_build, *texture)
    with pm.ShardedRenderer(pm.make_mesh(1), timeout=TIMEOUT) as r:
        runs = [r.render(pm.RenderJob(build, total, 65536)) for _ in range(2)]
    parts, sr, kw = configs.texture_block_build(*texture, 0, 1)
    want = render_performance(Performance(parts, sr, **kw), total, 65536,
                              device=cuda_device).cpu().numpy()
    for got, (rank,) in runs:
        np.testing.assert_array_equal(got, want)
        c = rank["counts"]
        assert c["chunks"] == c["allreduce.calls"] == 3 and c["graph.replays"] == 2
        assert c["graph.captures"] == 1 and rank["launches"]["svf_onepass"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("W", [2, 4])
def test_nccl_ranks_render_every_chunk_as_one_card(cuda_device, W):
    """The texture of voice streams at 4096 voices a rank (K3) x 4 chunks
    over W NCCL ranks on cuda:0 .. W-1, two jobs through one
    ShardedRenderer: every chunk within -120 dBFS of the one-card render,
    and on every rank the chunks after the first one replay each of a
    graph that holds the all-reduce; at W = 2 the bits of two gloo ranks on
    the same cards, whose step is eager (a sum of two is the same in any
    order)."""
    if torch.cuda.device_count() < W:
        pytest.skip(f"needs {W} cards")
    from zang_tpu_torch.graph.render import Performance
    from zang_tpu_torch.host import configs

    chunk = 16384
    texture = (4096 * W, 4 * chunk / 44100.0, 44100.0, 15000, 13)
    total = int(texture[1] * texture[2])
    build = functools.partial(configs.texture_block_build, *texture)
    parts, sr, kw = configs.texture_block_build(*texture, 0, 1)
    want = render_performance(Performance(parts, sr, **kw), total, chunk,
                              device=cuda_device).cpu().numpy()
    with pm.ShardedRenderer(pm.make_mesh(W), timeout=TIMEOUT) as r:
        runs = [r.render(pm.RenderJob(build, total, chunk)) for _ in range(2)]
    for got, ranks in runs:
        for c0 in range(0, total, chunk):
            assert _db(got[:, c0:c0 + chunk], want[:, c0:c0 + chunk]) < TOL_SHARD_DB, c0
        for rank in ranks:
            c = rank["counts"]
            assert c["chunks"] == c["allreduce.calls"] == 4 and c["graph.replays"] == 3
            assert rank["launches"]["svf_onepass"] == 4
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    if W == 2:
        with pm.ShardedRenderer(pm.make_mesh(2, backend="gloo"), timeout=TIMEOUT) as r:
            eager, ranks = r.render(pm.RenderJob(build, total, chunk))
        assert all("graph.replays" not in rank["counts"] for rank in ranks)
        np.testing.assert_array_equal(runs[0][0], eager)


# ---------------------------------------------------------------------------
# the chunk step as a CUDA graph (graph/render.GraphStep)

TEXTURE_SR = 44100.0


def _graph_perf(name):
    """(Performance, total frames, chunk) of a graphed render."""
    from zang_tpu_torch.host import configs

    if name == "song":
        total = int(song.NUM_SECONDS * song.SAMPLE_RATE)
        return song.build_performance(total), total, 65536
    if name == "song_flat":
        total = int(song.NUM_SECONDS * song.SAMPLE_RATE)
        return song.build_performance(total), total, 65000
    if name == "poly_echo_4096_3":  # its first 3 chunks
        perf, total = configs.build_poly_echo_performance(
            4096, 3 * 65536 / TEXTURE_SR, TEXTURE_SR, 15000, seed=7)
        return perf, total, 65536
    if name == "poly_echo_4096":
        perf, total = configs.build_poly_echo_performance(4096, 8.0, TEXTURE_SR, 15000)
        return perf, total, 65536
    raise ValueError(name)


def _eager_loop(perf, total, chunk, dev):
    """Performance.render_chunk called in a loop: every op enqueued from
    here, the chunk's first frame an int, the programs sliced on the host.
    Returns [C, total] on dev."""
    xs, n_chunks = trender.host_slices(perf, total, chunk)
    static = [trender._map_arrays(p, lambda a: trender._to_device(a, dev))
              for p in perf.programs]
    base = torch.arange(chunk, dtype=torch.int32, device=dev)
    state, out = perf.init_state(dev), []
    for i in range(n_chunks):
        c0 = i * chunk
        progs = trender._map_arrays(xs, lambda a, i=i: trender._to_device(a[i], dev))
        ctx = trender.RenderCtx(perf.sample_rate, base + c0, c0, chunk)
        state, audio = perf.render_chunk(state, progs, ctx, static)
        out.append(audio)
    return torch.cat(out, dim=1)[:, :total]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["song", "poly_echo_4096_3", "song_flat"])
def test_graphed_render_is_the_eager_loop(cuda_device, name):
    from zang_tpu_torch import trace

    perf, total, chunk = _graph_perf(name)
    assert trender.capturable(perf)
    assert isinstance(trender.make_stream_step(perf, chunk, device=cuda_device),
                      trender.GraphStep)
    n_chunks = -(-total // chunk)
    before = trace.counters()
    got = render_performance(perf, total, chunk, device=cuda_device).cpu().numpy()
    after = trace.counters()
    want = _eager_loop(perf, total, chunk, cuda_device).cpu().numpy()
    np.testing.assert_array_equal(got, want)
    assert np.abs(want).max() > 1e-3
    diff = {k: after.get(k, 0) - before.get(k, 0)
            for k in ("graph.captures", "graph.replays", "h2d.copies", "chunks",
                      "slice.windows")}
    static = sum(len(trender._leaves(p)) for p in perf.programs)
    # tiled: the tables in one copy, each chunk's tiles cut on the card
    tiled = trender.tiled(chunk)
    progs = len(trender._leaves(perf.programs, SegProgram)) if tiled else 0
    assert diff == {"graph.captures": 1, "graph.replays": n_chunks - 1,
                    "h2d.copies": n_chunks + static + tiled, "chunks": n_chunks,
                    "slice.windows": n_chunks * progs}


@pytest.mark.cuda
def test_stream_resumed_from_a_held_state_is_the_straight_render(cuda_device):
    perf, total, chunk = _graph_perf("song")
    want = render_performance(perf, total, chunk, device=cuda_device).cpu().numpy()
    xs, n_chunks = perf.chunk_xs(total, chunk)
    step = trender.make_stream_step(perf, chunk, device=cuda_device)
    at = lambda i: trender._map_arrays(xs, lambda a: a[i])  # noqa: E731
    state, k = None, 5
    for i in range(k):
        state, _ = step(state, i * chunk, at(i))
    held = state
    for i in range(k, k + 4):  # the graph's own state moves on
        state, _ = step(state, i * chunk, at(i))
    for fresh in (False, True):  # the same step, and a new one (a checkpoint)
        s = trender.make_stream_step(perf, chunk, device=cuda_device) if fresh else step
        state, got = held, []
        for i in range(k, n_chunks):
            state, audio = s(state, i * chunk, at(i))
            got.append(audio)
        got = torch.cat(got, dim=1)[:, :total - k * chunk].cpu().numpy()
        np.testing.assert_array_equal(got, want[:, k * chunk:])


@pytest.mark.cuda
def test_what_a_graphed_step_returned_is_never_overwritten(cuda_device):
    perf, total, chunk = _graph_perf("poly_echo_4096_3")
    xs, n_chunks = perf.chunk_xs(total, chunk)
    step = trender.make_stream_step(perf, chunk, device=cuda_device)
    at = lambda i: trender._map_arrays(xs, lambda a: a[i])  # noqa: E731
    state, _ = step(None, 0, at(0))
    state, audio = step(state, chunk, at(1))  # the capture's chunk
    leaves = trender._leaves(state, torch.Tensor)
    kept = [t.clone() for t in leaves] + [audio.clone()]
    step(state, 2 * chunk, at(2))  # from the state it returned
    step(state, 2 * chunk, at(2))  # and again, the held state copied in
    torch.cuda.synchronize()
    for t, k in zip(leaves + [audio], kept):
        assert torch.equal(t, k)


@pytest.mark.cuda
@pytest.mark.parametrize("name,kernel,launches,windows", [("song", "svf_table", 282, 1128),
                                                           ("poly_echo_4096", "svf_onepass", 6,
                                                            12)])
def test_graphed_render_counts_every_launch(cuda_device, name, kernel, launches, windows):
    # the tile windows: one launch a SegProgram (the song's 4, poly_echo's 2) and chunk
    perf, total, chunk = _graph_perf(name)
    before = pm.launch_counts()
    render_performance(perf, total, chunk, device=cuda_device)
    torch.cuda.synchronize()
    after = pm.launch_counts()
    want = {kernel: launches, "tile_windows": windows}
    assert {k: after[k] - before[k] for k in after} == {k: want.get(k, 0) for k in after}


def _table_case(V, n, nt, S, t0, seed=3):
    rng = np.random.default_rng(seed)
    T = n // nt
    tb = np.empty((V, nt, S), np.int32)
    tb[:, :, 0] = -(2 ** 31)
    tb[:, :, 1:] = (np.sort(rng.integers(0, T, (V, nt, S - 1)), axis=-1)
                    + t0 + np.arange(nt)[None, :, None] * T)
    return (rng.standard_normal(V).astype(np.float32) * 0.1,
            rng.standard_normal(V).astype(np.float32) * 0.1,
            (rng.standard_normal((V, n)) * 0.3).astype(np.float32), tb,
            rng.uniform(0.05, 0.9, (V, nt, S)).astype(np.float32),
            rng.integers(t0, t0 + n // 2, V).astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["svf_table_cuda", "svf_onepass_cuda"])
@pytest.mark.parametrize("shape", [(14, 65536, 128, 2), (4096, 65536, 128, 3)],
                         ids=["song", "V4096"])
def test_table_kernels_read_t0_from_the_card(cuda_device, kernel, shape):
    from zang_tpu_torch.ops import svf_cuda

    t0 = 37 * 65536
    l0, b0, x, tb, cv, af = (torch.from_numpy(a).to(cuda_device)
                             for a in _table_case(*shape, t0))
    fn = getattr(svf_cuda, kernel)
    by_value = fn(l0, b0, x, "low_pass", tb, cv, 0.7, t0, af)
    on_card = torch.tensor([t0], dtype=torch.int32, device=cuda_device)
    by_pointer = fn(l0, b0, x, "low_pass", tb, cv, 0.7, on_card, af)
    for a, b in zip(by_value, by_pointer):
        assert torch.equal(a, b)
    assert float(by_value[2].abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# the tile windows cut on the card (ops/tile_windows.py, csrc/tile_windows.cu)


def _windows_cases(name):
    """[(SegProgram, chunk, total)] of a render's programs, or of programs
    drawn to hit the edges (starts at and past total, on tile boundaries,
    before 0, repeated) with 40 values of 1 to 8 bytes an element (two
    launches a cut)."""
    if name != "edges":
        perf, total, chunk = _graph_perf(name)
        return [(sp, chunk, total) for sp in trender._leaves(perf.programs, SegProgram)]
    rng = np.random.default_rng(5)
    V, K, total = 33, 40, 20000
    starts = np.sort(np.concatenate([rng.integers(-600, total + 1500, (V, K // 2)),
                                     rng.integers(0, total // 512 + 2, (V, K // 2)) * 512],
                                    axis=1), axis=1)
    starts[0] = [0] + [total] * (K - 1)
    starts[1, 3:9] = starts[1, 3]
    dtypes = [np.float32, np.int32, np.uint32, np.float64, np.int16, np.uint8, np.int64]
    values = {f"v{j}": rng.integers(0, 200, (V, K)).astype(dtypes[j % len(dtypes)])
              for j in range(40)}
    return [(SegProgram(starts, values), c, total) for c in (2048, 5120)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["song", "poly_echo_4096", "edges"])
def test_tile_windows_kernel_is_the_plain_cut(cuda_device, name):
    """Every chunk's cut by the kernel (c0 by value, and read from the card)
    against the plain version's on the CPU, bit for bit and dtype for dtype."""
    for sp, chunk, total in _windows_cases(name):
        n_chunks = -(-total // chunk)
        plan = plan_windows(sp, chunk, n_chunks, total)
        host = trender._upload_tables([sp], "cpu")[0]
        card = trender._upload_tables([sp], cuda_device)[0]
        launches = -(-max(len(sp.values), 1) // 32)
        for i in range(n_chunks):
            want = twin.tile_windows_ref(host, plan, i * chunk)
            c0 = torch.tensor([i * chunk], dtype=torch.int32, device=cuda_device)
            before = pm.launch_counts()["tile_windows"]
            cuts = (twin.tile_windows_cuda(card, plan, i * chunk),
                    twin.tile_windows_cuda(card, plan, c0))
            assert pm.launch_counts()["tile_windows"] - before == 2 * launches
            for got in cuts:
                assert got.keys() == want.keys()
                for k, w in want.items():
                    g = got[k].cpu()
                    assert g.dtype == w.dtype and g.shape == w.shape, (k, i)
                    assert torch.equal(g, w), (k, i)


@pytest.mark.cuda
def test_tile_windows_kernel_refuses_what_it_cannot_cut(cuda_device):
    from zang_tpu_torch import trace

    sp = _windows_cases("song")[0][0]
    plan = plan_windows(sp, 65536, 2, 65536 * 2)
    card = trender._upload_tables([sp], cuda_device)[0]
    before = (pm.launch_counts()["tile_windows"], trace.counters().get("slice.windows", 0))
    with pytest.raises(ValueError, match="int32"):
        twin.tile_windows_cuda(twin.SegTable(card.starts.long(), card.values), plan, 0)
    bad = {k: v[:, :1].contiguous() for k, v in card.values.items()}
    with pytest.raises(ValueError, match="shape"):
        twin.tile_windows_cuda(twin.SegTable(card.starts, bad), plan, 0)
    with pytest.raises(ValueError, match="c0"):
        twin.tile_windows_cuda(card, plan, torch.zeros(2, dtype=torch.int32,
                                                        device=cuda_device))
    with pytest.raises(ValueError, match="c0"):  # through the router
        twin.tile_windows(card, plan, torch.zeros(2, dtype=torch.int32, device=cuda_device))
    assert (pm.launch_counts()["tile_windows"],
            trace.counters().get("slice.windows", 0)) == before
