"""The chunk step as a CUDA graph (zang_tpu_torch/graph/render.py
GraphStep, ChunkLayout, capturable), on the CPU; the card's cases are in
tests/test_torch_cuda_paths.py.

- The packed layout round-trips: the views unpacked from one buffer are
  the chunk's slices as the device holds them, host slices in the tiled
  and the flat chunk formats, with the chunk's first frame at byte 0; a
  tiled chunk of window plans packs its first frame alone.
- Only Performances whose every part and post chain declare `capturable`
  qualify; on the CPU even those keep the eager step and count no graph.
- A GraphStep called with programs takes the eager step.
- Each replay counts the launches its capture recorded, once; the capture
  itself counts none of them.
"""

import numpy as np
import pytest
import torch

from zang_tpu_torch import trace
from zang_tpu_torch.core.notes import SongEvent
from zang_tpu_torch.core.timeline import compile_timelines
from zang_tpu_torch.device import arrays_to_device
from zang_tpu_torch.graph import render as trender
from zang_tpu_torch.host import configs as tconfigs
from zang_tpu_torch.host import instruments as ti
from zang_tpu_torch.host import song as tsong
from zang_tpu_torch.ops.segprog import SegProgram, WindowPlan
from zang_tpu_torch.tree import tree_copy_, tree_leaves, tree_map

torch.set_num_threads(1)  # xdist workers share the cores (see PERF.md §7)

SONG_TOTAL = 2 * 48000 + 123


def _perf(name):
    """(Performance, total frames, chunk)."""
    if name == "song":
        return tsong.build_performance(SONG_TOTAL), SONG_TOTAL, 8192
    if name == "song_flat":
        return tsong.build_performance(SONG_TOTAL), SONG_TOTAL, 7000
    if name == "poly_echo_16":
        perf, total = tconfigs.build_poly_echo_performance(num_voices=16, seconds=1.0)
        return perf, total, 16384
    raise ValueError(name)


@pytest.mark.parametrize("name", ["song", "poly_echo_16", "song_flat"])
def test_packed_layout_round_trips(name):
    perf, total, chunk = _perf(name)
    xs, n_chunks = trender.host_slices(perf, total, chunk)  # arrays in both formats
    layout = None
    for i in (0, n_chunks - 1):
        xs_i = trender.chunk_slice(xs, i)
        leaves = tree_leaves(xs_i, trender.ARRAYS)
        if layout is None:
            layout = trender.ChunkLayout(xs_i)
            buf = torch.full((layout.nbytes,), 0xAB, dtype=torch.uint8)
            host = layout.host_views(buf)
        assert trender.ChunkLayout.key_of(leaves) == layout.key
        assert all(off % trender.ALIGN == 0 for off, _, _ in layout.places)
        assert layout.pack(host, i * chunk, leaves) == []
        c0, views = layout.views(buf)
        got = layout.tree(views)
        assert c0.dtype == torch.int32 and c0.tolist() == [i * chunk]
        want = arrays_to_device(xs_i, "cpu")
        assert (tree_map(lambda t: (), got, leaf=torch.Tensor)
                == tree_map(lambda t: (), want, leaf=torch.Tensor))
        pairs = list(zip(tree_leaves(got, trender.ARRAYS), tree_leaves(want, trender.ARRAYS)))
        assert len(pairs) == len(leaves) > 0
        for g, w in pairs:
            assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)
            assert g.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr()


def test_a_chunk_of_another_shape_takes_another_layout():
    perf, total, chunk = _perf("song")
    host = lambda *a: trender.host_slices(perf, *a)  # noqa: E731
    for cut in (perf.chunk_xs, host):  # window plans and host slices
        xs, _ = cut(total, chunk)
        other, _ = cut(total, chunk // 2)  # half the tiles a chunk
        key = trender.ChunkLayout(trender.chunk_slice(xs, 0)).key
        assert key == trender.ChunkLayout.key_of(tree_leaves(
            trender.chunk_slice(xs, 1), trender.CHUNK_LEAVES))
        assert trender.ChunkLayout.key_of(tree_leaves(
            trender.chunk_slice(other, 0), trender.CHUNK_LEAVES)) != key


def test_a_tiled_chunk_packs_its_first_frame_alone():
    """In the tiled format the chunk's slice is its window plans: the
    packed buffer holds the first frame and no array, and the plans stay in
    the layout's template."""
    perf, total, chunk = _perf("song")
    xs, _ = perf.chunk_xs(total, chunk)
    layout = trender.ChunkLayout(xs)
    assert layout.places == [] and layout.nbytes == trender.ALIGN
    plans = tree_leaves(layout.template, WindowPlan)
    assert len(plans) == len(tree_leaves(perf.programs, SegProgram)) > 0
    buf = torch.zeros((layout.nbytes,), dtype=torch.uint8)
    assert layout.pack(layout.host_views(buf), 3 * chunk,
                       tree_leaves(xs, trender.CHUNK_LEAVES)) == []
    c0, views = layout.views(buf)
    assert c0.tolist() == [3 * chunk] and views == []
    assert tree_leaves(layout.tree(views), WindowPlan) == plans


def _script_part():
    from zang_tpu_torch.script import torch_backend as tb

    return tb.ScriptInstrument.__new__(tb.ScriptInstrument)


def _echo_post(capturable):
    post_fn, post_init = tconfigs.poly_echo_post(4, 15000)
    if capturable:
        return post_fn, post_init
    return (lambda s, m, c: post_fn(s, m, c)), post_init


@pytest.mark.parametrize("parts,post,want", [
    (["pmosc", "nice"], None, True),
    (["nice"], True, True),
    (["nice", "nice"], None, True),
    (["nice"], False, False),
    (["nice", "script"], None, False),
    (["sampler"], None, False),
    (["filteredsaw"], None, False),
], ids=["song", "poly_echo", "two_nice", "undeclared_post", "script", "sampler",
        "filteredsaw"])
def test_only_declared_parts_qualify(parts, post, want):
    make = {"pmosc": lambda: ti.PMOscInstrument(0.4), "nice": lambda: ti.NiceInstrument(0.3),
            "script": _script_part, "sampler": lambda: tconfigs.SamplerInstrument(),
            "filteredsaw": lambda: ti.FilteredSawtoothInstrument()}
    kw = {}
    if post is not None:
        kw["post_fn"], kw["post_init_state"] = _echo_post(post)
    perf = trender.Performance([(make[p](), []) for p in parts], 48000.0,
                               programs=[{} for _ in parts], **kw)
    assert trender.capturable(perf) is want


@pytest.mark.parametrize("backend, want", [("nccl", True), ("gloo", False)])
def test_a_reduction_qualifies_only_when_declared(backend, want):
    """parallel/mesh.py's all-reduce: NCCL's is enqueued on the card and
    captured with the chunk; gloo's runs on the host, so its step stays
    eager."""
    from zang_tpu_torch.parallel import mesh

    post_fn, post_init = _echo_post(True)
    perf = trender.Performance([(ti.NiceInstrument(0.3), [])], 48000.0, programs=[{}],
                               post_fn=post_fn, post_init_state=post_init,
                               reduce=mesh.REDUCE[backend])
    assert trender.capturable(perf) is want


@pytest.mark.parametrize("name", ["song", "poly_echo_16"])
def test_on_the_cpu_a_declared_step_stays_eager(name):
    perf, total, chunk = _perf(name)
    assert trender.capturable(perf)
    step = trender.make_stream_step(perf, chunk, device="cpu")
    assert not isinstance(step, trender.GraphStep)
    before = trace.counters()
    out = trender.render_performance(perf, total, chunk, device="cpu")
    after = trace.counters()
    assert out.shape == (perf.num_channels, total)
    for k in ("graph.captures", "graph.replays"):
        assert after.get(k, 0) == before.get(k, 0)
    n_chunks = -(-total // chunk)
    assert after["chunks"] - before.get("chunks", 0) == n_chunks


def test_a_call_with_programs_takes_the_eager_step():
    perf, total, chunk = _perf("song")
    calls = []

    def eager(*args):
        calls.append(args)
        return "eager"

    step = trender.GraphStep(perf, chunk, torch.device("cpu"), [], None, eager)
    assert step(None, 0, {}, programs=["p"]) == "eager"
    assert calls == [(None, 0, {}, ["p"])]


class _Graph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.mark.parametrize("launches,replays", [({"launch.svf_table": 1}, 281),
                                              ({"launch.svf_onepass": 1}, 5),
                                              ({"launch.svf_dense": 2,
                                                "launch.svf_table": 3}, 4)])
def test_each_replay_counts_the_launches_its_capture_recorded(launches, replays):
    before = trace.counters()
    with trace.capture_counts() as recorded:
        for name, n in launches.items():
            for _ in range(n):
                trace.count(name)
    assert recorded == launches and trace.counters() == before
    step = trender.GraphStep(None, 8, torch.device("cpu"), [], None, None)
    step.graph, step.launches, step.returned = _Graph(), recorded, None
    step.state = ([{"l": torch.zeros(3), "b": torch.zeros(3)}, ()], {"buf": torch.ones(4)})
    step.out = torch.arange(8.0)[None]
    held = torch.full((3,), 2.0)
    state = ([{"l": held, "b": held}, ()], {"buf": torch.zeros(4)})
    outs = []
    for _ in range(replays):
        state, audio = step._replay(state)
        outs.append(audio)
    after = trace.counters()
    assert step.graph.replays == replays
    assert after["graph.replays"] - before.get("graph.replays", 0) == replays
    for name, n in launches.items():
        assert after[name] - before.get(name, 0) == n * replays
    # the held state was copied in; what a call returned is its own copy
    assert torch.equal(step.state[0][0]["l"], held)
    assert state[0][0]["l"] is not step.state[0][0]["l"] and torch.equal(state[0][0]["l"], held)
    outs[0].zero_()
    assert torch.equal(step.out, torch.arange(8.0)[None])


def test_a_state_of_another_structure_is_refused():
    with pytest.raises(ValueError, match="structure"):
        tree_copy_(([torch.zeros(1)], ()), ([torch.zeros(1), torch.zeros(1)], ()))


def test_events_of_a_song_make_a_capturable_part():
    song = [SongEvent({"freq": 440.0, "note_on": True}, t=0.0, note_id=1),
            SongEvent({"freq": 440.0, "note_on": False}, t=0.1, note_id=1)]
    tls = compile_timelines(song, 1, 48000.0, 9000)
    perf = trender.Performance([(ti.NiceInstrument(np.array([0.3], np.float32)), tls)],
                               48000.0)
    assert trender.capturable(perf)
    out = trender.render_performance(perf, 9000, 1024, device="cpu")
    assert float(out.abs().max()) > 1e-3


@pytest.mark.parametrize("fn", ["svf_filter_table_ref", "svf_onepass_table_ref"])
def test_the_plain_table_filters_take_t0_as_a_tensor(fn):
    """A graphed step passes the chunk's first frame as an int32 [1] tensor;
    the plain versions (which a render may be patched to use) read it as
    they read an int, bit for bit."""
    from zang_tpu_torch.ops import filters

    rng = np.random.default_rng(5)
    V, nt, T, S, t0 = 3, 4, 16, 2, 5 * 64
    tb = np.full((V, nt, S), -(2 ** 31), np.int32)
    tb[:, :, 1] = t0 + np.arange(nt)[None, :] * T + rng.integers(0, T, (V, nt))
    args = [torch.zeros(V), torch.zeros(V), torch.from_numpy(
        rng.standard_normal((V, nt * T)).astype(np.float32)), "low_pass",
        torch.from_numpy(tb), torch.from_numpy(rng.uniform(0.1, 0.9, (V, nt, S))
                                               .astype(np.float32)), 0.3]
    af = torch.tensor([t0, t0 + 7, t0 + 40], dtype=torch.int32)
    want = getattr(filters, fn)(*args, t0, af)
    got = getattr(filters, fn)(*args, torch.tensor([t0], dtype=torch.int32), af)
    assert torch.equal(filters.chunk_frames(torch.tensor([t0], dtype=torch.int32), 5, "cpu"),
                       filters.chunk_frames(t0, 5, "cpu"))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
