"""The port's recorder (zang_tpu_torch/trace.py) on the CPU: spans off and
on, under torch.profiler, the counters and the launch counts read through
them, and the spans a render and a live block leave."""

import collections
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from zang_tpu_torch import trace
from zang_tpu_torch.graph.render import _leaves, _map_arrays, render_performance
from zang_tpu_torch.host import instruments as ti
from zang_tpu_torch.host.live import LiveSession
from zang_tpu_torch.host.song import build_performance
from zang_tpu_torch.ops.segprog import SegProgram
from zang_tpu_torch.parallel.mesh import launch_counts, reset_launch_counts
from zang_tpu_torch.serve.live import LiveFleet

torch.set_num_threads(1)  # xdist workers share the cores (see PERF.md §7)

KERNELS = {"svf_table", "svf_dense", "svf_onepass", "table_lookup", "sampler_play",
           "fm_feedback", "tile_windows"}


@pytest.fixture
def recorder():
    """An empty recorder, off again and emptied after the test."""
    trace.disable()
    trace.take()
    yield trace
    trace.disable()
    trace.take()


def _names(recs):
    return [r.name for r in recs]


def _arrays(tree) -> int:
    """The numpy arrays in a program tree."""
    found = []
    _map_arrays(tree, found.append)
    return len(found)


def test_off_keeps_nothing_and_opens_no_range(recorder, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with the recorder off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not trace.enabled()
    a, b = trace.span("chunk"), trace.span("block")
    assert a is b  # one shared no-op context: nothing allocated
    with a:
        with trace.span("chunk.upload"):
            pass
    assert trace.records() == [] and trace.take() == []


def test_on_nests_with_parent_and_root_ids(recorder):
    trace.enable()
    with trace.span("block"):
        with trace.span("block.windows"):
            pass
        with trace.span("block.pack"):
            pass
    with trace.span("chunk"):
        pass
    recs = trace.take()
    by = {r.name: r for r in recs}
    assert _names(recs) == ["block.windows", "block.pack", "block", "chunk"]
    blk = by["block"]
    assert blk.parent == 0 and blk.root == blk.id
    for child in ("block.windows", "block.pack"):
        assert by[child].parent == blk.id and by[child].root == blk.id
        assert blk.t0 <= by[child].t0 <= by[child].t1 <= blk.t1
    assert by["chunk"].parent == 0 and by["chunk"].root == by["chunk"].id != blk.id
    assert trace.records() == []


def test_threads_keep_stacks_of_their_own(recorder):
    trace.enable()
    inside, release = threading.Event(), threading.Event()

    def other():
        with trace.span("block"):
            inside.set()
            release.wait(10)
            with trace.span("block.launch"):
                pass

    t = threading.Thread(target=other)
    with trace.span("chunk"):
        t.start()
        assert inside.wait(10)
        with trace.span("chunk.parts"):
            release.set()
            t.join(10)
    assert not t.is_alive()
    by = {r.name: r for r in trace.take()}
    assert by["chunk.parts"].parent == by["chunk"].id
    assert by["block.launch"].parent == by["block"].id
    assert by["block"].parent == 0 and by["block.launch"].root == by["block"].id
    assert by["block"].thread != by["chunk"].thread
    assert by["block.launch"].thread == by["block"].thread


def test_self_time_is_the_duration_less_the_children():
    R = trace.Record
    recs = [R("chunk.upload", 2, 1, 1, 7, 110, 130), R("chunk.parts", 3, 1, 1, 7, 130, 180),
            R("chunk", 1, 0, 1, 7, 100, 200), R("plan.timelines", 5, 4, 4, 7, 300, 350),
            R("plan", 4, 0, 4, 7, 290, 400)]
    assert trace.self_ns(recs) == {1: 100 - 20 - 50, 2: 20, 3: 50, 4: 110 - 50, 5: 50}


def test_the_deque_keeps_the_newest_and_counts_the_dropped(recorder, monkeypatch):
    monkeypatch.setattr(trace, "CAPACITY", 3)
    monkeypatch.setattr(trace, "_records", collections.deque(maxlen=3))
    before = trace.dropped()
    trace.enable()
    for i in range(5):
        with trace.span(f"s{i}"):
            pass
    assert _names(trace.take()) == ["s2", "s3", "s4"]
    assert trace.dropped() - before == 2


def test_profiler_holds_the_spans_inside_the_enclosing_range(recorder):
    """Under torch.profiler (the recorder not enabled) a span is a "zt."
    range nested in the caller's range, and a record as well."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.enabled()
        with record_function("bench.window"):
            with trace.span("chunk"):
                with trace.span("chunk.upload"):
                    torch.ones(4).add_(1)
    assert not trace.enabled()
    ev = {e.name(): e for e in prof.profiler.kineto_results.events()}
    win, chunk, up = ev["bench.window"], ev["zt.chunk"], ev["zt.chunk.upload"]

    def inside(a, b):
        return b.start_ns() <= a.start_ns() and \
            a.start_ns() + a.duration_ns() <= b.start_ns() + b.duration_ns()

    assert inside(chunk, win) and inside(up, chunk)
    assert _names(trace.take()) == ["chunk.upload", "chunk"]
    with trace.span("chunk"):  # the profiler has stopped: off again
        pass
    assert trace.records() == []


def test_counters_and_the_launch_counts_read_through_them():
    trace.count("test.widgets")
    trace.count("test.widgets", 4)
    assert trace.counters()["test.widgets"] == 5
    trace.count("launch.svf_dense", 3)
    assert set(launch_counts()) == KERNELS
    before = trace.counters()
    reset_launch_counts()
    after = trace.counters()
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    assert after["test.widgets"] == 5  # only the launch counts go back to 0
    assert after.get("h2d.copies", 0) == before.get("h2d.copies", 0)
    trace.count("launch.fm_feedback")
    assert launch_counts()["fm_feedback"] == 1
    trace.reset_counters("test.")
    assert trace.counters()["test.widgets"] == 0


def test_counts_are_not_lost_across_threads():
    trace.reset_counters("test.")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: [trace.count("test.threads")
                                               for _ in range(2000)]) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert trace.counters()["test.threads"] == 8 * 2000


def test_a_render_spans_planning_and_every_chunk(recorder):
    chunk, n_chunks = 4096, 3
    total = chunk * n_chunks - 100  # a short last chunk
    trace.enable()
    before = trace.counters()
    perf = build_performance(total)
    render_performance(perf, total, chunk_size=chunk, device="cpu")
    after = trace.counters()
    recs = trace.take()
    names = _names(recs)
    assert names.count("plan") == 1 and names.count("slice") == 1
    assert names.count("plan.timelines") == 3  # one a part of the score
    assert names.count("plan.programs") == 1
    for name in ("chunk", "chunk.upload", "chunk.parts", "chunk.post"):
        assert names.count(name) == n_chunks, name
    by_id = {r.id: r for r in recs}
    plan = next(r for r in recs if r.name == "plan")
    for r in recs:
        if r.name.startswith("plan."):
            assert r.root == plan.id
        if r.name.startswith("chunk."):
            assert by_id[r.parent].name == "chunk"
    assert after.get("chunks", 0) - before.get("chunks", 0) == n_chunks
    # the static programs' arrays and the SegPrograms' tables (one packed
    # copy) once; each chunk's tiles are cut on the device, one cut a program
    static = _arrays(perf.programs)
    n_progs = len(_leaves(perf.programs, SegProgram))
    assert n_progs > 0 and _arrays(perf.chunk_xs(total, chunk)[0]) == 0
    assert after["h2d.copies"] - before.get("h2d.copies", 0) == static + 1
    assert after["slice.windows"] - before.get("slice.windows", 0) == n_chunks * n_progs


def test_a_live_block_spans_windows_pack_and_launch(recorder):
    make = lambda: [(ti.NiceInstrument(0.3), 3)]  # noqa: E731
    fleet = LiveFleet(make, 2, 48000.0, block_size=512, device="cpu")
    session = LiveSession(make(), 48000.0, 512, device="cpu")
    fleet.key_event(0, 0, "a", True)
    session.key_event(0, "a", True)
    trace.enable()
    before = trace.counters().get("h2d.copies", 0)
    out = fleet.render_block()
    session.render_block()
    recs = trace.take()
    assert out.shape[0] == 2
    blocks = [r for r in recs if r.name == "block"]
    assert len(blocks) == 2
    for blk in blocks:
        kids = sorted(r.name for r in recs if r.parent == blk.id)
        assert kids == ["block.launch", "block.pack", "block.windows"]
    assert trace.counters()["h2d.copies"] - before == 2  # one packed copy a block
    assert np.isfinite(out).all()
