"""The readers of the port's own spans and counters (benchmark/
program_spans.py and the nine metrics that use it) on the CPU: synthetic
records, the tiny cells traced, a program without the recorder, and the
device side's idle gaps put down to the port's ranges.

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

import json
import sys
import types

import pytest
import torch

from benchmark import harness, program_spans, tracing
from benchmark.tests.tiny import run_tiny

MAN = harness.manifest()
NEW = ["plan_timelines_s_per_job", "plan_programs_s_per_job", "upload_ms_per_chunk",
       "parts_ms_per_chunk", "post_ms_per_chunk", "uploads_per_chunk",
       "windows_ms_per_block", "pack_ms_per_block", "launch_ms_per_block"]
READ = {m: harness.load_module("metrics", m).read for m in NEW}
MS = 1_000_000


class _Rec(types.SimpleNamespace):
    pass


def _port(records, counters=None):
    """A stand-in of the port's recorder module."""
    return types.SimpleNamespace(records=lambda: list(records),
                                 counters=lambda: dict(counters or {}))


def _res(rows):
    spans = harness.Spans()
    spans.records = list(rows)
    return {"spans": spans}


def _rec(name, t0_ms, t1_ms, rid=0, parent=0):
    return _Rec(name=name, id=rid, parent=parent, root=0, thread=1, t0=t0_ms * MS,
                t1=t1_ms * MS)


def _job(t0_ms, chunks, upload, parts, post, timelines=0.0, programs=0.0):
    """The port records of one job at t0: planning, then `chunks` chunks
    of (upload, parts, post) ms each."""
    out = [_rec("plan.timelines", t0_ms + 1, t0_ms + 1 + timelines),
           _rec("plan.programs", t0_ms + 2 + timelines, t0_ms + 2 + timelines + programs)]
    t = t0_ms + 10 + timelines + programs
    for _ in range(chunks):
        out.append(_rec("chunk", t, t + upload + parts + post))
        out.append(_rec("chunk.upload", t, t + upload))
        out.append(_rec("chunk.parts", t + upload, t + upload + parts))
        out.append(_rec("chunk.post", t + upload + parts, t + upload + parts + post))
        t += upload + parts + post
    return out


def _row(name, t0_ms, t1_ms, profiled):
    return (name, t0_ms * 1e-3, t1_ms * 1e-3, profiled)


def test_offline_readers_prefer_the_unprofiled_jobs(monkeypatch):
    recs = (_job(0, 2, 2, 3, 4, timelines=5, programs=6)           # profiled
            + _job(1000, 4, 1, 2, 1, timelines=2, programs=1)      # unprofiled
            + _job(2000, 4, 1, 4, 1, timelines=4, programs=3)      # unprofiled
            + [_rec("chunk.upload", 5000, 5100)])                  # in no job
    monkeypatch.setitem(sys.modules, program_spans.PORT_TRACE,
                        _port(recs, {"h2d.copies": 26, "chunks": 10}))
    res = _res([_row("job", 0, 900, True), _row("plan", 0, 8, True),
                _row("job", 1000, 1900, False), _row("job", 2000, 2900, False),
                _row("job", 3000, 3100, False)])  # a job that holds no port record
    assert READ["plan_timelines_s_per_job"](res) == pytest.approx(0.003)
    assert READ["plan_programs_s_per_job"](res) == pytest.approx(0.002)
    assert READ["upload_ms_per_chunk"](res) == pytest.approx(1.0)
    assert READ["parts_ms_per_chunk"](res) == pytest.approx(3.0)
    assert READ["post_ms_per_chunk"](res) == pytest.approx(1.0)
    assert READ["uploads_per_chunk"](res) == pytest.approx(2.6)
    assert READ["windows_ms_per_block"](res) is None  # no enqueue rows


def test_offline_readers_take_the_profiled_jobs_when_there_are_no_others(monkeypatch):
    monkeypatch.setitem(sys.modules, program_spans.PORT_TRACE,
                        _port(_job(0, 2, 2, 3, 4, timelines=5, programs=6)))
    res = _res([_row("job", 0, 900, True), _row("job", 1000, 1900, False)])
    assert READ["plan_timelines_s_per_job"](res) == pytest.approx(0.005)
    assert READ["upload_ms_per_chunk"](res) == pytest.approx(2.0)
    assert READ["post_ms_per_chunk"](res) == pytest.approx(4.0)


def _block(t0_ms, windows, pack, launch):
    return [_rec("block", t0_ms, t0_ms + windows + pack + launch + 1),
            _rec("block.windows", t0_ms, t0_ms + windows),
            _rec("block.pack", t0_ms + windows, t0_ms + windows + pack),
            _rec("block.launch", t0_ms + windows + pack, t0_ms + windows + pack + launch)]


def test_live_readers_prefer_the_unprofiled_blocks(monkeypatch):
    recs = _block(0, 9, 9, 9) + _block(100, 3, 1, 2) + _block(200, 5, 3, 4)
    monkeypatch.setitem(sys.modules, program_spans.PORT_TRACE, _port(recs))
    res = _res([_row("enqueue", 0, 50, True), _row("enqueue", 100, 150, False),
                _row("enqueue", 200, 250, False)])
    assert READ["windows_ms_per_block"](res) == pytest.approx(4.0)
    assert READ["pack_ms_per_block"](res) == pytest.approx(2.0)
    assert READ["launch_ms_per_block"](res) == pytest.approx(3.0)
    assert READ["upload_ms_per_chunk"](res) is None  # no job rows
    only_profiled = _res([_row("enqueue", 0, 50, True)])
    assert READ["windows_ms_per_block"](only_profiled) == pytest.approx(9.0)


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    """The parent commit's port has no zang_tpu_torch.trace: every new
    reader returns None and none raises."""
    monkeypatch.setitem(sys.modules, program_spans.PORT_TRACE, None)
    res = _res([_row("job", 0, 900, False), _row("enqueue", 0, 50, False)])
    assert all(READ[m](res) is None for m in NEW)


@pytest.mark.parametrize("name", [w["name"] for w in MAN["workloads"]])
def test_each_tiny_cell_traced_reads_its_new_metrics(name):
    """The driver as it is (the profiler over the first jobs or a stretch
    of blocks, nothing of the port's recorder called): the port records
    its spans while the profiler runs, and every new metric of the cell
    has a value in the result line."""
    from zang_tpu_torch import trace

    trace.reset_counters()  # the counters are the process's: this run's alone
    trace.take()
    correct, line, _ = run_tiny(name, trace=True)
    out = json.loads(line)
    want = [m["name"] for m in MAN["per_layer"]
            if m["name"] in NEW and name in m["workloads"]]
    assert want and correct, line
    for m in want:
        v = out["metrics"][m]["value"]
        assert v > 0 and v == v, (m, v)
    assert not trace.enabled()
    trace.take()


def _ev(name, start, end, device=False, corr=0, thread=1, annotation=False):
    return {"name": name, "device": device, "start": start, "end": end,
            "corr": (corr, 0) if device else corr, "thread": thread,
            "annotation": annotation}


def _events():
    """A traced job: the harness's ranges, the port's inside them, and
    device ops with the gaps between them."""
    return [
        _ev("bench.window", 0, 100 * MS, annotation=True),
        _ev("bench.job", 0, 100 * MS, annotation=True),
        _ev("bench.plan", 0, 40 * MS, annotation=True),
        _ev("zt.plan", 1 * MS, 39 * MS, annotation=True),
        _ev("zt.plan.timelines", 5 * MS, 25 * MS, annotation=True),
        _ev("bench.render", 40 * MS, 90 * MS, annotation=True),
        _ev("zt.chunk", 41 * MS, 89 * MS, annotation=True),
        _ev("zt.chunk.upload", 42 * MS, 50 * MS, annotation=True),
        _ev("zt.chunk.parts", 50 * MS, 80 * MS, annotation=True),
        _ev("bench.svf:3350000000", 60 * MS, 70 * MS, annotation=True),
        _ev("zt.chunk.post", 80 * MS, 88 * MS, annotation=True),
        _ev("zt.block", 10 * MS, 20 * MS, thread=2, annotation=True),  # another thread
        _ev("cudaLaunchKernel", 65 * MS, 65 * MS + 5000, corr=7),
        _ev("svf_kernel", 66 * MS, 76 * MS, device=True, corr=7),
        _ev("Memcpy HtoD", 45 * MS, 46 * MS, device=True, corr=8),
    ]


def test_port_ranges_leave_every_reading_of_reduce_events_unchanged():
    with_port = _events()
    without = [e for e in with_port if not e["name"].startswith("zt.")]
    a, b = tracing.reduce_events(with_port), tracing.reduce_events(without)
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def test_recorded_port_ranges_leave_reduce_events_unchanged(monkeypatch):
    """A real CPU profile of a small render, with its zt. ranges and without."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from zang_tpu_torch.graph.render import render_performance
    from zang_tpu_torch.host.song import build_performance

    torch.set_num_threads(1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.window"):
            with record_function("bench.plan"):
                perf = build_performance(2048)
            with record_function("bench.render"):
                render_performance(perf, 2048, chunk_size=1024, device="cpu")
    events = tracing.plain_events(prof)
    port = [e for e in events if e["name"].startswith("zt.")]
    assert {e["name"] for e in port} >= {"zt.plan", "zt.chunk", "zt.chunk.upload",
                                          "zt.chunk.parts", "zt.chunk.post", "zt.slice"}
    without = [e for e in events if not e["name"].startswith("zt.")]
    a, b = tracing.reduce_events(events), tracing.reduce_events(without)
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    gaps = dict(program_spans.idle_gaps_program(events))
    assert sum(gaps.values()) == pytest.approx(a["window_s"] - a["busy_s"])
    assert gaps["zt.chunk.parts"] > 0 and gaps["zt.plan.programs"] > 0


def test_idle_gaps_go_to_the_innermost_port_range():
    gaps = dict(program_spans.idle_gaps_program(_events()))
    # device busy [45, 46] and [66, 76] ms; the rest of [0, 100] is idle
    want = {"host: plan": 0.002,          # [0, 1] and [39, 40]
            "zt.plan": 0.018,             # [1, 5] and [25, 39]
            "zt.plan.timelines": 0.020,   # [5, 25] (the other thread's block is not it)
            "host: render": 0.002,        # [40, 41] and [89, 90]
            "zt.chunk": 0.002,            # [41, 42] and [88, 89]
            "zt.chunk.upload": 0.007,     # [42, 45] and [46, 50]
            "zt.chunk.parts": 0.020,      # [50, 66] and [76, 80], the harness's svf inside
            "zt.chunk.post": 0.008,       # [80, 88]
            "host: job": 0.010}           # [90, 100]
    assert set(gaps) == set(want)
    for k, v in want.items():
        assert gaps[k] == pytest.approx(v), k
    idle = tracing.reduce_events(_events())
    assert sum(gaps.values()) == pytest.approx(idle["window_s"] - idle["busy_s"])
    assert program_spans.idle_gaps_program([_ev("x", 0, 1)]) == []


def test_the_host_spans_idle_held_by_port_spans():
    from benchmark.program_trace import port_share

    got = port_share(_events())
    # idle inside plan [0, 40] and render [40, 90] (busy [45, 46], [66, 76]):
    # 40 + 39 ms; port spans hold all of it but [0, 1], [39, 41] and [89, 90]
    assert got["idle_s"] == pytest.approx(0.079)
    assert got["held_by_port_span"] == pytest.approx(75 / 79)


def test_span_table_counts_and_self_times():
    from zang_tpu_torch import trace

    from benchmark.program_trace import span_table

    R = trace.Record
    recs = [R("chunk", 1, 0, 1, 7, 0, 10 * MS), R("chunk.upload", 2, 1, 1, 7, 0, 2 * MS),
            R("chunk.parts", 3, 1, 1, 7, 2 * MS, 9 * MS), R("chunk", 4, 0, 4, 7, 10 * MS, 20 * MS),
            R("chunk.parts", 5, 4, 4, 7, 10 * MS, 20 * MS)]
    table, covered = span_table(recs)
    assert table["chunk"] == [2, pytest.approx(0.020), pytest.approx(0.001)]
    assert table["chunk.parts"][0] == 2 and table["chunk.upload"][2] == pytest.approx(0.002)
    assert covered == {"chunk": pytest.approx(0.95)}
