"""The harness on the CPU: files found by name, a cell added as files only,
the end-to-end statistics, the trace's reduction and the SVF's bytes.

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from benchmark import harness, run, tracing, yardstick
from benchmark.drivers import live, offline

MAN = harness.manifest()


@pytest.mark.parametrize("name", [w["name"] for w in MAN["workloads"]])
def test_every_cell_finds_its_files_by_name(name):
    p = harness.cell_parts(MAN, name)
    for fn in ("setup",):
        assert callable(getattr(p["entry"], fn))
    assert callable(p["driver"].run)
    assert {"rms_dbfs", "peak_dbfs"} <= set(p["limits"])
    names = {m["name"] for m in p["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert p["per_layer"]
    for m in p["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)


def test_manifest_keeps_the_contract():
    assert MAN["paths"] == ["benchmark"] and 1 <= MAN["run_seconds"] <= 51
    for c in MAN["configs"]:
        cfg = json.load(open(os.path.join(harness.ROOT, c["file"])))
        assert c["file"].startswith("benchmark/") and cfg["reduced"] == c["reduced"]
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        for w in m.get("workloads", []):
            harness.workload(MAN, w)
    for m in MAN["per_layer"]:
        moved = next(e for e in MAN["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", m["workloads"]))


def test_a_new_cell_is_files_and_entries_only(tmp_path):
    """A copy of the benchmark gains a traffic mix, a cell, its limits and a
    per-layer metric by new files and new manifest entries; no file that
    was there changes, and a tiny run of the new cell prints the metric."""
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".build"))
    os.makedirs(tmp_path / "zang_tpu" / "data")
    shutil.copy(os.path.join(harness.ROOT, "zang_tpu", "data", "bach_toccata.npz"),
                tmp_path / "zang_tpu" / "data")
    before = {p: open(p, "rb").read() for p in map(str, (tmp_path / "benchmark").rglob("*"))
              if os.path.isfile(p)}
    man = json.loads(json.dumps(MAN))
    man["workloads"].append({"name": "toccata.up_a_fifth", "config": "toccata",
                             "traffic": "up_a_fifth", "chips": 1, "why": "a test cell"})
    man["end_to_end"][0]["workloads"].append("toccata.up_a_fifth")
    man["per_layer"].append({"name": "jobs_in_window", "unit": "jobs", "better": "higher",
                             "source": "host_clock", "layer": "planning",
                             "moves": "render_rtf", "workloads": ["toccata.up_a_fifth"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    tr = harness.load_json("traffic", "offline")
    tr.update(transpose=[7, 7], chunk=16384, trace_jobs=1)
    (tmp_path / "benchmark" / "traffic" / "up_a_fifth.json").write_text(json.dumps(tr))
    shutil.copy(tmp_path / "benchmark" / "limits" / "toccata.offline.json",
                tmp_path / "benchmark" / "limits" / "toccata.up_a_fifth.json")
    (tmp_path / "benchmark" / "metrics" / "jobs_in_window.py").write_text(
        "def read(res):\n    return float(res['counts']['jobs'])\n")
    code = ("import json, torch; torch.set_num_threads(1); from benchmark import harness, run; "
            "p = harness.cell_parts(harness.manifest(), 'toccata.up_a_fifth'); "
            "p['config'] = dict(p['config'], seconds=1); "
            "res = run.run_cell('toccata.up_a_fifth', 5, 0.3, True, 'cpu', p); "
            "print(run.result(res, True, 1, {'platform': 'cpu', 'kind': 'cpu', 'count': 1})[1])")
    env = dict(os.environ, PYTHONPATH=harness.ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["metrics"]["jobs_in_window"]["value"] >= 1
    assert "plan_s_per_job" not in line["metrics"]  # not listed for the new cell
    for p, data in before.items():
        assert open(p, "rb").read() == data, p


# ---------------------------------------------------------------------------
# the end-to-end statistics


class _FakeOfflineEntry:
    """Jobs that take `job_s` of wall each and carry 2 s of audio."""

    def __init__(self, job_s):
        self.job_s = job_s

    def setup(self, cfg, tr):
        return {}

    def draw_job(self, ctx, rng):
        return {"n": int(rng.integers(0, 100))}

    def run_job(self, ctx, job, spans, device):
        with spans("plan"):
            time.sleep(self.job_s)
        return {"out": np.zeros(4, np.int16), "audio_s": 2.0, "chunks": 1}

    def reference(self, ctx, job, precision="f32"):
        return np.zeros(4, np.int16), np.s_[:]


def _offline_parts(entry):
    return {"entry": entry, "config": {}, "limits": {"rms_dbfs": -100.0, "peak_dbfs": -80.0},
            "traffic": {"warm_jobs": 1, "trace_jobs": 0, "svf_entry": "svf_filter_table"}}


def test_render_rtf_window_ends_on_the_job_that_crosses_the_seconds():
    t_start = time.perf_counter()
    res = offline.run(_offline_parts(_FakeOfflineEntry(0.12)), 1, 0.5, False, "cpu", t_start)
    # jobs end near 0.12, 0.24, 0.36, 0.48, 0.60 s: the fifth crosses 0.5 s
    assert res["attempted"] == 5 and res["failed"] == 0
    wall = res["spans"].records[-1][2] - (res["spans"].records[0][1])
    assert 0.58 < wall < 0.9
    assert res["end_to_end"]["render_rtf"] == pytest.approx(5 * 2.0 / wall, rel=0.05)
    assert all(c["ok"] for c in res["check"]())


def test_closed_loop_rate_counts_every_job_whole():
    assert harness.closed_loop_rate([10.5, 11.0, 12.5], [2.0, 2.0, 2.0], 10.0) == 6.0 / 2.5


class _FakeFleet:
    def __init__(self, stall_at, stall_s, block_s):
        self.k, self.stall_at, self.stall_s, self.block_s = 0, stall_at, stall_s, block_s

    def push_event(self, *a, **kw):
        pass

    def render_block_async(self):
        import torch

        time.sleep(self.stall_s if self.k == self.stall_at else self.block_s)
        self.k += 1
        return torch.zeros((2, 1, 8))


class _FakeLiveEntry:
    def __init__(self, fleet):
        self.fleet = fleet

    def setup(self, cfg, tr):
        return {}

    def lane_events(self, ctx, rng, lanes, frames):
        return [[] for _ in range(lanes)]

    def make_fleet(self, ctx, lanes, device):
        return self.fleet

    def lane_reference(self, ctx, events, frames, precision="f32"):
        return np.zeros(frames, np.float32)


def test_block_p95_counts_a_stall_against_every_block_it_delays():
    """Blocks due every 20 ms take 2 ms; block 10 stalls 200 ms, so the
    blocks due during the stall each come late by what is left of it (about
    18 ms less a block: ten of them, give or take the sleeps' jitter)."""
    block, sr = 960, 48000.0  # 20 ms a block
    parts = {"entry": _FakeLiveEntry(_FakeFleet(10, 0.2, 0.002)),
             "config": {"live_sample_rate": sr},
             "limits": {"rms_dbfs": -100.0, "peak_dbfs": -80.0},
             "traffic": {"lanes": 2, "block": block, "trace_blocks": 0, "check_lanes": 1,
                         "svf_entry": "svf_filter"}}
    res = live.run(parts, 3, 1.0, False, "cpu", time.perf_counter())
    lat = res["latency_ms"]
    assert len(lat) == 50 and res["attempted"] == 50
    # block 10 of the window is the fleet's 11th (block 0 warms): due at 180 ms
    assert lat[9] > 195
    late = [x for x in lat[10:] if x > 10]
    assert 8 <= len(late) <= 12 and late == sorted(late, reverse=True)
    assert res["end_to_end"]["block_p95_ms"] == pytest.approx(np.percentile(lat, 95))
    assert res["end_to_end"]["block_p95_ms"] > 60
    assert all(c["ok"] for c in res["check"]())


def test_a_block_that_never_comes_is_infinitely_late():
    lat = harness.open_loop_latencies([0.0, 1.0, 2.0], [0.1, None, 2.05])
    assert lat[1] == math.inf
    assert harness.percentile(lat, 95) == math.inf
    assert harness.percentile([1.0, 2.0, 3.0, 4.0, 5.0], 50) == 3.0
    assert harness.percentile(list(range(101)), 95) == pytest.approx(95.0)


# ---------------------------------------------------------------------------
# the trace's reduction


def _ev(name, start, end, device=False, corr=0, thread=1, annotation=False):
    return {"name": name, "device": device, "start": start, "end": end,
            "corr": (corr, 0) if device else corr, "thread": thread,
            "annotation": annotation}


def test_idle_share_from_overlapping_intervals():
    ms = 1_000_000
    events = [
        _ev("bench.window", 0, 100 * ms, annotation=True),
        _ev("bench.svf:3350000000", 10 * ms, 12 * ms, annotation=True),
        _ev("bench.plan", 40 * ms, 90 * ms, annotation=True),
        _ev("cudaLaunchKernel", 11 * ms, 11 * ms + 5000, corr=7),
        _ev("cudaLaunchKernel", 20 * ms, 20 * ms + 5000, corr=8),
        _ev("svf_kernel", 12 * ms, 22 * ms, device=True, corr=7),
        _ev("other_kernel", 15 * ms, 30 * ms, device=True, corr=8),  # overlaps the first
        _ev("Memcpy DtoH", 95 * ms, 105 * ms, device=True, corr=99),  # past the window
        _ev("bench.svf", 50 * ms, 51 * ms, device=True, annotation=True),  # a device range
    ]
    r = tracing.reduce_events(events)
    assert r["window_s"] == pytest.approx(0.1)
    assert r["busy_s"] == pytest.approx(0.018 + 0.005)  # [12, 30] and [95, 100] ms
    assert tracing.idle_pct(r) == pytest.approx(77.0)
    assert r["device_ops"] == 3
    svf = [c for c in r["calls"] if c["name"].startswith("bench.svf:")]
    assert svf[0]["device_s"] == pytest.approx(0.010)  # only the kernel it launched
    # 3.35e9 bytes take 1 ms at the peak rate: 1 ms over 10 ms of device
    assert tracing.roofline_pct(r) == pytest.approx(10.0)
    gaps = dict(r["breakdown"]["idle_gaps"])
    assert gaps["host: plan"] == pytest.approx(0.065)  # [30, 95] ms, inside plan at 62.5
    assert gaps["host: outside any span"] == pytest.approx(0.012)  # [0, 12] ms
    assert r["breakdown"]["device_ops"][0][0] == "other_kernel"


def test_roofline_reads_nothing_without_a_traced_call():
    r = tracing.reduce_events([_ev("bench.window", 0, 10, annotation=True)])
    assert tracing.roofline_pct(r) is None and tracing.idle_pct(r) == 100.0


# ---------------------------------------------------------------------------
# the SVF's bytes


@pytest.mark.parametrize("V, bound_us", [(14, 2.20), (4096, 643.6), (16384, 2574.0)])
def test_svf_bytes_match_the_kernel_tables_bound(V, bound_us):
    """PERF.md's kernel table: the song's K1 (14 organ voices), K3 at 4096
    and 16384 voices, each x [V, 65536] with tables of 128 tiles x 2 slots."""
    b = yardstick.svf_table_bytes(V, 65536, 128, 2, True)
    assert yardstick.bound_s(b) * 1e6 == pytest.approx(bound_us, rel=5e-4)


def test_svf_bytes_from_the_entries_arguments():
    import torch

    x = torch.zeros(8, 1024)
    tb = torch.zeros(8, 2, 3, dtype=torch.int32)
    af = torch.zeros(8, dtype=torch.int32)
    assert yardstick.svf_call_bytes("svf_filter_table", (x, x, x, "low_pass", tb, tb, 0.7, 0),
                                    {"active_from": af}) == \
        yardstick.svf_table_bytes(8, 1024, 2, 3, True)
    mask = torch.ones(8, 1024, dtype=torch.bool)
    assert yardstick.svf_call_bytes("svf_filter", (x, x, x, "low_pass", x, 0.7, mask), {}) == \
        4 * 2 * 8 * 1024 + 4 * 8 * 1024 + 8 * 1024 + 16 * 8
    # the live K2 shape of PERF.md's table: 1,024 x 4,096 -> 16.28 us
    assert yardstick.bound_s(yardstick.svf_dense_bytes(1024, 4096, True, True)) * 1e6 == \
        pytest.approx(16.28, rel=5e-4)


def test_enqueue_spans_are_the_windows_blocks_only():
    """The warm block (set-up's) is no block of enqueue_ms_per_block."""
    block, sr = 960, 48000.0
    fleet = _FakeFleet(0, 0.3, 0.002)  # the warm block takes 0.3 s
    parts = {"entry": _FakeLiveEntry(fleet), "config": {"live_sample_rate": sr},
             "limits": {"rms_dbfs": -100.0, "peak_dbfs": -80.0},
             "traffic": {"lanes": 2, "block": block, "trace_blocks": 0, "check_lanes": 1,
                         "svf_entry": "svf_filter"}}
    res = live.run(parts, 3, 0.2, False, "cpu", time.perf_counter())
    enq = res["spans"].seconds("enqueue")
    assert len(enq) == res["attempted"] == 10 and max(enq) < 0.1


def _live_parts(fleet, trace_blocks):
    return {"entry": _FakeLiveEntry(fleet), "config": {"live_sample_rate": 48000.0},
            "limits": {"rms_dbfs": -100.0, "peak_dbfs": -80.0},
            "traffic": {"lanes": 2, "block": 960, "trace_blocks": trace_blocks,
                        "check_lanes": 1, "svf_entry": "svf_filter"}}


def test_setup_is_taken_apart():
    """setup_s is the sum of its parts; the warm block's time is the
    warm-up's, and a run that built nothing is not cold."""
    fleet = _FakeFleet(0, 0.3, 0.002)  # the warm block takes 0.3 s
    res = live.run(_live_parts(fleet, 0), 3, 0.2, False, "cpu", time.perf_counter())
    s = res["setup"]
    assert s["import_s"] + s["inputs_s"] + s["warm_s"] == pytest.approx(res["setup_s"])
    assert 0.3 <= s["warm_spans_s"]["enqueue"] <= s["warm_s"]
    assert s["build_s"] == 0.0 and s["cold"] is False
    res["checks"] = res.pop("check")()
    res["parts"] = dict(_live_parts(fleet, 0), end_to_end=[
        {"name": "block_p95_ms", "unit": "ms"}, {"name": "setup_s", "unit": "s"}])
    line = json.loads(run.result(res, False, 1, {"platform": "cpu", "kind": "cpu",
                                                  "count": 1})[1])
    assert list(line)[-2:] == ["setup", "checks"] and line["setup"]["cold"] is False


def test_traced_blocks_keep_their_due_times():
    """The traced stretch comes after the window, paced: its blocks start
    on time, so the trace spans their due times, not a backlog."""
    fleet = _FakeFleet(-1, 0.0, 0.002)  # 2 ms a block, 20 ms a budget
    res = live.run(_live_parts(fleet, 6), 3, 0.2, True, "cpu", time.perf_counter())
    lag = res["trace_lag_ms"]
    assert lag["max"] < lag["limit"] == pytest.approx(20.0) and lag["late_blocks"] == 0
    assert res["counts"]["blocks_traced"] == 6 and res["attempted"] == 10 + 1 + 6
    assert res["reading"]["window_s"] >= 5 * 0.02  # six blocks paced, not back to back
    assert len(res["latency_ms"]) == 10  # block_p95_ms is the window's alone
    assert all(c["ok"] for c in res["check"]())


def test_one_stall_in_the_traced_stretch_is_reported_not_refused():
    """A stall that the stretch recovers from leaves its median on time."""
    fleet = _FakeFleet(13, 0.1, 0.002)  # the 3rd traced block stalls 100 ms
    res = live.run(_live_parts(fleet, 8), 3, 0.2, True, "cpu", time.perf_counter())
    lag = res["trace_lag_ms"]
    assert lag["max"] > 60 and 1 <= lag["late_blocks"] <= 4
    assert lag["median"] < lag["limit"]


def test_traced_blocks_that_fall_behind_refuse_the_reading():
    fleet = _FakeFleet(-1, 0.0, 0.03)  # 30 ms a block, over its 20 ms budget
    with pytest.raises(RuntimeError, match="fell behind"):
        live.run(_live_parts(fleet, 6), 3, 0.1, True, "cpu", time.perf_counter())
