"""The port's bench (zang_tpu_torch/bench.py) against the repo root's
bench.py, on the CPU at tiny sizes.

- The command with --device cpu prints bench.py's six metrics, `torch_` in
  front, in bench.py's order with the headline last, bench.py's units (the
  fidelity's is the whole render against the port's oracle, as bench.py's)
  and vs_baseline formulas, and loads no module of jax, jaxlib or zang_tpu
  (~12 s alone).
- Without CUDA and without --device cpu it exits non-zero and prints no
  metric (~3 s).
- The timed path (bench.prepare's run) is render_performance's bits, uploads
  nothing once prepared, and is held to the JAX package's make_render_fn
  run jitted on the CPU with the bounds of the port's song, sampler and
  poly_echo tests: the song within -90 dBFS (tests/test_torch_song.py, the
  parity budget; measured -141.7 there) and 1 LSB at s16; the sampler
  chain within -110 dBFS (tests/test_torch_sampler.py,
  tests/test_configs.py:52); poly_echo within -110 dBFS on both channels
  (tests/test_torch_echo.py) (alone: song ~10 s, sampler ~3 s, poly_echo
  ~13 s, most of it JAX's compiles).
- The fleet pushes bench.py's events for default_rng(0), call for call
  (~0.1 s).
"""

import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax

from zang_tpu.graph import render as jrender
from zang_tpu.host import configs as jconfigs
from zang_tpu.host import song as jsong
from zang_tpu_torch import bench
from zang_tpu_torch.core.mixdown import mixdown_s16_np
from zang_tpu_torch.graph import render as trender
from zang_tpu_torch.graph.fidelity import deviation_dbfs
from zang_tpu_torch.host import configs as tconfigs
from zang_tpu_torch.host import song as tsong

torch.set_num_threads(1)  # xdist workers share the cores (see PERF.md §7)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(ZANG_BENCH_SECONDS="2", ZANG_BENCH_SAMPLER_SECONDS="1",
            ZANG_BENCH_POLY_VOICES="8", ZANG_BENCH_POLY_SECONDS="1",
            ZANG_BENCH_SERVE_SONGS="2", ZANG_BENCH_SERVE_SECONDS="1",
            ZANG_BENCH_SERVE_PASSES="1", ZANG_BENCH_FLEET_LANES="2",
            ZANG_BENCH_IDLE_WAIT="0")
# bench.py's metrics in its print order, their units, and vs_baseline from
# the value as bench.py computes it (from the unrounded value: the slack is
# the value's rounding)
METRICS = [
    ("torch_sampler_chain_rtf_44k", "x_realtime", lambda v: v / 1000.0, 0.0005 + 0.05 / 1000),
    ("torch_poly_echo_voices_per_chip", "voices_at_rtf1", lambda v: round(v / 1024.0, 2), 0.0),
    ("torch_batch_serve_rtf_aggregate", "x_realtime_wav_delivery", lambda v: v, 0.0),
    ("torch_live_fleet_sessions_per_chip", "realtime_sessions", lambda v: v, 0.0),
    ("torch_bach_render_fidelity_rms_dbfs", "dbfs_rms_vs_oracle", lambda v: v / -90.0,
     0.0005 + 0.05 / 90),
    ("torch_bach_toccata_render_rtf_48k", "x_realtime", lambda v: v / 1000.0,
     0.0005 + 0.05 / 1000),
]
# `python -m zang_tpu_torch.bench ARGS` (runpy is what -m runs), then the
# modules of jax or zang_tpu it loaded, on stderr
RUN_BENCH = (
    "import runpy, sys\n"
    "sys.argv = ['zang_tpu_torch.bench'] + sys.argv[1:]\n"
    "rc = 0\n"
    "try:\n"
    "    runpy.run_module('zang_tpu_torch.bench', run_name='__main__', alter_sys=True)\n"
    "except SystemExit as e:\n"
    "    rc = e.code\n"
    "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'zang_tpu'))\n"
    "print('MODULES ' + repr(bad), file=sys.stderr)\n"
    "sys.exit(rc)\n")


def _run_bench(*args, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", ZANG_PLATFORM="cpu",
               **(env_extra or {}))
    return subprocess.run([sys.executable, "-c", RUN_BENCH, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)


def _metric_lines(stdout):
    return [json.loads(ln) for ln in stdout.splitlines() if ln.startswith("{")]


def test_bench_cpu_prints_the_six_metrics():
    proc = _run_bench("--device", "cpu", env_extra=TINY)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "MODULES []" in proc.stderr, proc.stderr[-500:]
    lines = _metric_lines(proc.stdout)
    assert [ln["metric"] for ln in lines] == [m for m, *_ in METRICS]
    assert proc.stdout.strip().splitlines()[-1] == json.dumps(lines[-1])  # headline last
    for line, (name, unit, formula, slack) in zip(lines, METRICS):
        assert list(line) == ["metric", "value", "unit", "vs_baseline"], line
        assert line["unit"] == unit, line
        assert np.isfinite(line["value"]) and line["value"] > -1e9, line
        assert abs(line["vs_baseline"] - formula(line["value"])) <= slack + 1e-12, line
    fidelity = lines[4]["value"]
    assert fidelity < -90.0, fidelity  # the parity budget
    stderr = proc.stderr
    assert stderr.startswith("# card cpu (no card)"), stderr[:200]
    for label in ("bench_song end to end", "bench_poly end to end", "bench_fleet block ms",
                  "bench_sampler launches", "bench_serve walls=", "bench_fidelity oracle",
                  "bench_fidelity on the JAX golden's windows: -"):
        assert label in stderr, label


def test_bench_without_cuda_exits_nonzero_and_prints_no_metric():
    proc = _run_bench(env_extra=dict(TINY, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert not _metric_lines(proc.stdout), proc.stdout
    assert "torch.cuda.is_available() is False" in proc.stderr, proc.stderr[-500:]


# ---------------------------------------------------------------------------
# the timed path against the JAX package's make_render_fn, jitted

CHUNK = 16384


def _jax_render(jperf, total):
    run, args = jrender.make_render_fn(jperf, total, CHUNK)
    return np.asarray(jax.jit(run)(*args))[:, :total]


def _timed(tperf, total, monkeypatch):
    """bench.prepare's run on the CPU: render_performance's bits, and no
    host array uploaded during a run."""
    run, prep = bench.prepare(tperf, total, CHUNK, torch.device("cpu"))
    assert prep["xs_bytes"] > 0
    uploads = []
    to_device = trender._to_device
    monkeypatch.setattr(trender, "_to_device", lambda *a: uploads.append(1) or to_device(*a))
    got = run()
    assert not uploads
    assert torch.equal(got, run())  # each run from a fresh init_state
    want = trender.render_performance(tperf, total, CHUNK, device="cpu")
    assert got.dtype == torch.float32 and torch.equal(got, want)
    return got.numpy()


def test_timed_song_matches_jax(monkeypatch):
    total = int(2.0 * tsong.SAMPLE_RATE)
    got = _timed(tsong.build_performance(total), total, monkeypatch)
    ref = _jax_render(jsong.build_performance(total), total)
    assert got.shape == ref.shape == (1, total)
    assert deviation_dbfs(got, ref)[0] < -90.0
    s16 = mixdown_s16_np(got, 0.25).astype(np.int32)
    assert np.abs(s16 - mixdown_s16_np(ref, 0.25).astype(np.int32)).max() <= 1


def test_timed_sampler_matches_jax(monkeypatch):
    tperf, total = tconfigs.build_sampler_performance(seconds=1.0)
    jperf, jtotal = jconfigs.build_sampler_performance(seconds=1.0)
    assert jtotal == total
    got = _timed(tperf, total, monkeypatch)
    ref = _jax_render(jperf, total)
    assert np.abs(ref).max() > 0.1
    assert deviation_dbfs(got, ref)[0] < -110.0


def test_timed_poly_echo_matches_jax(monkeypatch):
    kw = dict(num_voices=8, seconds=1.0)
    tperf, total = tconfigs.build_poly_echo_performance(**kw)
    jperf, _ = jconfigs.build_poly_echo_performance(**kw)
    got = _timed(tperf, total, monkeypatch)
    ref = _jax_render(jperf, total)
    assert got.shape == ref.shape == (2, total)
    for ch in range(2):
        assert deviation_dbfs(got[ch], ref[ch])[0] < -110.0


# ---------------------------------------------------------------------------
# the fleet's events


class _Recorder:
    """A LiveFleet that records what is pushed into it."""

    made = []

    def __init__(self, make_parts, lanes, sample_rate, **kw):
        self.events, self.ids = [], 0
        _Recorder.made.append(self)

    def push_event(self, lane, part, params, note_id=None):
        self.ids += 1
        self.events.append((lane, part, dict(params), note_id))
        return self.ids

    def render_block(self):
        time.sleep(0.001)


def test_fleet_pushes_bench_pys_events(monkeypatch):
    spec = importlib.util.spec_from_file_location("zang_bench_jax", os.path.join(ROOT, "bench.py"))
    jbench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jbench)
    import zang_tpu.serve.live as jlive
    import zang_tpu_torch.serve.live as tlive

    monkeypatch.setenv("ZANG_BENCH_FLEET_LANES", "5")
    monkeypatch.setattr(jlive, "LiveFleet", _Recorder)
    monkeypatch.setattr(tlive, "LiveFleet", _Recorder)
    monkeypatch.setattr(_Recorder, "made", [])
    jbench.bench_fleet()
    bench.bench_fleet(torch.device("cpu"))
    want, got = _Recorder.made
    assert len(want.events) == 5 + 8 * 5 * 2
    assert got.events == want.events
