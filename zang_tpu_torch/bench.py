"""Headline benchmarks of the PyTorch/CUDA port on one NVIDIA GPU: the six
metrics of the repo root's bench.py (which measures the JAX package on a
TPU), measured through the port under the same names with `torch_` in front.

    python -m zang_tpu_torch.bench [--device cuda|cpu]

The device is the card unless --device cpu is given; without CUDA the run
exits non-zero before printing any metric. Prints one JSON line per metric,
each {"metric": "...", "value": N, "unit": "...", "vs_baseline": N}, the
headline (the full Bach Toccata's render RTF) LAST. In print order:

  torch_sampler_chain_rtf_44k        drumloop sampler -> distortion ->
                                     decimator (host/configs.py); K4;
                                     vs_baseline = value / 1000
  torch_poly_echo_voices_per_chip    NiceInstrument voices through
                                     StereoEchoes at RTF 1 on one card
                                     (rendered at 16384 voices, scaled by
                                     RTF); K3 at >= 4096 voices and <= 4
                                     slots a tile, else K1;
                                     vs_baseline = value / 1024
  torch_batch_serve_rtf_aggregate    N song slices as WAV jobs through
                                     serve/batch.BatchRenderer on the card
                                     (one worker), audio seconds a wall
                                     second; K1; vs_baseline = value
  torch_live_fleet_sessions_per_chip 64 live sessions folded into one step a
                                     block (serve/live.LiveFleet); lanes x
                                     block budget / best block time; K2;
                                     vs_baseline = value
  torch_bach_render_fidelity_rms_dbfs  the whole song rendered on the
                                     device (K1) against the port's
                                     reference oracle over every frame
                                     (host/song.render_song_oracle: numpy
                                     and C++ on the host, held bit for bit
                                     to the JAX package's oracle), as
                                     bench.py defines it; unit
                                     dbfs_rms_vs_oracle;
                                     vs_baseline = value / -90
  torch_bach_toccata_render_rtf_48k  the full 385 s song; K1;
                                     vs_baseline = value / 1000

RTF (sampler, poly, song) = seconds of audio / seconds of the best of 3
timed renders after one warm render, as bench.py's _steady_rtf: the piece
is planned, every chunk's programs cut (Performance.chunk_xs) and what the
step needs put on the device before the clock starts; a timed render is
the chunk loop through one make_stream_step from a fresh init_state,
ending in a scalar fetch (.sum().item()). The warm render also closes the end-to-end time
(planning, slicing, upload, render and the s16 fetch), printed for the song
and poly_echo.

Lines starting with "#" go to stderr and are not metrics: the card's
nvidia-smi name and power limit and the host's load first, then the
kernels' build seconds, each metric's end-to-end seconds, kernel launches
(the wrappers' counters), peak device memory and spread, the fleet's
median and p99 block beside its best, and fidelity's oracle seconds (host
CPU time, outside any timed window) beside its reading on the JAX
package's golden windows (data/song_golden_jax.npz).

Env (bench.py's knobs and defaults):
  ZANG_BENCH_SECONDS   song length (default 385); also fidelity's
  ZANG_BENCH_CHUNK     chunk size (default 65536)
  ZANG_BENCH_METRICS   comma list: sampler,poly,serve,fleet,fidelity,song
  ZANG_BENCH_POLY_VOICES / _POLY_SECONDS / _POLY_CHUNK  (16384, 8 s, CHUNK)
  ZANG_BENCH_SAMPLER_SECONDS  (60 s)
  ZANG_BENCH_SERVE_SONGS / _SERVE_SECONDS / _SERVE_PASSES  (6 x 60 s, 3)
  ZANG_BENCH_FLEET_LANES / _FLEET_BLOCK  (64 lanes x 4096 samples)
  ZANG_BENCH_IDLE_WAIT / _IDLE_LOAD  before serve and fleet, wait up to
                       IDLE_WAIT s (600) for the host's load1 to drop under
                       IDLE_LOAD x cores (0.35); 0 disables the wait
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .core import native
from .core.mixdown import mixdown_s16
from .device import require_device
from .graph.fidelity import deviation_dbfs
from .graph.render import _device_dtype, _leaves, _map_arrays, _to_device, make_stream_step
from .host import configs
from .host import instruments as ti
from .host import song as sm
from .ops import _build
from .ops.segprog import SegProgram, WindowPlan
from .oracle import native as oracle_native
from .parallel.mesh import launch_counts, reset_launch_counts

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "song_golden_jax.npz")
KERNELS = ("svf_table", "svf_dense", "svf_onepass", "table_lookup", "fm_feedback",
           "tile_windows")
FLEET_SR = 48000.0
FLEET_TIMED_BLOCKS = 8


def _note(line: str) -> None:
    print(f"# {line}", file=sys.stderr, flush=True)


def emit(metric, value, unit, vs_baseline):
    print(json.dumps({"metric": metric, "value": value, "unit": unit,
                      "vs_baseline": vs_baseline}), flush=True)


def _spread_note(label, walls):
    spread = (max(walls) - min(walls)) / min(walls) if min(walls) else 0.0
    _note(f"{label} walls={['%.4f' % w for w in walls]} spread={spread:.1%}")


class _Meter:
    """A metric's launches (the six kernels' counters, from 0) and peak
    device memory, noted on stderr when it ends."""

    def __init__(self, label: str, dev) -> None:
        self.label, self.dev = label, dev
        reset_launch_counts()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)

    def note(self, renders: str) -> None:
        n = {k: v for k, v in launch_counts().items() if v}
        peak = (f"{torch.cuda.max_memory_allocated(self.dev) / 2 ** 30:.2f} GiB"
                if self.dev.type == "cuda" else "not measured (cpu)")
        _note(f"{self.label} launches {json.dumps(n)} over {renders}; "
              f"peak device memory {peak}")


def prepare(perf, total: int, chunk: int, dev):
    """Host, before any clock: cut every chunk's programs (window plans, or
    the flat format's slices, put on `dev`) and make one step (its static
    programs and the programs' tables uploaded once). Returns (run,
    seconds): run() renders the piece from a fresh init_state and returns
    f32 [C, total] on `dev`, render_performance's bits; no numpy array
    reaches the step, so a run uploads nothing. seconds: the slice and
    upload times and the bytes of the chunk programs on `dev` (the slices,
    or the tables the tiles are cut from)."""
    t = time.perf_counter()
    xs, n_chunks = perf.chunk_xs(total, chunk)
    slice_s = time.perf_counter() - t
    t = time.perf_counter()
    xs_dev = [_map_arrays(xs, lambda a, i=i: _to_device(a[i], dev)) for i in range(n_chunks)]
    step = make_stream_step(perf, chunk, device=dev)
    step.tables()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    upload_s = time.perf_counter() - t
    nbytes = sum(a.numel() * a.element_size() for x in xs_dev for a in _leaves(x))
    if _leaves(xs, WindowPlan):
        nbytes += sum(sp.starts.size * 4 + sum(v.size * _device_dtype(v).itemsize
                                               for v in sp.values.values())
                      for sp in _leaves(perf.programs, SegProgram))

    def run() -> torch.Tensor:
        out = torch.empty((perf.num_channels, n_chunks * chunk), dtype=torch.float32,
                          device=dev)
        state = None
        for i, x in enumerate(xs_dev):
            state, audio = step(state, i * chunk, x)
            out[:, i * chunk:(i + 1) * chunk] = audio
        return out[:, :total]

    return run, dict(slice_s=slice_s, upload_s=upload_s, xs_bytes=nbytes)


def steady_rtf(label, build, seconds, chunk, dev, volume=None):
    """bench.py's _steady_rtf through the port: plan (build() ->
    (Performance, total)), prepare, one warm run, then the best of 3 timed
    runs, each ending in a scalar fetch. With `volume`, the warm run ends
    in the s16 mixdown fetched to the host and closes the end-to-end time,
    noted with its parts."""
    meter = _Meter(label, dev)
    t0 = time.perf_counter()
    perf, total = build()
    plan_s = time.perf_counter() - t0
    run, prep = prepare(perf, total, min(chunk, total), dev)
    t = time.perf_counter()
    out = run()
    if volume is not None:
        mixdown_s16(out, volume).cpu().numpy()
        t1 = time.perf_counter()
        _note(f"{label} end to end {t1 - t0:.3f}s: plan {plan_s:.3f}s, slice "
              f"{prep['slice_s']:.3f}s, upload {prep['upload_s']:.3f}s "
              f"({prep['xs_bytes'] / 2 ** 30:.3f} GiB of chunk programs), render and "
              f"s16 fetch {t1 - t:.3f}s (RTF {seconds / (t1 - t0):.1f} end to end)")
    else:
        out.sum().item()
    del out
    walls = []
    for _ in range(3):
        t = time.perf_counter()
        run().sum().item()
        walls.append(time.perf_counter() - t)
    _spread_note(label, walls)
    meter.note("4 renders (1 warm, 3 timed)")
    return seconds / min(walls)


def bench_sampler(chunk, dev):
    seconds = float(os.environ.get("ZANG_BENCH_SAMPLER_SECONDS", 60.0))
    rtf = steady_rtf("bench_sampler",
                     lambda: configs.build_sampler_performance(seconds=seconds),
                     seconds, chunk, dev)
    emit("torch_sampler_chain_rtf_44k", round(rtf, 1), "x_realtime",
         round(rtf / 1000.0, 3))


def bench_poly(chunk, dev):
    voices = int(os.environ.get("ZANG_BENCH_POLY_VOICES", 16384))
    seconds = float(os.environ.get("ZANG_BENCH_POLY_SECONDS", 8.0))
    chunk = int(os.environ.get("ZANG_BENCH_POLY_CHUNK", chunk))
    rtf = steady_rtf(
        "bench_poly",
        lambda: configs.build_poly_echo_performance(num_voices=voices, seconds=seconds),
        seconds, chunk, dev, volume=configs.MIX_VOLUME)
    capacity = int(voices * rtf)
    emit("torch_poly_echo_voices_per_chip", capacity, "voices_at_rtf1",
         round(capacity / 1024.0, 2))


def bench_serve(chunk, dev):
    """Aggregate WAV throughput: one short job warms the renderer's shared
    step, then N jobs are timed end to end (planning, render, s16 mixdown,
    fetch, disk) through BatchRenderer on `dev`, best of N passes."""
    from .serve.batch import BatchRenderer, RenderJob

    songs = int(os.environ.get("ZANG_BENCH_SERVE_SONGS", 6))
    seconds = float(os.environ.get("ZANG_BENCH_SERVE_SECONDS", 60.0))
    passes = int(os.environ.get("ZANG_BENCH_SERVE_PASSES", 3))

    def mk(secs):
        total = int(secs * sm.SAMPLE_RATE)
        return lambda: (sm.build_performance(total), total)

    meter = _Meter("bench_serve", dev)
    with tempfile.TemporaryDirectory() as out:
        br = BatchRenderer(out_dir=out, chunk_size=chunk, devices=[dev])
        warm = br.run([RenderJob(name="warm", build=mk(8.0), volume=0.25)])
        if warm[0].status != "ok":
            raise RuntimeError(f"bench_serve: the warm job failed: {warm[0].error}")
        jobs = [RenderJob(name=f"job_{i:02d}", build=mk(seconds), volume=0.25)
                for i in range(songs)]
        walls = []
        for _ in range(passes):
            t0 = time.perf_counter()
            results = br.run(jobs)
            walls.append(time.perf_counter() - t0)
            failed = [r.error for r in results if r.status != "ok"]
            if failed:
                raise RuntimeError(f"bench_serve: jobs failed: {failed}")
    _spread_note("bench_serve", walls)
    meter.note(f"1 warm job of 8 s and {passes} passes of {songs} x {seconds:g} s")
    return sum(r.seconds for r in results) / min(walls)


def bench_fleet(dev):
    """Live serving: `lanes` sessions in one LiveFleet, one folded step a
    block; value = lanes x block budget / best block time."""
    from .serve.live import LiveFleet

    lanes = int(os.environ.get("ZANG_BENCH_FLEET_LANES", 64))
    block = int(os.environ.get("ZANG_BENCH_FLEET_BLOCK", 4096))
    rng = np.random.default_rng(0)
    meter = _Meter("bench_fleet", dev)
    fleet = LiveFleet(lambda: [(ti.NiceInstrument(0.3), 4)], lanes, FLEET_SR,
                      block_size=block, device=dev)

    def push_all(release):
        for lane in range(lanes):
            f = float(np.float32(220.0 * 2 ** (rng.integers(0, 13) / 12.0)))
            nid = fleet.push_event(lane, 0, {"freq": f, "note_on": True})
            if release:
                fleet.push_event(lane, 0, {"freq": f, "note_on": False}, note_id=nid)

    push_all(False)
    fleet.render_block()  # warm: the first block's allocations
    times = []
    for _ in range(FLEET_TIMED_BLOCKS):
        push_all(True)
        t0 = time.perf_counter()
        fleet.render_block()  # ends in the block's copy to the host
        times.append(time.perf_counter() - t0)
    _spread_note("bench_fleet", times)
    budget = block / FLEET_SR
    ms = np.asarray(times) * 1e3
    med, p99 = float(np.median(ms)), float(np.percentile(ms, 99))
    _note(f"bench_fleet block ms: best {ms.min():.3f}, median {med:.3f}, p99 {p99:.3f} "
          f"(n={len(ms)}; budget {budget * 1e3:.3f}); sessions a card at the median "
          f"{lanes * budget / (med / 1e3):.1f}")
    meter.note(f"{1 + FLEET_TIMED_BLOCKS} blocks of {lanes} lanes")
    return lanes * budget / (ms.min() / 1e3)


def song_fidelity(audio: np.ndarray, gold) -> float:
    """RMS dBFS of the song's mix [total] against the JAX golden windows
    that lie inside it."""
    w = int(gold["window"])
    offsets = [int(o) for o in gold["offsets"] if o + w <= audio.shape[-1]]
    if not offsets:
        raise ValueError(f"no golden window of {w} frames inside {audio.shape[-1]} frames")
    ours = np.stack([audio[o:o + w] for o in offsets])
    keep = np.isin(gold["offsets"], offsets)
    return deviation_dbfs(ours, gold["windows"][keep])[0]


def bench_fidelity(seconds, chunk, dev):
    """bench.py's fidelity: the whole song on `dev` against the oracle's
    render over every frame (graph/fidelity.deviation_dbfs)."""
    from .graph.render import render_performance

    total = int(seconds * sm.SAMPLE_RATE)
    meter = _Meter("bench_fidelity", dev)
    mix = render_performance(sm.build_performance(total), total,
                             chunk_size=min(chunk, total), device=dev)
    if not bool(torch.isfinite(mix).all()):
        raise RuntimeError("bench_fidelity: non-finite samples in the song")
    meter.note("1 render")
    mix = mix[0].cpu().numpy()
    t = time.perf_counter()
    ref = sm.render_song_oracle(seconds)
    _note(f"bench_fidelity oracle {seconds:g} s of song in {time.perf_counter() - t:.2f} s "
          f"(host CPU, render_song_oracle, not timed)")
    rms, _peak = deviation_dbfs(mix, ref)
    try:
        with np.load(GOLDEN) as gold:
            _note(f"bench_fidelity on the JAX golden's windows: "
                  f"{song_fidelity(mix, gold):.1f} dBFS")
    except ValueError as e:  # no window inside a short song
        _note(f"bench_fidelity on the JAX golden's windows: {e}")
    emit("torch_bach_render_fidelity_rms_dbfs", round(float(rms), 1),
         "dbfs_rms_vs_oracle", round(float(rms) / -90.0, 3))


def bench_song(seconds, chunk, dev):
    total = int(seconds * sm.SAMPLE_RATE)
    rtf = steady_rtf("bench_song", lambda: (sm.build_performance(total), total),
                     seconds, chunk, dev, volume=sm.MIX_VOLUME)
    emit("torch_bach_toccata_render_rtf_48k", round(rtf, 1), "x_realtime",
         round(rtf / 1000.0, 3))


def _load1() -> float:
    try:
        return os.getloadavg()[0]
    except OSError:  # pragma: no cover
        return -1.0


def _wait_for_idle(label) -> None:
    """Bounded idle gate ahead of the host-bound serve and fleet metrics:
    wait up to ZANG_BENCH_IDLE_WAIT s for load1 under IDLE_LOAD x cores."""
    budget = float(os.environ.get("ZANG_BENCH_IDLE_WAIT", 600.0))
    thresh = float(os.environ.get("ZANG_BENCH_IDLE_LOAD", 0.35)) * (os.cpu_count() or 1)
    deadline = time.time() + budget
    load1 = _load1()
    waited = False
    while load1 > thresh and time.time() < deadline:
        if not waited:
            _note(f"{label}: host_load1={load1:.2f} > {thresh:.2f} — waiting for idle "
                  f"(up to {budget:.0f} s)")
        waited = True
        time.sleep(15.0)
        load1 = _load1()
    if waited or load1 > thresh:
        verdict = "idle" if load1 <= thresh else "STILL LOADED — proceeding"
        _note(f"{label}: host_load1={load1:.2f} after wait ({verdict})")


def _card_line(dev) -> str:
    if dev.type != "cuda":
        return "cpu (no card)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _build_kernels(dev) -> None:
    """Set-up, before any clock: the host compiler and the oracle's loops
    (g++) and, on the card, the six kernels (nvcc), one process a source,
    all started together."""
    t = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS) + 2) as pool:
        jobs = {"zang_host": pool.submit(native.build),
                "zang_oracle": pool.submit(oracle_native.build)}
        if dev.type == "cuda":
            jobs.update({k: pool.submit(_build.build, k) for k in KERNELS})
        secs = {k: j.result() for k, j in jobs.items()}
    _note(f"build {', '.join(f'{k} {v:.2f}s' for k, v in secs.items())} "
          f"({time.perf_counter() - t:.2f}s wall)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the port's headline benchmarks")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N, or cpu (the plain paths)")
    args = ap.parse_args(argv)
    try:
        dev = require_device(args.device)
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())

    _note(f"card {_card_line(dev)}; device {dev}"
          f"{' ' + torch.cuda.get_device_name(dev) if dev.type == 'cuda' else ''}; "
          f"host_load1={_load1():.2f} ncpu={os.cpu_count()}; torch {torch.__version__}")
    _build_kernels(dev)

    seconds = float(os.environ.get("ZANG_BENCH_SECONDS", sm.NUM_SECONDS))
    chunk = int(os.environ.get("ZANG_BENCH_CHUNK", 65536))
    which = os.environ.get("ZANG_BENCH_METRICS", "sampler,poly,serve,fleet,fidelity,song")
    which = {w.strip() for w in which.split(",") if w.strip()}

    if "sampler" in which:
        bench_sampler(chunk, dev)
    if "poly" in which:
        bench_poly(chunk, dev)
    if "serve" in which:
        _wait_for_idle("bench_serve")
        rtf = bench_serve(chunk, dev)
        emit("torch_batch_serve_rtf_aggregate", round(rtf, 1), "x_realtime_wav_delivery",
             round(rtf, 1))
    if "fleet" in which:
        _wait_for_idle("bench_fleet")
        sessions = bench_fleet(dev)
        emit("torch_live_fleet_sessions_per_chip", round(sessions, 1), "realtime_sessions",
             round(sessions, 1))
    if "fidelity" in which:
        bench_fidelity(seconds, chunk, dev)
    if "song" in which:  # the headline, last
        bench_song(seconds, chunk, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
