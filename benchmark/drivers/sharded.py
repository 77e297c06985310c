"""Offline jobs over several cards, back to back: a closed loop of one
client driving the port's persistent sharded renderer
(zang_tpu_torch/parallel/mesh.py ShardedRenderer: a process a card, started
once; each job's voices in contiguous blocks, one a rank; one all_reduce of
the mix a chunk before the replicated post chain).

Set-up builds the port's libraries here (the entry's prepare), starts the
ranks and their process group, and renders `warm_jobs` jobs (the cell's
shapes: every rank's kernels loaded, its allocator warm). The window runs
in this process on the host clock, as drivers/offline.py's does: jobs
until the one running when `--seconds` ran out has finished; render_rtf =
the window's audio seconds over the seconds from its start to the end of
its last job. A job: its seed drawn here, every rank builds and renders its
block, rank 0 mixes down to s16 on its card and returns it. A job that
raises ends the window (its ranks have ended).

The traced run turns the port's recorder on in every rank for every job of
the window (their records come back with the job: benchmark/ranks.py's
readers), then renders `trace_jobs` more jobs after the window with rank 0
profiled (rank 0's device trace, reduced in rank 0, with the traffic's SVF
entry in harness spans as drivers/offline.py wraps it: the reading, with
its NCCL kernels' seconds, allreduce_ms_per_chunk). Starting the profiler
delays rank 0 by seconds, so the profiled jobs come after the window, and
in them every rank waits at a barrier until rank 0's profiler runs. In
every run, each rank's change of the port's counters over a job is added
to this process's counters of the port, so the counter ratios read the
ranks' chunks.

memory_peak_bytes: the fullest card's peak over the run. Once the window
has closed and the ranks have ended, one job drawn from the seed over the
jobs the window finished is held to the reference over its first
`judged_frames` frames (the limits file's); the reference's seconds go to
standard error.

A program without the persistent renderer fails here at once, before a
rank starts.
"""

import functools
import sys
import time

import numpy as np

from benchmark import harness
from benchmark.drivers.offline import compare

STAGES = ("build_s", "plan_s", "slice_s", "render_s")


def renderer_class():
    from zang_tpu_torch.parallel import mesh

    cls = getattr(mesh, "ShardedRenderer", None)
    if cls is None:
        raise RuntimeError("zang_tpu_torch.parallel.mesh has no ShardedRenderer: this "
                           "program has no ranks that persist across jobs")
    return mesh, cls


def run(parts: dict, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    mesh, ShardedRenderer = renderer_class()
    from zang_tpu_torch import trace as port_trace

    from benchmark import ranks as rank_side

    t_in = time.perf_counter()
    entry, cfg, tr = parts["entry"], parts["config"], parts["traffic"]
    chips = parts["workload"]["chips"]
    rng = np.random.default_rng(seed)
    spans = harness.Spans()
    ctx = entry.setup(cfg, tr)
    entry.prepare(ctx, device)
    renderer = ShardedRenderer(mesh.make_mesh(chips, device=device),
                               num_threads=1 if str(device) == "cpu" else None)
    peak, stages = 0, {k: [] for k in STAGES}

    def took(ranks_out, window: bool) -> None:
        nonlocal peak
        for r in ranks_out:
            peak = max(peak, r["peak_bytes"] or 0)
            for k, v in r["counts"].items():
                port_trace.count(k, v)
            if window:
                for k in STAGES:
                    stages[k].append(r[k])

    pick = np.random.default_rng([seed, 1])  # the checked job: a reservoir of one
    kept, attempted, failed = None, 0, 0
    ends, audio, walls, rank_jobs = [], [], [], []
    chunks_traced, reading = 0, None
    try:
        t_inputs = time.perf_counter()
        warm = harness.Spans()
        for _ in range(tr["warm_jobs"]):
            with warm("job"):
                _, ranks_out = renderer.render(entry.render_job(ctx, entry.draw_job(ctx, rng)))
            took(ranks_out, False)
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        traced = 0
        while True:  # the window, then (traced) the profiled jobs
            profiled = bool(ends) and ends[-1] - t0 >= seconds
            if profiled and (not trace or traced == tr["trace_jobs"]):
                break
            job = entry.draw_job(ctx, rng)
            observe = (functools.partial(rank_side.observe, profile=profiled,
                                         svf_entry=tr["svf_entry"]) if trace else None)
            attempted += 1
            try:
                with spans("job"):
                    out, ranks_out = renderer.render(entry.render_job(ctx, job, observe))
            except Exception as e:  # a job that raised is missing, and its ranks are gone
                failed += 1
                print(f"job {attempted} raised: {e!r}", file=sys.stderr)
                break
            took(ranks_out, not profiled)
            if trace:
                rank_jobs.append({"profiled": profiled, "world": len(ranks_out),
                                  "records": {r["rank"]: r["records"] for r in ranks_out}})
            if profiled:
                traced += 1
                reading = reading or ranks_out[0]["reading"]
                chunks_traced = chunks_traced or entry.chunks(ctx)
                continue
            end = time.perf_counter()
            walls.append(end - (ends[-1] if ends else t0))
            ends.append(end)
            audio.append(entry.audio_s(ctx))
            if kept is None or pick.random() < 1.0 / len(ends):
                kept = (job, out)
    finally:
        renderer.close()
    out = {
        "setup_s": setup_s,
        "setup": harness.setup_parts(t_start, t_in, t_inputs, t0, warm),
        "end_to_end": {"render_rtf": harness.closed_loop_rate(ends, audio, t0) if ends
                       else 0.0},
        "attempted": attempted,
        "failed": failed,
        "spans": spans,
        "counts": {"jobs": len(ends), "chunks_traced": chunks_traced,
                   "job_s": [float(np.min(walls)), float(np.median(walls)),
                             float(np.max(walls))] if walls else None,
                   "jobs_traced": traced,
                   "ranks": chips,
                   "rank_s": {k: [float(np.min(v)), float(np.max(v))]
                              for k, v in stages.items() if v}},
        "reading": reading,
        "rank_jobs": rank_jobs,
        "memory_peak_bytes": peak,
    }
    out["check"] = lambda: check(parts, ctx, kept)
    return out


def check(parts: dict, ctx: dict, kept) -> list:
    """The kept job against the reference over its first judged_frames:
    the s16 difference's RMS and peak in dBFS, each against its limit."""
    if kept is None:
        return [harness.check("jobs_checked", 0, 1, "higher")]
    job, out = kept
    limits = parts["limits"]
    t = time.perf_counter()
    ref, sl = parts["entry"].reference(ctx, job, judged=limits["judged_frames"])
    print(f"# reference: {ref.shape[1]} frames of {parts['config']['texture_voices']} "
          f"voices in {time.perf_counter() - t:.3f} s on "
          f"{parts['traffic']['check_workers']} workers", file=sys.stderr)
    return compare(limits, np.asarray(out)[sl], ref)
