"""Offline jobs, back to back: a closed loop of one client.

Set-up renders `warm_jobs` jobs (the cell's own shapes: kernels built,
the allocator's buffers held), then the window runs jobs until the one
running when `--seconds` ran out has finished. Each job is build -> render
-> s16 on the host (the configuration's entry). render_rtf = the window's
audio seconds over the seconds from its start to the end of its last job.

The traced run wraps, from here, the port's SVF entry named by the traffic
(a span a call, tagged with the bytes the call needs) and
graph/render.Performance.chunk_xs (the slicing span), and profiles the
window's first `trace_jobs` jobs. Once the window has closed, one job,
drawn from the seed over the jobs the window finished, is held to the
reference.
"""

import sys
import time
from contextlib import contextmanager, nullcontext

import numpy as np

from benchmark import harness, tracing, yardstick


@contextmanager
def wrapped(spans, svf_entry: str):
    """The port's SVF entry and Performance.chunk_xs inside harness spans
    (the traced run only)."""
    from zang_tpu_torch.graph import render
    from zang_tpu_torch.ops import filters

    svf = getattr(filters, svf_entry)
    chunk_xs = render.Performance.chunk_xs

    def svf_spanned(*args, **kwargs):
        with spans("svf", yardstick.svf_call_bytes(svf_entry, args, kwargs)):
            return svf(*args, **kwargs)

    def chunk_xs_spanned(self, *args, **kwargs):
        with spans("slice"):
            return chunk_xs(self, *args, **kwargs)

    setattr(filters, svf_entry, svf_spanned)
    render.Performance.chunk_xs = chunk_xs_spanned
    try:
        yield
    finally:
        setattr(filters, svf_entry, svf)
        render.Performance.chunk_xs = chunk_xs


def run(parts: dict, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    import torch

    t_in = time.perf_counter()
    entry, cfg, tr = parts["entry"], parts["config"], parts["traffic"]
    rng = np.random.default_rng(seed)
    spans = harness.Spans()
    ctx = entry.setup(cfg, tr)
    t_inputs = time.perf_counter()
    warm = harness.Spans()
    for _ in range(tr["warm_jobs"]):
        entry.run_job(ctx, entry.draw_job(ctx, rng), warm, device)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    pick = np.random.default_rng([seed, 1])  # the checked job: a reservoir of one
    kept, attempted, failed = None, 0, 0
    ends, audio, walls, chunks_traced = [], [], [], 0
    prof = None
    with wrapped(spans, tr["svf_entry"]) if trace else nullcontext():
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        while True:
            job = entry.draw_job(ctx, rng)
            profiled = trace and attempted < tr["trace_jobs"]
            if profiled and prof is None:
                prof = tracing.Profiler().__enter__()
                win = spans("window")
                spans.profiled = True
                win.__enter__()
            attempted += 1
            try:
                with spans("job"):
                    res = entry.run_job(ctx, job, spans, device)
            except Exception as e:  # a job that raised is missing
                failed += 1
                print(f"job {attempted} raised: {e!r}", file=sys.stderr)
                res = None
            end = time.perf_counter()
            if res is not None:
                walls.append(end - (ends[-1] if ends else t0))
                ends.append(end)
                audio.append(res["audio_s"])
                if profiled:
                    chunks_traced += res["chunks"]
                if kept is None or pick.random() < 1.0 / len(ends):
                    kept = (job, res["out"])
            if prof is not None and spans.profiled and (
                    attempted >= tr["trace_jobs"] or end - t0 >= seconds):
                win.__exit__(None, None, None)
                spans.profiled = False
                prof.__exit__(None, None, None)
            if end - t0 >= seconds:
                break
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
                   "jobs_traced": min(attempted, tr["trace_jobs"]) if trace else 0},
        "reading": prof.reading if prof is not None else None,
        "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                              if torch.cuda.is_available() else 0),
    }
    out["check"] = lambda: check(parts, ctx, kept)
    return out


def check(parts: dict, ctx: dict, kept) -> list:
    """The kept job against the reference: the s16 difference's RMS and
    peak in dBFS, each against its limit."""
    if kept is None:
        return [harness.check("jobs_checked", 0, 1, "higher")]
    job, out = kept
    ref, sl = parts["entry"].reference(ctx, job)
    return compare(parts["limits"], np.asarray(out)[sl], ref)


def compare(limits: dict, out, ref) -> list:
    from benchmark.reference.renders import deviation

    dev = deviation(out, ref)
    return [harness.check(k, dev[k], limits[k]) for k in ("rms_dbfs", "peak_dbfs")]
