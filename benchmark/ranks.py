"""The sharded cell's side in the ranks, and the readers of what the ranks
send back.

observe is a RenderJob's observe (zang_tpu_torch/parallel/mesh.py): the
port's rank calls it around its job. In the traced run it turns the port's
recorder on for the job and returns its records with the job's dict. When
asked to profile, rank 0 runs torch.profiler over the job, reduced there
(benchmark/tracing.py: the whole job is the traced window), with the SVF
entry in harness spans (drivers/offline.py wrapped: svf_roofline) and the
device seconds of the NCCL kernels in that window beside the reading; every
rank waits at a barrier until rank 0's profiler runs, so rank 0's
collectives wait for a slower peer as any rank's would. It travels to the
ranks pickled by name, so this module is imported, never loaded by its
path.

The readers: drivers/sharded.py keeps, for each job of a traced run, each
rank's records as tuples (name, id, parent, root, thread, t0 ns, t1 ns) on
time.perf_counter_ns, the clock every process of the host shares.
"""

from benchmark import harness, tracing

NCCL = "nccl"  # NCCL's kernels carry it in their names (ncclDevKernel_..., ncclKernel_...)


def collective_s(events) -> float:
    """The device seconds of the NCCL kernels inside the traced window."""
    window = [e for e in events if e["name"] == tracing.WINDOW and not e["device"]]
    if not window:
        return 0.0
    t0, t1 = min(e["start"] for e in window), max(e["end"] for e in window)
    return sum(min(e["end"], t1) - max(e["start"], t0) for e in events
               if e["device"] and NCCL in e["name"].lower()
               and e["end"] > t0 and e["start"] < t1) * 1e-9


def barrier(rank) -> None:
    """Every rank waits here for every other (the card's queue drained
    after, so the barrier's own kernel ends before the caller goes on)."""
    import torch
    import torch.distributed as dist

    if rank.device.type == "cuda":
        dist.barrier(device_ids=[rank.device.index])
        torch.cuda.synchronize(rank.device)
    else:
        dist.barrier()


def observe(rank, run, profile: bool = False, svf_entry: str = "svf_filter_table") -> dict:
    from zang_tpu_torch import trace

    trace.take()  # records of earlier jobs are not this job's
    trace.enable()
    prof = None
    try:
        if profile and rank.rank == 0:
            from torch.profiler import record_function

            from benchmark.drivers.offline import wrapped

            prof = tracing.Profiler().__enter__()
            try:
                barrier(rank)
                spans = harness.Spans()
                spans.profiled = True
                with wrapped(spans, svf_entry), record_function(tracing.WINDOW), \
                        record_function("bench.job"):
                    out = run()
            finally:
                prof.__exit__(None, None, None)
        else:
            if profile:
                barrier(rank)
            out = run()
    finally:
        trace.disable()
    out["records"] = [tuple(r) for r in trace.take()]
    if prof is not None:
        out["reading"] = dict(prof.reading,
                              collective_s=collective_s(tracing.plain_events(prof.prof)))
    return out


# ---------------------------------------------------------------------------
# the readers


def chosen_jobs(res) -> list:
    """Each job of the run whose records every rank returned, as {rank:
    records}: the unprofiled jobs if any, else the profiled (rank 0's
    profiler slows its host)."""
    jobs = [j for j in res.get("rank_jobs") or ()
            if len(j["records"]) == j["world"] and all(j["records"].values())]
    if any(not j["profiled"] for j in jobs):
        jobs = [j for j in jobs if not j["profiled"]]
    return [j["records"] for j in jobs]


def mean_over_jobs(res, per_job):
    """The mean over chosen_jobs of per_job({rank: records}), over the jobs
    where it is not None; None without any."""
    xs = [x for x in map(per_job, chosen_jobs(res)) if x is not None]
    return sum(xs) / len(xs) if xs else None


def first_start_ns(records, name: str):
    """The start of a rank's first span `name` in a job, or None."""
    return min((r[5] for r in records if r[0] == name), default=None)


def span_ns(records, name: str):
    """The summed durations of a rank's spans `name` in a job, or None
    without any."""
    xs = [r[6] - r[5] for r in records if r[0] == name]
    return sum(xs) if xs else None


def slowest_s_per_job(res, name: str):
    """The slowest rank's spans `name` summed over a job, in s, mean over
    chosen_jobs; None where a rank has none."""
    def slowest(job):
        xs = [span_ns(recs, name) for recs in job.values()]
        return None if None in xs else max(xs) * 1e-9

    return mean_over_jobs(res, slowest)


def slowest_ms_per_chunk(res, name: str):
    """The slowest rank's spans `name` over its "chunk" spans in a job, in
    ms, mean over chosen_jobs; None where a rank has none of either."""
    def slowest(job):
        xs = []
        for recs in job.values():
            s, chunks = span_ns(recs, name), sum(1 for r in recs if r[0] == "chunk")
            if s is None or not chunks:
                return None
            xs.append(s / chunks)
        return max(xs) * 1e-6

    return mean_over_jobs(res, slowest)
