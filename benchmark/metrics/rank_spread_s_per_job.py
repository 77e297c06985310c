"""rank_spread_s_per_job: for each job, the latest rank's start of its
first chunk step (the port's span "chunk") minus the earliest rank's, on
the host's one clock, mean over the jobs whose spans every rank returned
(the unprofiled ones if any; benchmark/ranks.py): how long the first
chunk's all_reduce waits for the slowest rank's planning."""

from benchmark.ranks import first_start_ns, mean_over_jobs


def _spread(job):
    starts = [first_start_ns(recs, "chunk") for recs in job.values()]
    if None in starts:
        return None
    return (max(starts) - min(starts)) * 1e-9


def read(res):
    return mean_over_jobs(res, _spread)
