"""rank_slice_s_per_job: the slowest rank's port span "slice"
(graph/render.Performance.chunk_xs: its block's programs cut into per-chunk
tiles) summed over a job, mean over the jobs whose spans every rank
returned (the unprofiled ones if any; benchmark/ranks.py)."""

from benchmark.ranks import slowest_s_per_job


def read(res):
    return slowest_s_per_job(res, "slice")
