"""slice_s_per_job: the mean seconds of graph/render.Performance.chunk_xs
(every program cut into per-chunk tiles), wrapped from the benchmark in the
traced run, over the window's jobs run with the profiler off."""

from benchmark.tracing import mean_span_s


def read(res):
    return mean_span_s(res, "slice")
