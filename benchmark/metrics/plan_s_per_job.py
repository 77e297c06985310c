"""plan_s_per_job: the mean seconds of the harness span around the
cell's build call (host/song.build_performance, host/configs.
build_poly_echo_performance: planning and the native event compiler), over
the window's jobs run with the profiler off."""

from benchmark.tracing import mean_span_s


def read(res):
    return mean_span_s(res, "plan")
