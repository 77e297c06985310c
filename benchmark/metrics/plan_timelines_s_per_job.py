"""plan_timelines_s_per_job: the seconds of the port's span "plan.timelines"
(core/timeline.compile_timelines: the native event compiler and its
marshalling) summed over a job, mean over the jobs that hold port spans
(benchmark/program_spans.py)."""

from benchmark.program_spans import mean_per_row_s


def read(res):
    return mean_per_row_s(res, "job", "plan.timelines")
