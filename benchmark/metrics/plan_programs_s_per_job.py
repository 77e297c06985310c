"""plan_programs_s_per_job: the seconds of the port's span "plan.programs"
(graph/render.Performance.__init__: every part's instrument plan) summed
over a job, mean over the jobs that hold port spans
(benchmark/program_spans.py)."""

from benchmark.program_spans import mean_per_row_s


def read(res):
    return mean_per_row_s(res, "job", "plan.programs")
