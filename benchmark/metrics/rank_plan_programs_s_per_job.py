"""rank_plan_programs_s_per_job: the slowest rank's port span
"plan.programs" (graph/render.Performance.__init__: NiceInstrument.plan of
the rank's block) summed over a job, mean over the jobs whose spans every
rank returned (the unprofiled ones if any; benchmark/ranks.py)."""

from benchmark.ranks import slowest_s_per_job


def read(res):
    return slowest_s_per_job(res, "plan.programs")
