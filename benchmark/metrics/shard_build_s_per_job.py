"""shard_build_s_per_job: the slowest rank's port span "shard.build" (the
rank drawing and compiling its own block of voices,
zang_tpu_torch/parallel/mesh.py) in a job, mean over the jobs whose spans
every rank returned (the unprofiled ones if any; benchmark/ranks.py)."""

from benchmark.ranks import slowest_s_per_job


def read(res):
    return slowest_s_per_job(res, "shard.build")
