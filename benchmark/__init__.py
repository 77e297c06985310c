"""The benchmark of zang_tpu_torch on an NVIDIA H100: BENCHMARK.json at the
repository root lists its cells; `python -m benchmark.run --workload NAME
--seed N --seconds S --trace 0|1` runs one cell once.
"""
