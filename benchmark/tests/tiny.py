"""Cells of BENCHMARK.json cut to sizes a CPU test run holds: the port's
plain path on the CPU, past the harness's look for a card. Only the test
files import this."""

import torch

from benchmark import harness, run

TINY_CONFIG = {"seconds": 2, "texture_voices": 16}
TINY_TRAFFIC = {"job_seconds": 1.0, "chunk": 16384, "check_workers": 1,
                "lanes": 4, "check_lanes": 2, "trace_jobs": 1,
                "trace_blocks": 4}
SEED = 2 ** 33 + 12345  # more than 32 signed bits, as the checks draw them


def parts(name: str, **traffic) -> dict:
    p = harness.cell_parts(harness.manifest(), name)
    p["config"] = dict(p["config"], **TINY_CONFIG)
    p["traffic"] = dict(p["traffic"], **TINY_TRAFFIC, **traffic)
    return p


def run_tiny(name: str, seconds: float = 1.0, trace: bool = False, seed: int = SEED, **traffic):
    """(correct, result line, the run's record) of one tiny run on the CPU."""
    torch.set_num_threads(1)
    res = run.run_cell(name, seed, seconds, trace, "cpu", parts(name, **traffic))
    correct, line = run.result(res, trace, 1,
                               device_kind={"platform": "cpu", "kind": "cpu", "count": 1})
    return correct, line, res
