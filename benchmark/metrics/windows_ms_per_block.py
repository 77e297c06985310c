"""windows_ms_per_block: the port's span "block.windows" (every lane's
queues drained and incremental plan windows) summed over a block, over the
blocks that hold port spans (benchmark/program_spans.py), in ms."""

from benchmark.program_spans import per_unit_s


def read(res):
    s = per_unit_s(res, "enqueue", "block.windows", "block")
    return None if s is None else s * 1e3
