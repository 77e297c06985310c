"""pack_ms_per_block: the port's span "block.pack" (host/live.BlockPack:
every lane's windows packed into the pinned buffer and its one copy)
summed over a block, over the blocks that hold port spans
(benchmark/program_spans.py), in ms."""

from benchmark.program_spans import per_unit_s


def read(res):
    s = per_unit_s(res, "enqueue", "block.pack", "block")
    return None if s is None else s * 1e3
