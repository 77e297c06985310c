"""upload_ms_per_chunk: the port's span "chunk.upload" (the step's
host-to-device copies of the chunk's program slices) over its "chunk" spans,
in the jobs that hold port spans (benchmark/program_spans.py), in ms."""

from benchmark.program_spans import per_unit_s


def read(res):
    s = per_unit_s(res, "job", "chunk.upload", "chunk")
    return None if s is None else s * 1e3
