"""parts_ms_per_chunk: the port's span "chunk.parts"
(graph/render.Performance.render_parts: every instrument's enqueue of the
chunk) over its "chunk" spans, in the jobs that hold port spans
(benchmark/program_spans.py), in ms."""

from benchmark.program_spans import per_unit_s


def read(res):
    s = per_unit_s(res, "job", "chunk.parts", "chunk")
    return None if s is None else s * 1e3
