"""post_ms_per_chunk: the port's span "chunk.post"
(graph/render.Performance.finish_chunk: the post chain, the echoes'
sub-chunk loop in the texture) over its "chunk" spans, in the jobs that
hold port spans (benchmark/program_spans.py), in ms."""

from benchmark.program_spans import per_unit_s


def read(res):
    s = per_unit_s(res, "job", "chunk.post", "chunk")
    return None if s is None else s * 1e3
