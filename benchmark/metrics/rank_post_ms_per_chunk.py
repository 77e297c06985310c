"""rank_post_ms_per_chunk: the slowest rank's port span "chunk.post"
(graph/render.Performance.finish_chunk: the replicated StereoEchoes
chain's enqueue, eager in the first chunk and once more in the graph's
capture) over its "chunk" spans, in ms, mean over the jobs whose spans
every rank returned (the unprofiled ones if any; benchmark/ranks.py)."""

from benchmark.ranks import slowest_ms_per_chunk


def read(res):
    return slowest_ms_per_chunk(res, "chunk.post")
