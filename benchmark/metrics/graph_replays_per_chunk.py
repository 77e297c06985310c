"""graph_replays_per_chunk: the port's counter "graph.replays" (each replay
of a chunk step's CUDA graph, graph/render.GraphStep) over its counter
"chunks" (each chunk step), over every job the process ran: the share of
chunks whose host work is one graph replay (a job's first chunk renders
eagerly and its second is captured, then replayed). None where the port
keeps no such counter."""

from benchmark.program_spans import counter_ratio


def read(res):
    return counter_ratio("graph.replays", "chunks")
