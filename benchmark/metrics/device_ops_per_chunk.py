"""device_ops_per_chunk: the kernels, copies and sets the profiler saw on
the card in the traced jobs, over their chunks."""


def read(res):
    r, chunks = res["reading"], res["counts"].get("chunks_traced", 0)
    if r is None or not chunks:
        return None
    return r["device_ops"] / chunks
