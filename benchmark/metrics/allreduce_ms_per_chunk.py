"""allreduce_ms_per_chunk: the device seconds of rank 0's NCCL kernels in
the traced job (benchmark/ranks.py collective_s: the all_reduce of each
chunk's mix, with any wait in it for the slowest rank) over that job's
chunks, in ms: the communication a chunk leaves exposed. None without a
traced reading from the ranks."""


def read(res):
    r, chunks = res.get("reading"), res["counts"].get("chunks_traced", 0)
    if r is None or "collective_s" not in r or not chunks:
        return None
    return r["collective_s"] / chunks * 1e3
