"""uploads_per_chunk: the port's counter "h2d.copies" (each host-to-device
copy of a program's arrays: the static ones once a job, each chunk's slices)
over its counter "chunks" (each chunk step), over every job the process
ran (the warm jobs and the window's): a count, the same in every job of a
cell."""

from benchmark.program_spans import counter_ratio


def read(res):
    return counter_ratio("h2d.copies", "chunks")
