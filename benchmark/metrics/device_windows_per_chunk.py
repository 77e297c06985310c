"""device_windows_per_chunk: the port's counter "slice.windows" (each
SegProgram whose chunk tiles the chunk step cut on the device from the
program's tables, ops/tile_windows.py; a graph replay counts its own) over
its counter "chunks" (each chunk step), over every job the process ran:
the programs a chunk windowed on the device (4 in the Toccata, 2 in the
texture; the four-card cell adds its ranks' counts). None where the port
keeps no such counter."""

from benchmark.program_spans import counter_ratio


def read(res):
    return counter_ratio("slice.windows", "chunks")
