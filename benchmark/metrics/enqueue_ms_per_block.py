"""enqueue_ms_per_block: the mean wall of serve/live.LiveFleet.
render_block_async (the live host: queues, dispatchers, incremental plans,
the packed upload, the launches), which returns before the device is done,
over the window's blocks run with the profiler off."""

from benchmark.tracing import mean_span_s


def read(res):
    s = mean_span_s(res, "enqueue")
    return None if s is None else s * 1e3
