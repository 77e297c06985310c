"""device_idle_pct.offline: 1 - (the union of the device's kernel, copy and
set intervals) / the traced window (the first jobs of the window), in %."""

from benchmark.tracing import idle_pct


def read(res):
    return idle_pct(res["reading"])
