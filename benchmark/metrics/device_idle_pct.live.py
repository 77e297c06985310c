"""device_idle_pct.live: as device_idle_pct.offline, over the traced blocks
(their waits for the due time included: a fleet below its knee idles)."""

from benchmark.tracing import idle_pct


def read(res):
    return idle_pct(res["reading"])
