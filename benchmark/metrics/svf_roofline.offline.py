"""svf_roofline.offline: the bytes the SVF calls need (counted from the
shapes at ops/filters.svf_filter_table, benchmark/yardstick.py) at 3.35 TB/s,
over the device time of every op launched inside the harness span around
that entry, in the traced jobs (K1 in the song, K3 in the texture)."""

from benchmark.tracing import roofline_pct


def read(res):
    return roofline_pct(res["reading"], "svf")
