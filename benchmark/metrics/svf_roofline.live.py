"""svf_roofline.live: as svf_roofline.offline, at the dense entry
ops/filters.svf_filter that the live fleet's folded lanes take (K2), over
the traced blocks."""

from benchmark.tracing import roofline_pct


def read(res):
    return roofline_pct(res["reading"], "svf")
