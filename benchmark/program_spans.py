"""The port's own spans and counters (zang_tpu_torch/trace.py), read beside
the harness's.

The port records its spans while a torch.profiler runs (the traced run's
profiled jobs or blocks) or while its recorder is enabled. A reader joins
them to the harness's spans on the host clock (both time.perf_counter):
a port record belongs to a harness row ("job" offline, "enqueue" live)
that holds it whole. Of the rows that hold any port record, those run with
the profiler off are used when there are any (the profiler slows the
host), else the profiled ones, as harness.Spans.seconds chooses.

On the device side, idle_gaps_program puts each idle gap of a traced
window down to the innermost port range ("zt.<name>") open on the main
thread over each part of it, and a part with none open to the harness's
range, as reduce_events' idle_gaps does.

A program without the recorder (none loaded) reads None everywhere.
"""

import sys
from bisect import bisect_left
from collections import defaultdict

from benchmark import tracing

PORT_TRACE = "zang_tpu_torch.trace"


def port_trace():
    """The port's recorder module, if the program loaded it."""
    return sys.modules.get(PORT_TRACE)


def chosen_rows(res, row: str, recs) -> list:
    """[(t0 ns, t1 ns, [the port records inside])] of the harness rows
    `row` that hold a port record: the unprofiled ones if any, else all."""
    rows = []
    spans = sorted(recs, key=lambda r: r.t0)
    starts = [r.t0 for r in spans]
    for name, t0, t1, profiled in res["spans"].records:
        if name != row:
            continue
        a, b = int(t0 * 1e9), int(t1 * 1e9)
        inside = [r for r in spans[bisect_left(starts, a):bisect_left(starts, b + 1)]
                  if r.t1 <= b]
        if inside:
            rows.append((profiled, a, b, inside))
    if any(not p for p, *_ in rows):
        rows = [r for r in rows if not r[0]]
    return [(a, b, inside) for _, a, b, inside in rows]


def _rows(res, row: str):
    tr = port_trace()
    if tr is None:
        return None
    return chosen_rows(res, row, tr.records()) or None


def mean_per_row_s(res, row: str, span: str):
    """The seconds of the port's spans `span` summed over each chosen row
    `row`, mean over the rows; None without rows."""
    rows = _rows(res, row)
    if rows is None:
        return None
    sums = [sum(r.t1 - r.t0 for r in inside if r.name == span) for _, _, inside in rows]
    return sum(sums) / len(sums) * 1e-9


def per_unit_s(res, row: str, span: str, unit: str):
    """The seconds of the port's spans `span` over the count of its spans
    `unit` (a chunk, a block), in the chosen rows `row`; None without rows
    or units."""
    rows = _rows(res, row)
    if rows is None:
        return None
    total = units = 0
    for _, _, inside in rows:
        for r in inside:
            if r.name == span:
                total += r.t1 - r.t0
            elif r.name == unit:
                units += 1
    return total / units * 1e-9 if units else None


def counter_ratio(num: str, den: str):
    """Counter `num` over counter `den`, over the process (None without the
    port's counters or with `den` at 0)."""
    tr = port_trace()
    if tr is None:
        return None
    c = tr.counters()
    return c[num] / c[den] if c.get(den) and num in c else None


# ---------------------------------------------------------------------------
# the device side


def segments(ranges):
    """[(start, end, innermost range)] over the time some range of
    `ranges` (nested, one thread) is open, in order."""
    marks = []
    for i, r in enumerate(ranges):
        if r["end"] > r["start"]:
            marks += [(r["start"], 1, i), (r["end"], 0, i)]
    marks.sort()
    out, stack, last = [], [], None
    for t, kind, i in marks:
        if stack and last is not None and t > last:
            out.append((last, t, ranges[stack[-1]]))
        last = t
        if kind:
            stack.append(i)
        elif stack and stack[-1] == i:
            stack.pop()
        elif i in stack:
            stack.remove(i)
    return out


def split(gaps, segs):
    """Each of the sorted gaps cut by the sorted segments `segs` (of
    segments()): [(start, end, range or None)] covering every gap whole."""
    out, j = [], 0
    for s, e in gaps:
        cur = s
        while j < len(segs) and segs[j][1] <= s:
            j += 1
        k = j
        while cur < e and k < len(segs) and segs[k][0] < e:
            a, b, r = segs[k]
            if a > cur:
                out.append((cur, a, None))
                cur = a
            out.append((cur, min(b, e), r))
            cur = min(b, e)
            k += 1
        if cur < e:
            out.append((cur, e, None))
    return out


def idle_gaps_program(events) -> list:
    """[[name, idle seconds]] of a traced window, largest first: each idle
    gap of the device (reduce_events' gaps) cut where the innermost port
    range open on the window's thread changes, each part under that
    range's name ("zt.<name>"), or where none is open, under the innermost
    harness range's ("host: <name>", "host: outside any span")."""
    window = [e for e in events if e["name"] == tracing.WINDOW and not e["device"]]
    if not window:
        return []
    t0, t1 = min(r["start"] for r in window), max(r["end"] for r in window)
    main = window[0]["thread"]
    ops = [(e["start"], e["end"]) for e in events
           if e["device"] and not e["annotation"] and not e["name"].startswith("bench.")]
    _, gaps = tracing.busy_and_gaps(ops, t0, t1)
    on_main = [e for e in events if not e["device"] and e["thread"] == main]
    port = [e for e in on_main if e["name"].startswith("zt.")]
    harness = [e for e in on_main
               if e["name"].startswith("bench.") and e["name"] != tracing.WINDOW]
    out, rest = defaultdict(float), []
    for s, e, r in split(gaps, segments(port)):
        if r is None:
            rest.append((s, e))
        else:
            out[r["name"]] += (e - s) * 1e-9
    for s, e, r in split(rest, segments(harness)):
        name = r["name"].split(":")[0][6:] if r is not None else "outside any span"
        out["host: " + name] += (e - s) * 1e-9
    return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])]
