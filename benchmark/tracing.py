"""The traced run's device side: torch.profiler over a part of the window,
reduced to what the per-layer readers need.

The reduction reads the profiler's raw events: the device's kernels,
copies and sets (their intervals give the busy time and the idle gaps), the
CUDA runtime calls that launched them (linked by correlation id), and the
harness's record_function ranges "bench.<name>[:<tag>]" on the host. A
device op belongs to the innermost harness range open on the launching
thread when its runtime call was made. The traced window is the range
"bench.window".
"""

from collections import defaultdict

WINDOW = "bench.window"
NAME_CHARS = 160  # a device op's name in the breakdown (templates run to thousands)


def _interval_union(intervals):
    """Sorted, merged [(start, end)]."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def busy_and_gaps(intervals, t0, t1):
    """(busy seconds, [(gap start, gap end)]) of device intervals (ns)
    clipped to the window [t0, t1] (ns)."""
    clipped = [(max(s, t0), min(e, t1)) for s, e in intervals if e > t0 and s < t1]
    merged = _interval_union(clipped)
    busy = sum(e - s for s, e in merged)
    gaps, cur = [], t0
    for s, e in merged:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if cur < t1:
        gaps.append((cur, t1))
    return busy * 1e-9, gaps


def innermost(ranges, queries):
    """For each query time (ns), the innermost range (start <= t <= end) of
    `ranges` open at it, or None. Ranges nest (they are the harness's
    context managers on one thread), so one sweep with a stack of the open
    ones answers every query."""
    marks = [(r["start"], 0, i) for i, r in enumerate(ranges)]
    marks += [(t, 1, j) for j, t in enumerate(queries)]
    marks += [(r["end"], 2, i) for i, r in enumerate(ranges)]
    marks.sort()
    out, stack = [None] * len(queries), []
    for _, kind, k in marks:
        if kind == 0:
            stack.append(k)
        elif kind == 1:
            out[k] = ranges[stack[-1]] if stack else None
        elif stack and stack[-1] == k:
            stack.pop()
        elif k in stack:
            stack.remove(k)
    return out


def reduce_events(events):
    """events: dicts {name, device (bool), start, end (ns), corr, thread,
    annotation (bool)}, the profiler's raw events made plain (a device
    event's corr is a tuple of the ids that may link it to its runtime
    call). Returns the reading the per-layer readers take: the traced
    window's seconds, the device's busy seconds in it, the count of device
    ops, each harness range with the device seconds of the ops it launched,
    and the breakdown of the result line."""
    ranges, device_ops, runtime = [], [], {}
    for e in events:
        if e["annotation"] or e["name"].startswith("bench."):
            if not e["device"] and e["name"].startswith("bench."):
                ranges.append(e)
            continue
        if e["device"]:
            device_ops.append(e)
        elif e["corr"] and e["name"].startswith(("cuda", "cu")):
            runtime[e["corr"]] = e
    window = [r for r in ranges if r["name"] == WINDOW]
    if not window:
        raise ValueError("the trace holds no bench.window range")
    t0, t1 = min(r["start"] for r in window), max(r["end"] for r in window)
    device_ops = [d for d in device_ops if d["end"] > t0 and d["start"] < t1]
    busy, gaps = busy_and_gaps([(d["start"], d["end"]) for d in device_ops], t0, t1)
    harness = [r for r in ranges if r["name"] != WINDOW]
    threads = defaultdict(list)
    for r in harness:
        threads[r["thread"]].append(r)
    per_range = defaultdict(float)  # id(range) -> device seconds
    launched = 0
    queries = defaultdict(list)  # thread -> [(launch time, device op)]
    for d in device_ops:
        rt = next((runtime[c] for c in d["corr"] if c in runtime), None)
        if rt is not None:
            launched += 1
            queries[rt["thread"]].append((rt["start"], d))
    for th, qs in queries.items():
        for r, (_, d) in zip(innermost(threads.get(th, []), [q[0] for q in qs]), qs):
            if r is not None:
                per_range[id(r)] += (d["end"] - d["start"]) * 1e-9
    calls = [{"name": r["name"], "start": r["start"], "end": r["end"],
              "device_s": per_range.get(id(r), 0.0),
              "has_device": id(r) in per_range}
             for r in harness]
    by_op = defaultdict(float)
    for d in device_ops:  # a kernel by its name's first NAME_CHARS characters
        by_op[d["name"][:NAME_CHARS]] += (d["end"] - d["start"]) * 1e-9
    by_gap = defaultdict(float)
    main = window[0]["thread"]
    for (s, e), r in zip(gaps, innermost(threads.get(main, []),
                                         [(s + e) // 2 for s, e in gaps])):
        by_gap["host: " + (r["name"].split(":")[0][6:] if r else "outside any span")] += \
            (e - s) * 1e-9
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {
        "window_s": (t1 - t0) * 1e-9,
        "busy_s": busy,
        "device_ops": len(device_ops),
        "device_ops_linked": launched,
        "runtime_calls": sum(1 for r in runtime.values() if t0 <= r["start"] <= t1),
        "calls": sorted(calls, key=lambda c: c["start"]),
        "breakdown": {"device_ops": top(by_op), "idle_gaps": top(by_gap)},
    }


def _attr(e, name, default=None):
    """A raw event's field, where this torch's profiler has it."""
    f = getattr(e, name, None)
    if f is None:
        return default
    try:
        return f()
    except RuntimeError:  # a field this kind of event does not carry
        return default


def plain_events(prof):
    """The profiler's raw events as reduce_events takes them."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = "CUDA" in str(e.device_type())
        start = e.start_ns()
        corr = _attr(e, "correlation_id", 0)
        out.append({
            "name": e.name(),
            "device": dev,
            "start": start,
            "end": start + e.duration_ns(),
            "corr": (corr, _attr(e, "linked_correlation_id", 0)) if dev else corr,
            "thread": _attr(e, "start_thread_id", 0),
            "annotation": bool(_attr(e, "is_user_annotation", False)),
        })
    return out


class Profiler:
    """torch.profiler (host and device) over a part of the window."""

    def __init__(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=acts)
        self.reading = None

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.reading = reduce_events(plain_events(self.prof))
        return False


# ---------------------------------------------------------------------------
# what the per-layer readers share


def roofline_pct(reading, span: str = "svf"):
    """The bytes of the spanned calls whose device work the trace holds
    ("bench.<span>:<bytes>"), at the peak memory rate, over the device
    seconds of every op those calls launched, in %. None without such a
    call."""
    from benchmark.yardstick import bound_s

    if reading is None:
        return None
    calls = [c for c in reading["calls"]
             if c["name"].startswith(f"bench.{span}:") and c["has_device"]]
    device_s = sum(c["device_s"] for c in calls)
    if not calls or device_s <= 0:
        return None
    n_bytes = sum(int(c["name"].split(":", 1)[1]) for c in calls)
    return 100.0 * bound_s(n_bytes) / device_s


def idle_pct(reading):
    """1 - the device's busy share of the traced window, in %."""
    if reading is None or reading["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - reading["busy_s"] / reading["window_s"])


def mean_span_s(res, name: str):
    xs = res["spans"].seconds(name)
    return sum(xs) / len(xs) if xs else None
