"""A cell's traced run taken apart by the port's own spans, on the card:

    python3 -m benchmark.program_trace --workload NAME --seed N [--seconds S]

runs the cell's traced run (benchmark.run's with --trace 1: the profiler
over the same jobs or blocks) keeping the profiler's raw events, prints
its result line, then one JSON line: the idle gaps by harness span (the
result line's) and by port span (program_spans.idle_gaps_program); the
share of the idle under the harness's plan, render and enqueue spans that
a port span holds; and, over the jobs or blocks that hold port spans, each
port span's count, seconds and self seconds, and the share of the chunk
and block spans that their children cover. The benchmark's own runs never
run this.
"""

import argparse
import json
import sys
from collections import defaultdict

HOST_SPANS = ("plan", "render", "enqueue")


def port_share(events, names=HOST_SPANS) -> dict:
    """The idle seconds of the traced window inside the harness spans
    `names`, and the share of them that a port range on the window's
    thread holds."""
    from benchmark import program_spans as ps
    from benchmark import tracing

    window = [e for e in events if e["name"] == tracing.WINDOW and not e["device"]]
    t0, t1 = min(r["start"] for r in window), max(r["end"] for r in window)
    main = window[0]["thread"]
    ops = [(e["start"], e["end"]) for e in events
           if e["device"] and not e["annotation"] and not e["name"].startswith("bench.")]
    _, gaps = tracing.busy_and_gaps(ops, t0, t1)
    host = [e for e in events if not e["device"] and e["thread"] == main
            and e["name"].startswith("bench.") and e["name"][6:] in names]
    port = [e for e in events if not e["device"] and e["thread"] == main
            and e["name"].startswith("zt.")]
    inside = [(s, e) for s, e, r in ps.split(gaps, ps.segments(host)) if r is not None]
    held = sum(e - s for s, e, r in ps.split(inside, ps.segments(port)) if r is not None)
    total = sum(e - s for s, e in inside)
    return {"idle_s": total * 1e-9, "held_by_port_span": held / total if total else None}


def span_table(recs) -> dict:
    """{name: [count, seconds, self seconds]} and {parent name: the share of
    its seconds its children cover} over port records."""
    from zang_tpu_torch import trace

    own = trace.self_ns(recs)
    table = defaultdict(lambda: [0, 0.0, 0.0])
    for r in recs:
        row = table[r.name]
        row[0] += 1
        row[1] += (r.t1 - r.t0) * 1e-9
        row[2] += own[r.id] * 1e-9
    covered = {name: 1.0 - row[2] / row[1] for name, row in table.items()
               if name in ("chunk", "block") and row[1] > 0}
    return dict(table), covered


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=45.0)
    args = ap.parse_args(argv)

    from benchmark import harness, program_spans, run, tracing

    parts = harness.cell_parts(harness.manifest(), args.workload)
    kept = []
    plain = tracing.plain_events

    def keep(prof):
        kept.append(plain(prof))
        return kept[-1]

    tracing.plain_events = keep
    try:
        res = run.run_cell(args.workload, args.seed, args.seconds, True, "cuda", parts)
    finally:
        tracing.plain_events = plain
    _, line = run.result(res, True, parts["workload"]["chips"])
    print(line, flush=True)
    events = kept[-1]
    row = "job" if parts["traffic"]["driver"] == "offline" else "enqueue"
    rows = program_spans.chosen_rows(res, row, program_spans.port_trace().records())
    table, covered = span_table([r for _, _, inside in rows for r in inside])
    print(json.dumps({
        "idle_gaps": res["reading"]["breakdown"]["idle_gaps"],
        "idle_gaps_program": program_spans.idle_gaps_program(events),
        "host_idle": port_share(events), "spans": table, "children_cover": covered,
        "rows": len(rows), "dropped": program_spans.port_trace().dropped(),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
