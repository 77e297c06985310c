"""The live fleet's knee, swept once on the card:

    python3 -m benchmark.sweep --workload nice_voices.live_fleet \\
        --lanes 64,80,96,... --seconds 20 --seed N

runs the cell's window at each lane count in turn (one process, a fleet
each) and prints a JSON line each: block_p95_ms, the median block, the lag
of a block's start behind its due time in the window's first and last
quarter, and whether that lag grew. The knee is the highest lane count at
which block_p95_ms is within the block's budget and the lag does not grow;
the cell's traffic file takes four fifths of it, rounded down to a multiple
of 16. The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--lanes", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    from benchmark import harness
    from benchmark.drivers import live

    parts = harness.cell_parts(harness.manifest(), args.workload)
    tr, cfg = parts["traffic"], parts["config"]
    budget_ms = 1e3 * tr["block"] / cfg["live_sample_rate"]
    for lanes in (int(x) for x in args.lanes.split(",")):
        t = time.perf_counter()
        res = live.run(parts, args.seed, args.seconds, False, "cuda", t, lanes=lanes)
        lat = res["latency_ms"]
        enq = res["spans"].seconds("enqueue")
        p95 = res["end_to_end"]["block_p95_ms"]
        print(json.dumps({
            "lanes": lanes, "block_p95_ms": p95, "median_ms": float(np.median(lat)),
            "lag_ms": res["lag_ms"], "lag_grows": live.lag_grows(res["lag_ms"], budget_ms),
            "within": p95 <= budget_ms and not live.lag_grows(res["lag_ms"], budget_ms),
            "enqueue_ms": 1e3 * float(np.mean(enq)), "failed": res["failed"],
            "blocks": len(lat), "setup_s": res["setup_s"]}), flush=True)
        del res
    return 0


if __name__ == "__main__":
    sys.exit(main())
