"""The readings a cell's correctness limits are set from, on the card:

    python3 -m benchmark.calibrate --workload NAME --seeds 1,2,... \\
        --control-seeds 7,8,9 [--seconds S]

For each of --seeds, a run of the cell's window (S seconds, default one
job or a few seconds of blocks) and its check against the reference: the
program's readings, whose largest is a limit's lower reading. For each of
--control-seeds, the control: the reference computed in bfloat16 (every
voice's signal rounded before the f32 mix) put in the program's place, at
the cell's size; its smallest reading is the upper one. One JSON line a
reading; the benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time

import numpy as np


def control_readings(parts: dict, seed: int, seconds: float) -> dict:
    from benchmark.drivers.live import blocks_drawn, blocks_in
    from benchmark.drivers.offline import compare

    entry, cfg, tr = parts["entry"], parts["config"], parts["traffic"]
    ctx = entry.setup(cfg, tr)
    rng = np.random.default_rng(seed)
    if tr["driver"] == "offline":
        job = entry.draw_job(ctx, rng)
        ref, _ = entry.reference(ctx, job)
        ctl, _ = entry.reference(ctx, job, "bf16")
        return {c["name"]: c["value"] for c in compare(parts["limits"], ctl, ref)}
    n = blocks_in(seconds, tr["block"], cfg["live_sample_rate"])
    frames = (n + 1) * tr["block"]  # the warm block and the window's
    worst = {}
    lanes = entry.lane_events(ctx, rng, tr["lanes"], blocks_drawn(n, tr) * tr["block"])
    pick = np.random.default_rng([seed, 1]).choice(tr["lanes"], size=tr["check_lanes"],
                                                    replace=False)
    for lane in pick:
        ref = entry.lane_reference(ctx, lanes[lane], frames)
        ctl = entry.lane_reference(ctx, lanes[lane], frames, "bf16")
        for c in compare(parts["limits"], ctl, ref):
            worst[c["name"]] = max(worst.get(c["name"], -1e9), c["value"])
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)

    from benchmark import harness, run

    parts = harness.cell_parts(harness.manifest(), args.workload)
    for i, s in enumerate(x for x in args.seeds.split(",") if x):
        t = time.perf_counter()
        res = run.run_cell(args.workload, int(s), args.seconds, False, "cuda", parts)
        print(json.dumps({"side": "program", "seed": int(s), "correct_now": all(
            c["ok"] for c in res["checks"]) and res["failed"] == 0,
            "readings": {c["name"]: c["value"] for c in res["checks"]},
            "end_to_end": res["end_to_end"], "seconds": time.perf_counter() - t}), flush=True)
        del res
        if i == 0 and parts["traffic"]["driver"] == "offline":
            parts["traffic"] = dict(parts["traffic"], warm_jobs=0)  # the shapes are warm
    for s in (x for x in args.control_seeds.split(",") if x):
        t = time.perf_counter()
        r = control_readings(parts, int(s), args.seconds)
        print(json.dumps({"side": "control", "seed": int(s), "readings": r,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
