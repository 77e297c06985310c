"""Run one cell of BENCHMARK.json once on the card and print its result line.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

from the repository root. Set-up runs from process start to the window's
start (setup_s); the window measures for S seconds; with --trace 1 the
per-layer metrics replace the end-to-end ones. Once the window has closed
and the device's peak memory has been read, the reference judges the
window's output; every number compared is printed beside its limit, on
standard error (last lines) and in the result line (its last key).

Exits non-zero with no result line when there is no card or fewer cards
than the cell asks for, and when a module of jax, jaxlib, flax or zang_tpu
(compared by whole top-level name) was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def device_info(count: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count}


def per_layer(parts: dict, res: dict) -> dict:
    """Each per-layer metric of the cell whose reader found something."""
    from benchmark import harness

    out = {}
    for m in parts["per_layer"]:
        v = harness.load_module("metrics", m["name"]).read(res)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             parts=None) -> dict:
    """One run of the cell: the driver's window, then the check. parts
    (harness.cell_parts) may be given with overrides; the tests run a cell
    on the CPU this way, past the look for a card."""
    from benchmark import harness

    parts = harness.cell_parts(harness.manifest(), name) if parts is None else parts
    res = parts["driver"].run(parts, seed, seconds, trace, device, T_START)
    # the program's state is the driver's; what it holds on the card goes
    # before the reference runs on the host
    if device != "cpu":
        import torch

        torch.cuda.empty_cache()
    res["checks"] = res.pop("check")()
    res["parts"] = parts
    return res


def result(res: dict, trace: bool, count: int, device_kind=None) -> tuple:
    """(correct, the result line)."""
    from benchmark import harness

    parts = res["parts"]
    checks = res["checks"]
    correct = res["failed"] == 0 and all(c["ok"] for c in checks)
    device = device_kind or device_info(count)
    device["memory_peak_bytes"] = int(res["memory_peak_bytes"])
    breakdown = None
    if trace:
        metrics = per_layer(parts, res)
        r = res["reading"]
        device["busy_s"] = r["busy_s"] if r else 0.0
        device["window_s"] = r["window_s"] if r else 0.0
        breakdown = r["breakdown"] if r else None
    else:
        metrics = {}
        for m in parts["end_to_end"]:
            v = res["setup_s"] if m["name"] == "setup_s" else res["end_to_end"][m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    extra = {k: res[k] for k in ("setup", "trace_lag_ms") if k in res}
    return correct, harness.result_line(correct, res["attempted"], res["failed"], metrics,
                                        device, checks, breakdown, extra)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness

    parts = harness.cell_parts(harness.manifest(), args.workload)
    chips = parts["workload"]["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell asks for {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    import zang_tpu_torch  # noqa: F401 — the system under test: a checkout without it stops here

    res = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", parts)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: modules of a JAX package were loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    r = res["reading"]
    if r is not None:
        print(f"# trace: {json.dumps({k: r[k] for k in ('window_s', 'busy_s', 'device_ops', 'device_ops_linked', 'runtime_calls')})}",
              file=sys.stderr)
    if "lag_ms" in res:
        print(f"# lag_ms: {res['lag_ms']}", file=sys.stderr)
    if "trace_lag_ms" in res:
        print(f"# trace_lag_ms: {json.dumps(res['trace_lag_ms'])}", file=sys.stderr)
    print(f"# setup: {json.dumps(res['setup'])}", file=sys.stderr)
    print(f"# counts: {json.dumps(res['counts'])}", file=sys.stderr)
    correct, line = result(res, bool(args.trace), chips)
    print(harness.checks_text(res["checks"]), file=sys.stderr)
    sys.stderr.flush()
    print(line)
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
