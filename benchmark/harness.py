"""What every cell shares: the manifest and the files found by name, the
spans the harness records around the program's calls, the statistics of
the end-to-end metrics, the check that no JAX module was loaded, and the
result line.

A cell is an entry of BENCHMARK.json's `workloads`: a configuration
(benchmark/configs/<config>.json, whose `entry` names the module in
benchmark/entries/ that drives the port and the reference for it), a
traffic mix (benchmark/traffic/<traffic>.json, whose `driver` names the
module in benchmark/drivers/ that runs the window) and the correctness
limits (benchmark/limits/<cell>.json). A per-layer metric is the reader
benchmark/metrics/<metric>.py. Nothing here names a cell.
"""

import importlib.util
import json
import math
import os
import sys
import time
from contextlib import contextmanager

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")
# top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "zang_tpu")


def manifest(path: str = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"({', '.join(w['name'] for w in man['workloads'])})")


def load_json(kind: str, name: str) -> dict:
    """benchmark/<kind>/<name>.json."""
    with open(os.path.join(BENCH_DIR, kind, name + ".json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py, loaded by its path (metric names hold
    dots, so they are no package names)."""
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_parts(man: dict, name: str) -> dict:
    """Everything one cell reads, found by the names in its entry."""
    w = workload(man, name)
    config = load_json("configs", w["config"])
    traffic = load_json("traffic", w["traffic"])
    return {
        "workload": w,
        "config": config,
        "traffic": traffic,
        "limits": load_json("limits", w["name"]),
        "entry": load_module("entries", config["entry"]),
        "driver": load_module("drivers", traffic["driver"]),
        "end_to_end": [m for m in man["end_to_end"]
                       if name in m.get("workloads", [name])],
        "per_layer": [m for m in man["per_layer"]
                      if name in m.get("workloads", [name])],
    }


def forbidden_modules(names=None) -> list:
    """The loaded modules whose top-level name (the part before the first
    dot, whole) is one of FORBIDDEN."""
    names = sys.modules.keys() if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


# ---------------------------------------------------------------------------
# spans


class Spans:
    """Host-clock spans the harness records around the program's calls.
    With `profiled` set (the traced run), each span is also a
    torch.profiler.record_function range named "bench.<name>[:<tag>]", so
    the trace's device work can be attributed to it."""

    def __init__(self) -> None:
        self.records = []  # (name, t0, t1, profiled)
        self.profiled = False

    @contextmanager
    def __call__(self, name: str, tag=None):
        rf = None
        if self.profiled:
            from torch.profiler import record_function

            rf = record_function(f"bench.{name}" + ("" if tag is None else f":{tag}"))
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if rf is not None:
                rf.__exit__(None, None, None)
            self.records.append((name, t0, t1, self.profiled))

    def seconds(self, name: str) -> list:
        """Durations of the spans `name`: those recorded with the profiler
        off when there are any (the profiler slows the host), else all."""
        rows = [r for r in self.records if r[0] == name]
        if any(not r[3] for r in rows):
            rows = [r for r in rows if not r[3]]
        return [t1 - t0 for _, t0, t1, _ in rows]


# ---------------------------------------------------------------------------
# set-up, part by part


def setup_parts(t_start: float, t_in: float, t_inputs: float, t0: float, warm: Spans) -> dict:
    """setup_s taken apart: the imports and the look for a card (process
    start to the driver), the inputs (the driver to the first warm-up), the
    warm-up (one job or block at the cell's shapes) and its harness spans,
    and the seconds the port's nvcc and g++ builds took in it, as the port
    counts them (zang_tpu_torch/ops/_build.build_seconds: 0.0 a library
    found built). `cold` is a run that built: a checkout's first."""
    build = sys.modules.get("zang_tpu_torch.ops._build")
    built = dict(getattr(build, "build_seconds", {}))
    warm_spans = {}
    for name, a, b, _ in warm.records:
        warm_spans[name] = warm_spans.get(name, 0.0) + (b - a)
    return {"import_s": t_in - t_start, "inputs_s": t_inputs - t_in,
            "warm_s": t0 - t_inputs, "warm_spans_s": warm_spans,
            "build_s": float(sum(built.values())), "cold": any(v > 0 for v in built.values())}


# ---------------------------------------------------------------------------
# statistics of the end-to-end metrics


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100), linear between order statistics (numpy's
    default); an infinite value (a block that never came) sorts last."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    if xs[hi] == math.inf:
        return math.inf if pos > lo or xs[lo] == math.inf else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def closed_loop_rate(job_ends, job_audio_s, t0: float) -> float:
    """Audio seconds a wall second over a closed loop of jobs: every job's
    audio, over the time from the window's start to the end of its last
    job (the one running when the window's seconds ran out, finished, so no
    job is cut and none counted in part)."""
    if not job_ends:
        raise ValueError("no job finished in the window")
    return sum(job_audio_s) / (max(job_ends) - t0)


def open_loop_latencies(due, done) -> list:
    """Each block's seconds from its due time to its audio on the host; a
    block that never came (done None) is infinitely late."""
    return [math.inf if d is None else d - t for t, d in zip(due, done)]


# ---------------------------------------------------------------------------
# the result line


def check(name: str, value: float, limit: float, better: str = "lower") -> dict:
    ok = value <= limit if better == "lower" else value >= limit
    return {"name": name, "value": value, "limit": limit, "ok": bool(ok)}


def result_line(correct, attempted, failed, metrics, device, checks, breakdown=None,
                extra=None) -> str:
    """The contract's JSON line; keys of the harness's own (`extra`: the
    set-up's parts, a traced stretch's lag) after the contract's, and the
    compared numbers under `checks`, last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out.update(extra or {})
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return json.dumps(out)


def checks_text(checks) -> str:
    return "\n".join(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
                     f"{'ok' if c['ok'] else 'FAILED'}" for c in checks)
