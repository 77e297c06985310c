"""A live fleet in an open loop: block k of the window is due at
t0 + k x block / sample rate, whatever the earlier blocks did.

Set-up makes the fleet at the traffic's lane count, draws every lane's
events from the seed, and renders block 0 (the warm block, the cell's one
shape). In the window each block waits for its due time, pushes the events
that fall in it (LiveFleet.push_event, at their frame in the block), renders
(render_block_async, then the copy to the host). A block's latency runs from
its due time to its audio on the host, so a stall counts against every block
it delays; a block that raised never comes. block_p95_ms is the 95th
percentile over the window's blocks.

The traced run wraps the port's dense SVF entry (a span a call, tagged with
its bytes). Once the window has closed it starts the profiler, renders one
settle block (the profiler's first-use work), then a paced stretch of
`trace_blocks` blocks with due times of their own, and stops the profiler:
the traced blocks keep their due times, as the window's do. Their start lag
is reported beside the readings, and a stretch whose median block starts
more than a block's budget late is a backlog, not paced blocks: it refuses
the reading (the run raises). One stall that the stretch recovers from does
not: it is reported (`max`, `late_blocks`). Every lane's
events are drawn for the window and that stretch in every run, so a seed
gives the same inputs traced or not. Once the blocks are done,
`check_lanes` lanes drawn from the seed are held to the reference over
every block rendered, the warm block included.
"""

import math
import sys
import time
from contextlib import nullcontext

import numpy as np

from benchmark import harness, tracing
from benchmark.drivers.offline import compare, wrapped


def blocks_in(seconds: float, block: int, sample_rate: float) -> int:
    return max(1, int(seconds * sample_rate // block))


def blocks_drawn(n: int, traffic: dict) -> int:
    """The blocks whose events a run draws: the warm block, the window's n,
    a settle block and the traced stretch (drawn in every run, traced or
    not, so that a seed gives the same inputs)."""
    return n + 2 + traffic["trace_blocks"]


def run(parts: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
        lanes=None) -> dict:
    import torch

    t_in = time.perf_counter()
    entry, cfg, tr = parts["entry"], parts["config"], parts["traffic"]
    lanes = tr["lanes"] if lanes is None else lanes
    block, sr = tr["block"], cfg["live_sample_rate"]
    n = blocks_in(seconds, block, sr)
    drawn = blocks_drawn(n, tr)
    rng = np.random.default_rng(seed)
    ctx = entry.setup(cfg, tr)
    events = entry.lane_events(ctx, rng, lanes, drawn * block)
    by_block = _by_block(events, block, drawn)
    checked = sorted(np.random.default_rng([seed, 1]).choice(
        lanes, size=min(tr["check_lanes"], lanes), replace=False).tolist())
    fleet = entry.make_fleet(ctx, lanes, device)
    spans = harness.Spans()
    kept = [[] for _ in checked]

    def step(k, spans):
        for lane, part, params, nid, frame in by_block[k]:
            fleet.push_event(lane, part, params, note_id=nid, impulse_frame=frame)
        with spans("enqueue"):
            dev_out = fleet.render_block_async()
        out = dev_out.cpu().numpy()
        for rows, lane in zip(kept, checked):
            rows.append(out[lane].copy())

    budget = block / sr
    failed = 0

    def paced(ks, t0):
        """Blocks ks, block ks[j] due at t0 + j x budget: (due, done, start lag)."""
        nonlocal failed
        due, done, lag = [], [], []
        for j, k in enumerate(ks):
            d = t0 + j * budget
            now = time.perf_counter()
            if now < d:
                time.sleep(d - now)
            lag.append(time.perf_counter() - d)
            due.append(d)
            try:
                step(k, spans)
                done.append(time.perf_counter())
            except Exception as e:  # a block that raised never comes
                failed += 1
                done.append(None)
                print(f"block {k} raised: {e!r}", file=sys.stderr)
        return due, done, lag

    t_inputs = time.perf_counter()
    warm = harness.Spans()
    step(0, warm)  # the warm block's first-use work is set-up's
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    with wrapped(spans, tr["svf_entry"]) if trace else nullcontext():
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        due, done, lag = paced(range(1, n + 1), t0)
        traced_lag = None
        reading = None
        if trace:  # a paced stretch of its own, after the window
            prof = tracing.Profiler().__enter__()
            step(n + 1, harness.Spans())  # settle: the profiler's first-use work
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            spans.profiled = True
            win = spans("window")
            win.__enter__()
            _, _, tlag = paced(range(n + 2, drawn), time.perf_counter())
            win.__exit__(None, None, None)
            spans.profiled = False
            prof.__exit__(None, None, None)
            reading = prof.reading
            traced_lag = _lag_summary(tlag, budget)
    rendered = drawn if trace else n + 1
    lat = harness.open_loop_latencies(due, done)
    q = max(1, len(lag) // 4)
    out = {
        "setup_s": setup_s,
        "setup": harness.setup_parts(t_start, t_in, t_inputs, t0, warm),
        "end_to_end": {"block_p95_ms": harness.percentile(lat, 95) * 1e3},
        "attempted": rendered - 1,
        "failed": failed,
        "spans": spans,
        "counts": {"blocks": n, "blocks_traced": drawn - n - 2 if trace else 0,
                   "lanes": lanes},
        "reading": reading,
        "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                              if torch.cuda.is_available() else 0),
        "latency_ms": [x * 1e3 for x in lat],
        # the lag of a block's start behind its due time, first and last quarter
        "lag_ms": (float(np.mean(lag[:q]) * 1e3), float(np.mean(lag[-q:]) * 1e3)),
    }
    if traced_lag is not None:
        out["trace_lag_ms"] = dict(traced_lag, limit=budget * 1e3)
        if traced_lag["median"] > budget * 1e3:
            raise RuntimeError(
                f"the traced blocks fell behind their due times (median start lag "
                f"{traced_lag['median']:.1f} ms, a block's budget {budget * 1e3:.1f} ms): "
                f"the trace would read a backlog, not paced blocks")
    del fleet
    out["check"] = lambda: check(parts, ctx, events, checked, kept, rendered, block)
    return out


def _lag_summary(lag, budget: float) -> dict:
    """A stretch's start lag in ms: the mean of its first and last quarter,
    the median, the largest, and the blocks that started more than a
    block's budget late."""
    q = max(1, len(lag) // 4)
    return {"first_quarter": float(np.mean(lag[:q]) * 1e3),
            "last_quarter": float(np.mean(lag[-q:]) * 1e3),
            "median": float(np.median(lag) * 1e3), "max": float(np.max(lag) * 1e3),
            "late_blocks": int(sum(x > budget for x in lag))}


def _by_block(events, block: int, blocks: int):
    """[(lane, part, params, note_id, frame in block)] of each block."""
    out = [[] for _ in range(blocks)]
    for lane, evs in enumerate(events):
        for f, nid, freq, on in evs:
            out[f // block].append((lane, 0, {"freq": float(freq), "note_on": bool(on)},
                                    int(nid), int(f % block)))
    return out


def check(parts, ctx, events, checked, kept, rendered, block) -> list:
    """The checked lanes' blocks (all `rendered` of them) against the
    reference: the worst lane's RMS and peak difference in dBFS, each
    against its limit."""
    if not checked or any(len(rows) != rendered for rows in kept):
        return [harness.check("blocks_checked", 0, 1, "higher")]
    worst = None
    for lane, rows in zip(checked, kept):
        got = np.concatenate(rows, axis=-1)[0]
        ref = parts["entry"].lane_reference(ctx, events[lane], got.shape[-1])
        cs = compare(parts["limits"], got, ref)
        worst = cs if worst is None else [
            max(a, b, key=lambda c: c["value"]) for a, b in zip(worst, cs)]
    return worst


def lag_grows(lag_ms, budget_ms: float) -> bool:
    """Whether a block's start fell behind over the window: its mean lag
    in the last quarter above the first quarter's by more than a tenth of a
    block's budget."""
    first, last = lag_ms
    return last - first > 0.1 * budget_ms or math.isinf(last)
