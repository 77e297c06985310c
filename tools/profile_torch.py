"""Where the time goes in the port's renders on one GPU.

For each config named (song, sampler, poly_echo; all three by default;
poly_echo_4096 and poly_echo_16384 are poly_echo at that many voices x 8 s,
the JAX package's capacity sizes; song_flat is the song at a 65,000-frame
chunk, the flat chunk format; midi_toccata and midi_mixed are
zang_tpu_torch/data/toccata.mid through render_midi's planning and chunk,
with the nice instrument, and with pmosc, filteredsaw and weirdsquare over
60 s; midi_script is the whole file with the zangscript instrument
zang_tpu_torch/data/demo_synth.txt:DemoSynth on every part), example
(ex_<name>, an entry of zang_tpu_torch/host/examples.py EXAMPLES at its
default seconds) or live cell (live_session: a LiveSession of zang-serve's
default spec, NiceInstrument(0.3) at polyphony 4, block 1024, fed the
Toccata's first 10 s, host/song.live_events; live_fleet_<L>: a LiveFleet
of L such lanes at block 4096, lane l transposed by l % 12 semitones; a
live cell's "chunk" is a block and its render includes the host halves)
it plans, renders once to warm up, renders again
with the host clock (ending in torch.cuda.synchronize()), then renders a
third time under torch.profiler and prints, per config:

  - plan seconds, render seconds and render-only RTF (an example's ex_*
    entry plans inside its render: its render time includes planning);
  - device time: the sum of the kernels' and copies' self device time in
    the profiled render, and its share of the unprofiled render's wall
    time (the device's busy share; one stream, so nothing overlaps);
  - launches a chunk (kernels and copies the profiler saw);
  - the top rows by self device time, with calls and time per call.

Run from the repo root on a machine with CUDA:

    python tools/profile_torch.py [song] [sampler] [poly_echo] [poly_echo_16384]
                                  [song_flat] [midi_toccata] [midi_script]
                                  [ex_fmsynth ...] [live_session] [live_fleet_64 ...]
                                  [--top N]

The card's nvidia-smi name and power limit are printed first; the last line
is one JSON object with the numbers above.
"""

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CHUNK = 65536
LARGE_POLY = {"poly_echo_4096": 4096, "poly_echo_16384": 16384}
LARGE_POLY_SECONDS = 8.0
SONG_FLAT_CHUNK = 65000
MIDI_FILE = os.path.join(ROOT, "zang_tpu_torch", "data", "toccata.mid")
MIDI = {"midi_toccata": (("nice",), None), "midi_mixed": (("pmosc", "filteredsaw",
                                                           "weirdsquare"), 60.0),
        "midi_script": ((os.path.join(ROOT, "zang_tpu_torch", "data",
                                      "demo_synth.txt:DemoSynth"),), None)}
LIVE_SECONDS = 10.0
LIVE = {"live_session": (1, 1024), "live_fleet_4": (4, 4096), "live_fleet_64": (64, 4096),
        "live_fleet_256": (256, 4096)}


def live_runner(lanes: int, block: int, seconds: float = LIVE_SECONDS, device="cuda",
                mesh=None):
    """render() drives a fresh LiveSession (lanes 1) or LiveFleet of NiceInstrument(0.3)
    at polyphony 4 through `seconds` of host/song.live_events (lane l transposed by
    l % 12), a NoteTracker a lane, and returns the blocks [L, C, frames] (numpy), the
    seconds of each block in `times` (render's attribute). mesh: the fleet's lanes
    in a group a device of this parallel.Mesh."""
    import numpy as np

    from zang_tpu_torch.core.notes import NoteTracker
    from zang_tpu_torch.host import instruments as ti
    from zang_tpu_torch.host.live import LiveSession, push_tracked
    from zang_tpu_torch.host.song import SAMPLE_RATE, live_events
    from zang_tpu_torch.serve.live import LiveFleet

    sr = SAMPLE_RATE
    n_blocks = -(-int(seconds * sr) // block)
    parts = lambda: [(ti.NiceInstrument(0.3), 4)]  # noqa: E731

    def render():
        trackers = [NoteTracker(live_events(seconds, transpose=lane % 12))
                    for lane in range(lanes)]
        if lanes == 1:
            s = LiveSession(parts(), sr, block, device=device)
            pushes = [lambda params, **kw: s.push_event(0, params, **kw)]
            step = lambda: s.render_block()[None]  # noqa: E731
        else:
            fleet = LiveFleet(parts, lanes, sr, block_size=block, device=device,
                              mesh=mesh)
            pushes = [lambda params, lane=lane, **kw: fleet.push_event(lane, 0, params, **kw)
                      for lane in range(lanes)]
            step = fleet.render_block
        out, render.times = [], []
        for _ in range(n_blocks):
            t = time.perf_counter()
            for push, tr in zip(pushes, trackers):
                push_tracked(push, tr, sr, block)
            out.append(step())
            render.times.append(time.perf_counter() - t)
        return np.concatenate(out, axis=-1)

    return render, n_blocks


def _runner(name):
    """(render, seconds, chunks, plan seconds, slice seconds): render()
    renders `name` on the card. An example's render plans too, so its plan
    seconds are 0. Slice seconds: the host's share of a config's render
    that prepares the programs' per-chunk tiles (Performance.chunk_xs,
    which render_performance runs before its first chunk), timed alone."""
    from zang_tpu_torch.graph.render import render_performance
    from zang_tpu_torch.host import configs, examples, midi, song

    if name in LIVE:
        render, n_blocks = live_runner(*LIVE[name])
        return render, n_blocks * LIVE[name][1] / song.SAMPLE_RATE, n_blocks, 0.0, None
    if name.startswith("ex_"):
        fn = examples.EXAMPLES[name[3:]]
        seconds = inspect.signature(fn).parameters["seconds"].default
        chunk = examples.SONG_CHUNK if name == "ex_song" else examples.DEFAULT_CHUNK
        frames = fn(seconds=seconds, device="cuda")[0].shape[-1]
        return lambda: fn(device="cuda"), seconds, -(-frames // chunk), 0.0, None
    t = time.perf_counter()
    chunk = CHUNK
    if name in ("song", "song_flat"):
        total = int(song.NUM_SECONDS * song.SAMPLE_RATE)
        perf, seconds = song.build_performance(total), song.NUM_SECONDS
        chunk = SONG_FLAT_CHUNK if name == "song_flat" else CHUNK
    elif name in MIDI:
        names, cap = MIDI[name]
        makers = [midi._instrument_maker(n) for n in names]
        with open(MIDI_FILE, "rb") as f:
            perf, total = midi.midi_performance(
                f.read(), lambda pi, label: makers[pi % len(makers)](), seconds=cap)
        seconds, chunk = total / perf.sample_rate, midi.midi_chunk(total)
    elif name in LARGE_POLY:
        seconds = LARGE_POLY_SECONDS
        perf, total = configs.build_poly_echo_performance(num_voices=LARGE_POLY[name],
                                                          seconds=seconds)
    else:
        perf, total = (configs.build_sampler_performance() if name == "sampler"
                       else configs.build_poly_echo_performance())
        seconds = configs.DEFAULT_SECONDS[name]
    plan_s = time.perf_counter() - t
    t = time.perf_counter()
    perf.chunk_xs(total, chunk)
    slice_s = time.perf_counter() - t
    return (lambda: render_performance(perf, total, chunk, device="cuda"), seconds,
            -(-total // chunk), plan_s, slice_s)


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile(name, top):
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    render, seconds, n_chunks, plan_s, slice_s = _runner(name)
    render()  # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    render()
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        render()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if _device_us(e) > 0
            and str(e.device_type).endswith("CUDA")]
    rows.sort(key=_device_us, reverse=True)
    device_us = sum(_device_us(e) for e in rows)
    calls = sum(e.count for e in rows)
    sliced = "" if slice_s is None else f", {slice_s:.3f}s of it slicing programs on the host"
    print(f"{name}: {n_chunks} chunks; plan {plan_s:.3f}s, render {render_s:.3f}s "
          f"(RTF {seconds / render_s:.1f}, render only{sliced}); device time "
          f"{device_us / 1e3:.1f} ms = {100 * device_us / 1e6 / render_s:.1f} % of the "
          f"render's wall; {calls / n_chunks:.0f} device launches and copies a chunk")
    top_rows = []
    for e in rows[:top]:
        us = _device_us(e)
        top_rows.append({"name": e.key[:90], "calls": e.count, "device_ms": us / 1e3,
                         "share": us / device_us, "us_per_call": us / e.count})
        print(f"  {100 * us / device_us:5.1f} %  {us / 1e3:9.3f} ms  {e.count:7d} calls  "
              f"{us / e.count:9.2f} us/call  {e.key[:90]}")
    return {"chunks": n_chunks, "plan_s": plan_s, "slice_s": slice_s, "render_s": render_s,
            "rtf_render": seconds / render_s, "device_ms": device_us / 1e3,
            "busy_share": device_us / 1e6 / render_s,
            "launches_per_chunk": calls / n_chunks, "top": top_rows}


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    from zang_tpu_torch.host.examples import EXAMPLES

    ap.add_argument("configs", nargs="*",
                    choices=["song", "sampler", "poly_echo", *LARGE_POLY, "song_flat", *MIDI,
                             *LIVE] + [f"ex_{n}" for n in EXAMPLES],
                    help="default: song, sampler and poly_echo")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    out = {"card": card}
    for name in args.configs or ["song", "sampler", "poly_echo"]:
        out[name] = profile(name, args.top)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
