#!/usr/bin/env python3
"""Read the five kernels and a few renders of one checkout of the port on
one NVIDIA GPU, so that two checkouts (a change and its parent) can be read
in turns in one call on one card.

    python3 zang_tpu_torch/tools/kernel_probe.py [--root DIR] [--only TEXT ...]
                                                 [--no-renders]

DIR is the root of the checkout whose zang_tpu_torch is imported (default:
the one holding this script); --only keeps the kernel rows whose label
holds one of the TEXTs (and the host rows among them), --no-renders skips
the renders. The inputs and timing helpers are
chip_smoke.py's, from the checkout holding this script, and every kernel is
called through the entry that both checkouts have. Prints one JSON line,
with the card's nvidia-smi name and power limit:

  device_ms  each kernel's device time a launch (torch.profiler), ms, on
             random inputs made from one seed:
               K5 fm_feedback, waveform 0, feedback pi/4: the fmsynth
                  example's V = 8 x 16,384 and V = 1024 x 16,384
               K2 svf_filter: play's shape (V = 1 x 16,384, scalar cutoff,
                  mask), stereo's (V = 2, [2, 1] cutoff), detuned's two
                  calls, and V = 1024 x 65,536 with a dense cutoff and mask
               K1 svf_filter_table: the song's shape (V = 14 x 65,536,
                  S = 2) and V = 1024 x 65,536
               K3 svf_onepass_cuda: V = 2048, 3072, 4096, 8192 and 16384 x
                  65,536, S = 2 (16384 written over its input, as the
                  render calls it), and beside it at 2048-8192 K1 called by
                  name (svf_table_cuda) on the same inputs: where the two
                  cross
               K4 sampler_taps: the sampler's two taps of a 65,536 chunk
               K4 sampler_play: the fused entry, the sampler config's
                  second chunk of 65,536 from its tiled program (skipped in
                  a checkout without it)
  host_us    the host's microseconds a call of K5 at fmsynth's shape, K2
             at play's and K4 sampler_play's, enqueue only
             (chip_smoke.host_us)
  render_s   end to end, three times each: render_song_s16 (the 385 s
             song), the 10 s sampler config, and the fmsynth, play, stereo
             and detuned examples
"""

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=HERE)
    p.add_argument("--only", nargs="+", help="kernel rows whose label holds one of these")
    p.add_argument("--no-renders", action="store_true")
    args = p.parse_args()
    root = os.path.abspath(args.root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_probe: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    sys.path.insert(0, root)
    import zang_tpu_torch

    if not os.path.abspath(zang_tpu_torch.__file__).startswith(root + os.sep):
        print(f"kernel_probe: imported {zang_tpu_torch.__file__}, not from {root}",
              file=sys.stderr)
        return 1
    from zang_tpu_torch.core import native
    from zang_tpu_torch.host import configs, examples, song
    from zang_tpu_torch.ops import _build, filters, fm, lookup, svf_cuda
    from zang_tpu_torch.ops import sampler as sampler_ops

    out = {"root": root, "card": cs.smi()}
    stems = ("svf_table", "svf_dense", "svf_onepass", "table_lookup", "fm_feedback")
    with ThreadPoolExecutor(6) as pool:
        jobs = [pool.submit(_build.build, s) for s in stems]
        jobs.append(pool.submit(native.build))
        for j in jobs:
            j.result()

    rng = np.random.default_rng(20261017)
    dev = torch.device("cuda")
    ex = examples.DEFAULT_CHUNK
    fm_args = lambda c: (c["base"], cs.FB, 0, c["fb1"], c["fb2"])
    cut = lambda f: filters.cutoff_from_frequency(f, 48000.0)
    n_drum = configs.SamplerInstrument().table.num_samples
    ia, ib, table = cs.taps_case(rng, n_drum, cs.CHUNK, dev, -n_drum, 2 * n_drum)
    cases = {
        "K5 fmsynth": ("fm_feedback_kernel", fm.fm_feedback,
                       fm_args(cs.fm_case(rng, 8, ex, dev))),
        "K5 v1024": ("fm_feedback_kernel", fm.fm_feedback,
                     fm_args(cs.fm_case(rng, 1024, ex, dev))),
        "K2 play": ("svf_dense_kernel", filters.svf_filter,
                    cs.dense_case(rng, 1, ex, "scalar", True, dev)),
        "K2 stereo": ("svf_dense_kernel", filters.svf_filter,
                      cs.dense_case(rng, 2, ex, "column", False, dev, res=0.4)),
        "K2 detuned warble": ("svf_dense_kernel", filters.svf_filter,
                              cs.dense_case(rng, 2, ex, "scalar", False, dev, res=0.0,
                                            scalar_cut=cut(4.0))),
        "K2 detuned voice": ("svf_dense_kernel", filters.svf_filter,
                             cs.dense_case(rng, 2, ex, "scalar", True, dev,
                                           scalar_cut=cut(7040.0))),
        "K2 v1024": ("svf_dense_kernel", filters.svf_filter,
                     cs.dense_case(rng, 1024, cs.CHUNK, "dense", True, dev)),
        "K1 song": ("svf_table_kernel", filters.svf_filter_table,
                    cs.svf_case(rng, 14, cs.CHUNK, 128, 2, 7 * cs.CHUNK, dev)),
        "K1 v1024": ("svf_table_kernel", filters.svf_filter_table,
                     cs.svf_case(rng, 1024, cs.CHUNK, 128, 2, 5 * cs.CHUNK, dev)),
        "K3 v16384": ("svf_onepass_kernel", lambda *a: svf_cuda.svf_onepass_cuda(*a, out=a[2]),
                      cs.svf_case(rng, 16384, cs.CHUNK, 128, 2, 3 * cs.CHUNK, dev)),
        "K4 sampler": ("lookup_kernel", lookup.sampler_taps, (ia, ib, table, n_drum, True)),
    }
    for V in (2048, 3072, 4096, 8192):  # K3 and K1 by name on the same inputs
        a = cs.svf_case(rng, V, cs.CHUNK, 128, 2, 3 * cs.CHUNK, dev)
        cases[f"K3 v{V}"] = ("svf_onepass_kernel", svf_cuda.svf_onepass_cuda, a)
        cases[f"K1 by name v{V}"] = ("svf_table_kernel", svf_cuda.svf_table_cuda, a)
    if hasattr(sampler_ops, "sampler_play"):
        xs, data, N, ratio, loop = cs.play_programs(configs, "config", cs.CHUNK)
        prog = {k: torch.from_numpy(v[1]).to(dev) for k, v in xs.items()}
        t_idx = torch.arange(cs.CHUNK, 2 * cs.CHUNK, dtype=torch.int32, device=dev)
        cases["K4 sampler_play"] = ("sampler_play_kernel", sampler_ops.sampler_play,
                                    (prog, t_idx, torch.from_numpy(data).to(dev), N, ratio,
                                     loop))
    if args.only:
        cases = {k: v for k, v in cases.items() if any(t in k for t in args.only)}
    out["device_ms"] = {}
    for label, (kname, fn, args_) in cases.items():
        size = label.split()[-1]  # "v<V>" for the large shapes
        reps = 10 if size == "v16384" else 20 if size.startswith("v") else 100
        out["device_ms"][label] = cs.device_ms(lambda fn=fn, a=args_: fn(*a), kname, reps)
    out["host_us"] = {label: cs.host_us(lambda fn=cases[label][1], a=cases[label][2]: fn(*a),
                                        reps)
                      for label, reps in (("K5 fmsynth", 50), ("K2 play", 500),
                                          ("K4 sampler_play", 500)) if label in cases}
    del cases

    renders = {} if args.no_renders else {
        "song": lambda: song.render_song_s16(device="cuda"),
        "sampler": lambda: configs.render_config_s16("sampler", 10.0, device="cuda"),
        **{f"ex_{name}": (lambda name=name: examples.EXAMPLES[name](device="cuda"))
           for name in ("fmsynth", "play", "stereo", "detuned")}}
    out["render_s"] = {}
    for name, fn in renders.items():
        secs = []
        for _ in range(3):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
        out["render_s"][name] = secs
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
