#!/usr/bin/env python3
"""Read the five kernels and a few renders of one checkout of the port on
one NVIDIA GPU, so that two checkouts (a change and its parent) can be read
in turns in one call on one card.

    python3 zang_tpu_torch/tools/kernel_probe.py [--root DIR]

DIR is the root of the checkout whose zang_tpu_torch is imported (default:
the one holding this script); the inputs and timing helpers are
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
               K3 svf_onepass_cuda: V = 4096 x 65,536, S = 2
               K4 sampler_taps: the sampler's two taps of a 65,536 chunk
  host_us    the host's microseconds a call of K5 at fmsynth's shape and K2
             at play's, enqueue only (chip_smoke.host_us)
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
    root = os.path.abspath(p.parse_args().root)
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
        "K3 v4096": ("svf_onepass_kernel", svf_cuda.svf_onepass_cuda,
                     cs.svf_case(rng, 4096, cs.CHUNK, 128, 2, 3 * cs.CHUNK, dev)),
        "K4 sampler": ("lookup_kernel", lookup.sampler_taps, (ia, ib, table, n_drum, True)),
    }
    out["device_ms"] = {}
    for label, (kname, fn, args) in cases.items():
        reps = 20 if "v1024" in label or "v4096" in label else 100
        out["device_ms"][label] = cs.device_ms(lambda fn=fn, a=args: fn(*a), kname, reps)
    out["host_us"] = {label: cs.host_us(lambda fn=cases[label][1], a=cases[label][2]: fn(*a),
                                        reps)
                      for label, reps in (("K5 fmsynth", 50), ("K2 play", 500))}
    del cases

    renders = {"song": lambda: song.render_song_s16(device="cuda"),
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
