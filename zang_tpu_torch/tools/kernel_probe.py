#!/usr/bin/env python3
"""Read K1 (the table-cut SVF) and two renders of one checkout of the port
on one NVIDIA GPU, so that two checkouts (a change and its parent) can be
read in turns in one call on one card.

    python3 zang_tpu_torch/tools/kernel_probe.py [--root DIR]

DIR is the root of the checkout whose zang_tpu_torch is imported (default:
the one holding this script); the timing helpers are chip_smoke.py's, from
the checkout holding this script. Prints one JSON line, with the card's
nvidia-smi name and power limit:

  k1_render_S  the largest slot count of the tables K1 gets in poly_echo's
               1024-voice x 30 s render (chip_smoke.render_slots)
  k1           K1's device time a launch (torch.profiler), ms: random
               inputs at the song's shape (V = 14 x 65,536, S = 2) and at
               V = 1024 x 65,536 with S = 2, with a random active_from and
               with every sample active; and the arguments of that
               render's chunk 10, captured
  render_s     render_song_s16 (the 385 s song) and the 10 s sampler config
               (render_config_s16), end to end, twice each
"""

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CAPTURED_CHUNK = 10


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
    from zang_tpu_torch.graph.render import render_performance
    from zang_tpu_torch.host import configs, song
    from zang_tpu_torch.ops import _build, filters

    out = {"root": root, "card": cs.smi()}
    with ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(_build.build, s) for s in ("svf_table", "table_lookup")]
        jobs.append(pool.submit(native.build))
        for j in jobs:
            j.result()

    # K1 on a chunk of poly_echo's render, and on random inputs
    out["k1_render_S"] = cs.render_slots(configs, 1024, 30.0)
    perf, total = configs.build_poly_echo_performance(num_voices=1024, seconds=30.0)
    real, captured = filters.svf_filter_table, {}

    def capture(*args, **kw):
        if args[7] == CAPTURED_CHUNK * cs.CHUNK:  # t0 of the chunk
            captured["args"] = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                                     for a in args[:9])
        return real(*args, **kw)

    with mock.patch.object(filters, "svf_filter_table", capture):
        render_performance(perf, total, cs.CHUNK, device="cuda")
    torch.cuda.synchronize()
    del perf
    rng = np.random.default_rng(20261016)
    dev = torch.device("cuda")
    cases = {"song S=2": cs.svf_case(rng, 14, cs.CHUNK, 128, 2, 7 * cs.CHUNK, dev),
             "v1024 S=2": cs.svf_case(rng, 1024, cs.CHUNK, 128, 2, 5 * cs.CHUNK, dev),
             "v1024 S=2 all active": cs.svf_case(rng, 1024, cs.CHUNK, 128, 2, 5 * cs.CHUNK,
                                                 dev, always_active=True),
             f"v1024 render chunk {CAPTURED_CHUNK}": captured["args"]}
    out["k1"] = {label: cs.device_ms(lambda a=a: filters.svf_filter_table(*a),
                                     "svf_table_kernel", 100 if a[2].shape[0] < 64 else 20)
                 for label, a in cases.items()}
    del cases, captured

    renders = {"song": lambda: song.render_song_s16(device="cuda"),
               "sampler": lambda: configs.render_config_s16("sampler", 10.0, device="cuda")}
    out["render_s"] = {}
    for name, fn in renders.items():
        secs = []
        for _ in range(2):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
        out["render_s"][name] = secs
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
