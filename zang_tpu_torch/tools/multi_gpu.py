#!/usr/bin/env python3
"""The several-device paths over distinct cards (chip_smoke.py phase 12's
(c) and (d) at every card a machine has).

    python3 zang_tpu_torch/tools/multi_gpu.py

On a machine with two cards or more: builds the kernels, renders the whole
song and poly_echo at 16384 voices x 8 s on cuda:0 (render_performance, the
references), then shards both over 2, 4, ... cards through NCCL, one
process a card (chip_smoke.run_sharded: each rank's voices, kernel,
timelines, plan, slice and render seconds and peak memory; every mix within
-120 dBFS of the reference, the song within the parity budget of its JAX
golden windows, the ranks' bits alike), and runs the 256-lane live fleet on
cuda:0 and with a lane group a card, in turns (chip_smoke.run_lane_fleet).
Prints one JSON line with the card's nvidia-smi name and power limit.
Exits non-zero without two cards.
"""

import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards < 2:
        print(f"multi_gpu: {n_cards} cards; this needs two or more", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from zang_tpu_torch.core import native
    from zang_tpu_torch.graph.render import render_performance
    from zang_tpu_torch.host import configs, song
    from zang_tpu_torch.ops import _build
    from zang_tpu_torch.parallel import make_mesh

    card = cs.smi()
    print(f"{card}; {n_cards} cards; torch {torch.__version__}, CUDA {torch.version.cuda}")
    with ThreadPoolExecutor(4) as pool:
        jobs = [pool.submit(_build.build, s) for s in ("svf_table", "svf_onepass", "svf_dense")]
        jobs.append(pool.submit(native.build))
        for job in jobs:
            job.result()

    t = time.perf_counter()
    total = int(song.NUM_SECONDS * song.SAMPLE_RATE)
    want = {"song": render_performance(song.build_performance(total), total, cs.CHUNK,
                                       device="cuda:0").cpu().numpy()}
    perf, ptotal = configs.build_poly_echo_performance(cs.SHARD_POLY_VOICES,
                                                       cs.SHARD_POLY_SECONDS)
    want[f"poly_echo_{cs.SHARD_POLY_VOICES}"] = render_performance(
        perf, ptotal, cs.CHUNK, device="cuda:0").cpu().numpy()
    del perf
    torch.cuda.empty_cache()
    print(f"references on cuda:0 in {time.perf_counter() - t:.3f}s")
    gold = cs.song_golden()
    out, launches = {"card": card, "cards": n_cards}, {}
    world = 2
    while world <= n_cards:
        tag = f"nccl_{world}"
        out[tag] = cs.run_sharded(card, tag, make_mesh(world), launches, want, gold)
        world *= 2
    out["fleet"] = cs.run_lane_fleet(card, launches,
                                     [f"cuda:{i}" for i in range(n_cards)])
    out["launches"] = launches
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
