#!/usr/bin/env python3
"""How the batch fleet's throughput on one card depends on its worker threads.

    python3 zang_tpu_torch/tools/batch_workers.py [--songs 4] [--seconds 385]

Renders `songs` copies of the Toccata through one
BatchRenderer(out_dir=..., devices=["cuda:0"]) (s16 WAVs, as chip_smoke.py
phase 11 does) in each of these ways:

  w1, w2, w4   1, 2 or 4 worker threads on the device's default stream
  w4_streams   4 workers, each rendering its jobs on a CUDA stream of its own
  w4_switch    4 workers with the interpreter's GIL switch interval at
               0.1 ms (sys.setswitchinterval) instead of its default 5 ms

after each renderer's shared step is built on the default stream and one
warm-up run each, in two rounds, the second in reverse order. Every run's
WAVs must equal the first run's byte for byte. Prints one JSON line: each
way's walls and fleet RTF (audio seconds / wall), with the card's
nvidia-smi name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--songs", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=385.0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("batch_workers: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from zang_tpu_torch.host import song
    from zang_tpu_torch.serve.batch import BatchRenderer, RenderJob, _split_programs

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    total = int(args.seconds * song.SAMPLE_RATE)
    jobs = [RenderJob(f"toccata_{i}", lambda: (song.build_performance(total), total),
                      volume=song.MIX_VOLUME) for i in range(args.songs)]
    local = threading.local()

    class StreamPerWorker(BatchRenderer):
        def _render_one(self, job, dev):
            if not hasattr(local, "stream"):
                local.stream = torch.cuda.Stream(dev)
            with torch.cuda.stream(local.stream):
                res = super()._render_one(job, dev)
            local.stream.synchronize()
            return res

    with tempfile.TemporaryDirectory() as tmp:
        ways = {"w1": (BatchRenderer, 1, None), "w2": (BatchRenderer, 2, None),
                "w4": (BatchRenderer, 4, None), "w4_streams": (StreamPerWorker, 4, None),
                "w4_switch": (BatchRenderer, 4, 1e-4)}
        renderers = {name: cls(out_dir=os.path.join(tmp, name), devices=["cuda:0"],
                               workers_per_device=w)
                     for name, (cls, w, _) in ways.items()}
        walls = {name: [] for name in ways}
        want = None
        # build each renderer's shared step on the default stream and let
        # its uploads finish, so a worker on a stream of its own never reads
        # them half copied
        perf, _ = jobs[0].build()
        skeleton = _split_programs(perf.programs)[0]
        for br in renderers.values():
            br.cache.get(perf, skeleton, br.chunk_size, br.segment_chunks, "s16",
                         device="cuda:0")
        torch.cuda.synchronize()

        def run(name):
            nonlocal want
            br, switch = renderers[name], ways[name][2]
            default = sys.getswitchinterval()
            if switch is not None:
                sys.setswitchinterval(switch)
            try:
                torch.cuda.synchronize()
                t = time.perf_counter()
                results = br.run(jobs)
                wall = time.perf_counter() - t
            finally:
                sys.setswitchinterval(default)
            bad = [(r.name, r.error) for r in results if r.status != "ok"]
            if bad:
                raise AssertionError(f"{name}: {bad}")
            wavs = []
            for r in results:
                with open(r.wav_path, "rb") as f:
                    wavs.append(f.read())
            if want is None:
                want = wavs
            elif wavs != want:
                raise AssertionError(f"{name}: the WAVs differ from the first run's")
            return wall

        for name in ways:  # warm: kernels, the step and its uploads
            run(name)
        torch.cuda.synchronize()
        order = list(ways)
        for names in (order, order[::-1]):
            for name in names:
                walls[name].append(run(name))
                print(f"{name}: {walls[name][-1]:.3f} s for {args.songs} x "
                      f"{args.seconds:g} s [{card}]", flush=True)
    audio = args.songs * args.seconds
    print(json.dumps({"card": card, "songs": args.songs, "seconds": args.seconds,
                      "ways": {name: {"walls": w, "fleet_rtf": [audio / x for x in w]}
                               for name, w in walls.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
