"""Offline WAV renderer CLI of the port (zang_tpu/host/render_wav.py).

    python -m zang_tpu_torch.host.render_wav song out.wav [--seconds S]
                                                          [--device cuda]
                                                          [--chunk N]

Configs:
  song       full Bach Toccata & Fugue (48 kHz mono, 385 s by default)

--device defaults to cuda and raises when CUDA is absent; pass
--device cpu for the plain torch path.
"""

import argparse
import time

import numpy as np
import torch

from zang_tpu.core.wav import write_wav_s16

from ..core.mixdown import mixdown_s16
from . import song as song_mod


def main(argv=None):
    ap = argparse.ArgumentParser(prog="zang-torch-render", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config", choices=["song"])
    ap.add_argument("output")
    ap.add_argument("--seconds", type=float, default=song_mod.NUM_SECONDS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--chunk", type=int, default=65536)
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    mix = song_mod.render_song(args.seconds, chunk_size=args.chunk, device=args.device)
    pcm = mixdown_s16(mix, song_mod.MIX_VOLUME).cpu().numpy()
    peak = float(mix.abs().max())
    if mix.is_cuda:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    sr = int(song_mod.SAMPLE_RATE)
    write_wav_s16(args.output, pcm, sr, num_channels=1)
    print(
        f"rendered {args.seconds:g}s at {sr}Hz on {args.device} in {dt:.2f}s "
        f"(RTF {args.seconds / dt:.1f}x incl. planning and kernel build), "
        f"peak {peak:.3f}, {np.count_nonzero(pcm)} nonzero samples -> {args.output}"
    )


if __name__ == "__main__":
    main()
