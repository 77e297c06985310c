"""Offline WAV renderer CLI of the port (zang_tpu/host/render_wav.py).

    python -m zang_tpu_torch.host.render_wav <config> out.wav [--seconds S]
                                                              [--device cuda]
                                                              [--engine torch]
                                                              [--chunk N]
                                                              [--voices N]

Configs:
  song       full Bach Toccata & Fugue (48 kHz mono, 385 s by default)
  sampler    drum loop + distortion + decimator chain (44.1 kHz mono, 10 s)
  poly_echo  N-voice texture through stereo echoes (44.1 kHz stereo, 30 s,
             1024 voices by default; --voices 16384 --seconds 8 is the JAX
             package's capacity size and fits one 80 GB card)

All three mix down to s16 at volume 0.25. --device defaults to cuda and
raises when CUDA is absent; pass --device cpu for the plain torch path.

--engine torch (the default) renders through the port on --device;
--engine oracle renders the song through the port's reference oracle on the
host (zang_tpu_torch/oracle, the device contract's "parity" mode) and
oracle-exact through its "exact" mode (the reference's float accumulation);
--device and --chunk do not apply to them. As in the JAX package's CLI
(whose default engine is named tpu), the oracle engines take the song only.
"""

import argparse
import time

import numpy as np
import torch

from ..core.mixdown import mixdown_s16
from ..core.wav import write_wav_s16
from ..device import require_device
from ..graph.render import render_performance
from . import configs
from . import song as song_mod


def main(argv=None):
    ap = argparse.ArgumentParser(prog="zang-torch-render", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config", choices=["song", "sampler", "poly_echo"])
    ap.add_argument("output")
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--engine", choices=["torch", "oracle", "oracle-exact"],
                    default="torch")
    ap.add_argument("--chunk", type=int, default=65536)
    ap.add_argument("--voices", type=int, default=1024, help="poly_echo voice count")
    args = ap.parse_args(argv)
    if args.engine != "torch" and args.config != "song":
        ap.error(f"--engine {args.engine} only supported for config 'song'")

    t0 = time.perf_counter()
    plan = ""
    if args.config == "song":
        seconds = song_mod.NUM_SECONDS if args.seconds is None else args.seconds
        sr, vol = int(song_mod.SAMPLE_RATE), song_mod.MIX_VOLUME
        if args.engine == "torch":
            audio = song_mod.render_song(seconds, chunk_size=args.chunk,
                                         device=args.device)[None, :]
        else:
            mode = "parity" if args.engine == "oracle" else "exact"
            audio = torch.from_numpy(song_mod.render_song_oracle(seconds, mode)[None, :])
    else:
        seconds = configs.DEFAULT_SECONDS[args.config] if args.seconds is None \
            else args.seconds
        sr, vol = int(configs.SAMPLE_RATE), configs.MIX_VOLUME
        dev = require_device(args.device)  # before planning: fail fast
        perf, total = configs.build_config(args.config, seconds, args.voices)
        plan = f", planning {time.perf_counter() - t0:.2f}s of it"
        audio = render_performance(perf, total, chunk_size=args.chunk, device=dev)
    pcm = mixdown_s16(audio, vol).cpu().numpy()
    peak = float(audio.abs().max())
    if audio.is_cuda:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    channels = pcm.shape[0]
    write_wav_s16(args.output, pcm if channels > 1 else pcm[0], sr,
                  num_channels=channels)
    where = args.device if args.engine == "torch" else f"the host (engine={args.engine})"
    print(
        f"rendered {seconds:g}s at {sr}Hz ({channels} ch) on {where} in "
        f"{dt:.2f}s (RTF {seconds / dt:.1f}x incl. planning and kernel build{plan}), "
        f"peak {peak:.3f}, {np.count_nonzero(pcm)} nonzero samples -> {args.output}"
    )


if __name__ == "__main__":
    main()
