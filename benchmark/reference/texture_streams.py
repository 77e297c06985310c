"""The texture of voice streams, as the sharded cell renders it:
poly_echo's voices and post chain (reference/renders.py texture_oracle),
each voice's notes drawn from a stream of its own keyed by (seed, voice)
(zang_tpu_torch/host/configs.py texture_voice_song, frozen), so each worker
process draws only the voices it paints.

texture_streams_oracle: the first `frames` through the oracle (parity
mode), s16 [2, frames]. The voices split into `workers` contiguous groups;
each worker sums its voices in order (renders.texture_voice_mix), the
partial mixes are added in worker order, scaled by 1/V and put through
StereoEchoes. precision="bf16" is the benchmark's control, as in
renders.py.

Imports numpy and this package only: nothing of the port, nothing of JAX.
"""

from typing import List

import numpy as np

from . import engine as oe
from . import instruments as oi
from .mixdown import mixdown_s16_np
from .notes import SongEvent
from .renders import BLOCK, _check, bf16, texture_voice_mix

F32 = np.float32


def voice_song(seconds: float, seed: int, voice: int) -> List[SongEvent]:
    """One voice's events: a start in [0, 0.1) s, then a note of 0.22 s
    every 0.25 s at one of 37 semitones from 110 Hz, up to 0.3 s before the
    end, drawn from default_rng([seed, voice])."""
    rng = np.random.default_rng([seed, voice])
    song = []
    t = rng.uniform(0.0, 0.1)
    nid = 1
    while t < seconds - 0.3:
        f = float(F32(110.0 * 2 ** (rng.integers(0, 37) / 12.0)))
        song.append(SongEvent({"freq": f, "note_on": True}, t=t, note_id=nid))
        song.append(SongEvent({"freq": f, "note_on": False}, t=t + 0.22, note_id=nid))
        nid += 1
        t += 0.25
    return song


def voices_mix(args) -> np.ndarray:
    """A worker's share: the unscaled sum of the voices [lo, hi) over
    [0, frames), f32, drawn here alone."""
    seconds, seed, lo, hi, frames, sample_rate, precision = args
    songs = [voice_song(seconds, seed, v) for v in range(lo, hi)]
    return texture_voice_mix(songs, frames, sample_rate, precision)


def split(num_voices: int, workers: int) -> list:
    """[(lo, hi)] of `workers` contiguous groups of the voices."""
    workers = max(1, min(workers, num_voices))
    bounds = [round(num_voices * w / workers) for w in range(workers + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


def texture_streams_mix(num_voices: int, seconds: float, seed: int, frames: int,
                        sample_rate: float = 44100.0, precision: str = "f32",
                        workers: int = 1) -> np.ndarray:
    """The unscaled voice mix [frames] f32: the workers' partial mixes,
    each rendered in a spawned process when workers > 1, added in worker
    order."""
    _check(precision)
    jobs = [(seconds, seed, lo, hi, frames, sample_rate, precision)
            for lo, hi in split(num_voices, workers)]
    if len(jobs) == 1:
        partials = [voices_mix(jobs[0])]
    else:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        # spawned: the workers import numpy and this package, never the
        # program; a worker that dies raises here instead of hanging
        with ProcessPoolExecutor(len(jobs), mp_context=mp.get_context("spawn")) as pool:
            partials = list(pool.map(voices_mix, jobs))
    mix = partials[0]
    for p in partials[1:]:
        mix = mix + p
    return mix


def echoes_s16(mix: np.ndarray, num_voices: int, frames: int, sample_rate: float,
               main_delay: int, volume: float, precision: str = "f32") -> np.ndarray:
    """The mix scaled by 1/num_voices into StereoEchoes(main_delay), mixed
    down: renders.texture_oracle's post chain."""
    echo = oi.StereoEchoes(main_delay, mode="parity")
    scale = F32(1.0 / max(num_voices, 1))
    mixbuf = np.zeros(BLOCK, F32)
    c0 = 0

    def paint(span, outputs, temps):
        nonlocal c0
        n = span.end - span.start
        mixbuf[:n] = mix[c0:c0 + n]
        mixbuf[:n] *= scale
        if precision == "bf16":
            mixbuf[:n] = bf16(mixbuf[:n])
        echo.paint(span, outputs, temps, False, {
            "input": mixbuf, "feedback_volume": 0.6, "cutoff": 0.7})
        if precision == "bf16":
            for o in outputs:
                o[:n] = bf16(o[:n])
        c0 += n

    out = oe.render_blocks(paint, frames, num_outputs=2, num_temps=4)
    return mixdown_s16_np(out, volume)


def texture_streams_oracle(num_voices: int, seconds: float, seed: int, frames: int,
                           sample_rate: float = 44100.0, main_delay: int = 15000,
                           volume: float = 0.25, precision: str = "f32",
                           workers: int = 1) -> np.ndarray:
    """The texture's first `frames` through the oracle, s16 [2, frames]."""
    mix = texture_streams_mix(num_voices, seconds, seed, frames, sample_rate, precision,
                              workers)
    return echoes_s16(mix, num_voices, frames, sample_rate, main_delay, volume, precision)
